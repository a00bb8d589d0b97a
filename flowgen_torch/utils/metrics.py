"""Flow evaluation metrics.

The rebuild's quality metric (BASELINE.md) is endpoint error against a
reference rendering; these helpers compute it between any two flow fields
(e.g. TPU renderer vs the scalar oracle in flowgen/reference_check, or a
trained model's predictions vs ground truth).

Each function also takes torch tensors (any device), converted to numpy at
entry, and returns what it returns for numpy arrays."""

from __future__ import annotations

import numpy as np
import torch


def _np(x):
    if torch.is_tensor(x):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def epe(flow_a, flow_b, mask=None):
    """Mean endpoint error |a - b|_2 per pixel. ``mask``: optional bool array
    restricting the average (e.g. non-occluded pixels)."""
    flow_a = _np(flow_a)
    flow_b = _np(flow_b)
    err = np.sqrt(((flow_a - flow_b) ** 2).sum(-1))
    if mask is not None:
        err = err[_np(mask)]
    return float(err.mean())


def epe_stats(flow_a, flow_b):
    """EPE summary: mean / median / p95 / fraction > 1px / fraction > 3px."""
    err = np.sqrt(((_np(flow_a) - _np(flow_b)) ** 2).sum(-1)).ravel()
    return {
        "mean": float(err.mean()),
        "median": float(np.median(err)),
        "p95": float(np.percentile(err, 95)),
        "frac_gt_1px": float((err > 1.0).mean()),
        "frac_gt_3px": float((err > 3.0).mean()),
    }


def flow_magnitude_histogram(flow, bins=50, max_mag=None):
    """Displacement-magnitude histogram — the FlyingChairs-matching statistic
    the reference's Gaussian^k shapers exist to produce (SURVEY.md §2 #12)."""
    mag = np.sqrt((_np(flow) ** 2).sum(-1)).ravel()
    if max_mag is None:
        max_mag = float(mag.max()) + 1e-6
    hist, edges = np.histogram(mag, bins=bins, range=(0.0, max_mag))
    return hist / hist.sum(), edges
