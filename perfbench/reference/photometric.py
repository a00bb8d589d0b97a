"""FlowNet's photometric jitter, as the reference computes it (a frozen copy
of the plain version in the port's ``ops/photometric.py``): per sample a
colour, gamma, brightness and contrast map shared by both frames, then
per-frame Gaussian noise, every draw from ``fold_in(sample_key(root, i),
AUX_PHOTOMETRIC)`` for global sample index ``i``, in XLA:CPU's float32
arithmetic (``fp``).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from . import fp as _fp
from . import streams

# Fold-in id of the photometric key chain; not a ``Stream`` member (adding
# one would change the bits-table stride and every scene).
AUX_PHOTOMETRIC = 101


class PhotoParams(NamedTuple):
    """Jitter ranges, FlowNet's training defaults (Dosovitskiy et al. 2015)."""

    color_range: Tuple[float, float] = (0.5, 2.0)      # per-channel multiplier
    gamma_range: Tuple[float, float] = (0.7, 1.5)
    brightness_sigma: float = 0.2                      # additive, [0,1] scale
    contrast_range: Tuple[float, float] = (-0.8, 0.4)  # factor = 1 + c
    noise_sigma_range: Tuple[float, float] = (0.0, 0.04)  # per-frame


_INV255 = _fp.f32(np.float32(1.0) / np.float32(255.0))
_GAMMA_FLOOR = _fp.f32(1e-6)


def _bright_scale(params: PhotoParams):
    """``brightness_sigma * sqrt(2)``, folded in float32 as XLA folds the
    constants of ``brightness_sigma * normal``."""
    return _fp.f32(np.float32(params.brightness_sigma) * streams.SQRT2)


def photo_keys(root, indices):
    """The 7 keys of each sample's draws, (B, 7, 2): ``split(fold_in(
    sample_key(root, i), AUX_PHOTOMETRIC), 7)`` = colour, gamma,
    brightness, contrast, noise sigma, frame-0 noise, frame-1 noise."""
    k = streams.fold_in(streams.sample_key(root, indices), AUX_PHOTOMETRIC)
    return streams.split(k, 7)


def shared_draws(keys7, params: PhotoParams = PhotoParams()):
    """Per-sample scalars of the shared map and the noise scale from keys
    (B, 7, 2): colour / 255 (B, 3), gamma, brightness, contrast and noise
    sigma times sqrt(2) (B,) each, as XLA computes them."""
    def u(j, rng, shape=()):
        return streams.uniform(keys7[:, j], rng[0], rng[1], shape)

    color = u(0, params.color_range, (3,)) * _INV255
    gamma = u(1, params.gamma_range)
    bright = _fp.erf_inv(u(2, (streams.NORMAL_LO, 1.0))) * _bright_scale(
        params)
    contrast = u(3, params.contrast_range) + 1.0
    sigma = u(4, params.noise_sigma_range) * streams.SQRT2
    return color, gamma, bright, contrast, sigma


def _shared_map(x, color, gamma, bright, contrast):
    """The map both frames of a sample share, on (B, ..., 3) values: colour,
    gamma, brightness and contrast, from :func:`shared_draws`."""
    view = (-1,) + (1,) * (x.dim() - 1)
    x = torch.clamp(x * color.reshape(color.shape[:1] + (1,) * (x.dim() - 2)
                                      + (3,)), min=_GAMMA_FLOOR)
    x = _fp.pow(x, gamma.reshape(view))
    x = (x + bright.reshape(view)) + -0.5
    return _fp.fma(x, contrast.reshape(view), 0.5)


def _augment(keys7, images0, images1, params):
    color, gamma, bright, contrast, sigma = shared_draws(keys7, params)
    shape = tuple(images0.shape[1:])
    view = (-1,) + (1,) * len(shape)
    outs = []
    for f, x in ((5, images0), (6, images1)):
        x = _shared_map(x, color, gamma, bright, contrast)
        noise = _fp.erf_inv(streams.uniform(
            keys7[:, f], streams.NORMAL_LO, 1.0, shape))
        x = _fp.fma(noise, sigma.reshape(view), x)
        outs.append(torch.clamp(x, 0.0, 1.0) * 255.0)
    return tuple(outs)


def augment_batch(root, indices, images0, images1,
                  params: PhotoParams = PhotoParams()):
    """Jitter a batch of pairs (B, H, W, 3) float32 in [0, 255], keyed per
    global sample index ``indices`` (B,) under the root key ``root`` (2,)."""
    return _augment(photo_keys(root, indices), images0, images1, params)
