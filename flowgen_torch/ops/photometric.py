"""Photometric augmentation: FlowNet's per-image colour, gamma, brightness,
contrast and additive Gaussian noise (port of ``flowgen/ops/photometric.py``).

The colour / gamma / brightness / contrast map is drawn once per sample and
applied to both frames, so the flow stays valid; the sensor noise is drawn
per frame. Randomness derives from ``fold_in(sample_key(root, i),
AUX_PHOTOMETRIC)`` for global sample index ``i``, an id outside the
``random.streams.Stream`` bits-table layout, so turning the stage on
reshuffles no scene content.

``augment_batch`` launches the hand-written CUDA kernels
(``csrc/photometric.cu``: a table of the shared map per sample, then the
values) for CUDA tensors and runs
:func:`augment_batch_plain` for CPU tensors. In the JAX package the stage is
XLA, fused into one elementwise loop; the kernel is that loop. Both follow
XLA:CPU's arithmetic: its float32 ``erf_inv``, ``log1p`` and ``pow``
(``_fp``), its constant folding (``x / 255`` as a product with the rounded
reciprocal, ``0.2 * (sqrt(2) * n)`` and ``s * (sqrt(2) * n)`` with the
constants multiplied first) and its FMA contractions (the uniform draws'
scale-and-shift, the contrast map and the noise add).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Tuple

import numpy as np
import torch

from .. import _fp
from ..random import streams
from ..utils.profiling import span

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


# Words of the kernel's per-sample record (csrc/photometric.cu:kRecord):
# the map's 3 x 256 table, then the draws.
RECORD_WORDS = 784

_INV255 = _fp.f32(np.float32(1.0) / np.float32(255.0))
_GAMMA_FLOOR = _fp.f32(1e-6)


def _lo_span(rng):
    lo = np.float32(rng[0])
    return float(lo), float(np.float32(np.float32(rng[1]) - lo))


def _bright_scale(params: PhotoParams):
    """``brightness_sigma * sqrt(2)``, folded in float32 as XLA folds the
    constants of ``brightness_sigma * normal``."""
    return _fp.f32(np.float32(params.brightness_sigma) * streams.SQRT2)


def kernel_constants(params: PhotoParams = PhotoParams()):
    """The float32 constants the kernel takes: (lo, span) of the colour,
    gamma, contrast and noise-sigma draws, and :func:`_bright_scale`. A
    tuple of 9 Python floats."""
    out = []
    for rng in (params.color_range, params.gamma_range,
                params.contrast_range, params.noise_sigma_range):
        out += _lo_span(rng)
    out.append(_bright_scale(params))
    return tuple(out)


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


def augment_pair(key, img0, img1, params: PhotoParams = PhotoParams()):
    """Jitter one (H, W, 3) 0..255 float32 image pair under ``key`` (2,).
    Returns the augmented pair."""
    o0, o1 = _augment(streams.split(key, 7)[None], img0[None], img1[None],
                      params)
    return o0[0], o1[0]


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


def map_table(root, indices, params: PhotoParams = PhotoParams()):
    """The shared map of each sample at the 256 whole levels of each
    channel, (B, 3, 256) float32: the plain version of the kernel's table
    pass. A frame value that is a whole level L in [0, 255] maps to
    ``table[b, c, L]`` bit for bit."""
    color, gamma, bright, contrast, _ = shared_draws(
        photo_keys(root, indices), params)
    levels = torch.arange(256, dtype=torch.float32, device=color.device)
    x = levels[None, :, None].expand(color.shape[0], 256, 3)
    return _shared_map(x, color, gamma, bright, contrast).transpose(1, 2)


def augment_batch_plain(root, indices, images0, images1,
                        params: PhotoParams = PhotoParams()):
    """The plain PyTorch version of :func:`augment_batch`."""
    return _augment(photo_keys(root, indices), images0, images1, params)


def augment_batch(root, indices, images0, images1,
                  params: PhotoParams = PhotoParams()):
    """Jitter a batch of pairs, (B, H, W, 3) float32 in [0, 255] each,
    keyed per global sample index ``indices`` (B,) under the root key
    ``root`` (2,). Out of place: returns two new tensors.

    CUDA tensors launch the photometric kernels (the table pass and the
    value pass, one call counted once in ``augment_batch.launches``); CPU
    tensors run :func:`augment_batch_plain`."""
    with span("flowgen.photometric"):
        if images0.device.type == "cpu":
            return augment_batch_plain(root, indices, images0, images1,
                                       params)
        if images0.device.type != "cuda":
            raise ValueError(
                f"augment_batch: unsupported device {images0.device}")
        return _augment_cuda(root, indices, images0, images1, params)


augment_batch.launches = 0


def _augment_cuda(root, indices, images0, images1, params):
    from ._build import load_photometric_library

    dev = images0.device
    B = images0.shape[0]
    if images0.dim() != 4 or images0.shape[-1] != 3:
        raise ValueError("augment_batch: images must be (B, H, W, 3)")
    n = images0[0].numel()
    if n >= 2**31:
        raise ValueError("augment_batch: a frame of 2**31 values or more")
    for name, t, dt, shape in (
            ("root", root, torch.int64, (2,)),
            ("indices", indices, torch.int64, (B,)),
            ("images0", images0, torch.float32, tuple(images0.shape)),
            ("images1", images1, torch.float32, tuple(images0.shape))):
        if t.device != dev or t.dtype != dt or tuple(t.shape) != shape:
            raise ValueError(f"augment_batch: {name} must be {dt} {shape} "
                             f"on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"augment_batch: {name} must be contiguous")
    out0 = torch.empty_like(images0)
    out1 = torch.empty_like(images1)
    records = torch.empty((B, RECORD_WORDS), dtype=torch.float32, device=dev)
    lib = load_photometric_library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())
    consts = [ctypes.c_float(c) for c in kernel_constants(params)]
    err = lib.flowgen_photometric(
        ptr(root), ptr(indices), ptr(images0), ptr(images1), ptr(out0),
        ptr(out1), ptr(records), B, n, *consts, ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"photometric kernel launch failed: CUDA error "
                           f"{err}")
    augment_batch.launches += 1
    return out0, out1
