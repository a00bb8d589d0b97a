"""Deterministic elementary functions for the warp-field bank (port of
``flowgen/ops/detmath.py``).

The mode-9 bank's 17 self-composition doublings are chaotic: a 1-ulp
difference in the elementary field grows into pixels. So the bank is built
only from operations that are exactly rounded on every device (float32 add,
subtract, multiply, floor, min/max, select, integer ops and bit casts), in the
JAX package's order of operations, and its results are the same bit for bit
on the CPU, on the card and in the JAX package.

``fma_barrier`` is the identity here. In eager PyTorch every operation is its
own kernel, so ``a * b`` and the ``+ c`` that follows are two roundings and
are never contracted into one fused multiply-add. For the same reason the
bank path never uses ``torch.lerp``, ``torch.addcmul`` or
``torch.exp/sin/cos``: they fuse or round differently. The CUDA kernels of
the bank are compiled with ``-fmad=false`` for the same contract.
"""

from __future__ import annotations

import torch

from .._fp import f32

_LOG2E = 1.44269504088896341
_LN2_HI = 0.693359375
_LN2_LO = -2.12194440e-4
_EXP_C = (
    1.9875691500e-4,
    1.3981999507e-3,
    8.3334519073e-3,
    4.1665795894e-2,
    1.6666665459e-1,
    5.0000001201e-1,
)
_DP1 = 1.5703125
_DP2 = 4.837512969970703125e-4
_DP3 = 7.549789948768648e-8
_SIN_C = (-1.9515295891e-4, 8.3321608736e-3, -1.6666654611e-1)
_COS_C = (2.443315711809948e-5, -1.388731625493765e-3, 4.166664568298827e-2)
_TWO_OVER_PI = 2.0 / 3.141592653589793


def fma_barrier(prod, src=None):
    """Identity: eager PyTorch never contracts a product into the next add
    (see the module docstring)."""
    del src
    return prod


def _t(x):
    return x if torch.is_tensor(x) else torch.tensor(x, dtype=torch.float32)


def det_lerp(p0, p1, t):
    """``p0 + (p1 - p0) * t`` with the product rounded on its own."""
    return p0 + (p1 - p0) * t


def det_recip(y):
    """1/y for normal, nonzero y: a bit-trick seed and three Newton steps."""
    y = _t(y)
    a = torch.abs(y)
    seed = (0x7EF311C3 - a.view(torch.int32)).view(torch.float32)
    r = seed
    for _ in range(3):
        r = r * (2.0 - a * r)
    return torch.where(y < 0, -r, r)


def det_div(x, y):
    """x/y through the deterministic reciprocal."""
    return _t(x) * det_recip(y)


def det_exp(x):
    """exp(x) for x <= 0, clamped at exp(-87)."""
    x = torch.clamp(_t(x), min=f32(-87.0))
    k = torch.floor(x * _LOG2E + 0.5)
    r = (x - k * _LN2_HI) - k * _LN2_LO
    p = torch.full_like(r, f32(_EXP_C[0]))
    for c in _EXP_C[1:]:
        p = p * r + c
    e = (p * (r * r) + r) + 1.0
    scale = ((k.to(torch.int32) + 127) << 23).view(torch.float32)
    return e * scale


def _reduce_quadrant(x):
    x = _t(x)
    j = torch.floor(x * _TWO_OVER_PI + 0.5)
    r = ((x - j * _DP1) - j * _DP2) - j * _DP3
    m = j.to(torch.int32) & 3
    return m, r


def _sin_poly(r):
    r2 = r * r
    p = torch.full_like(r, f32(_SIN_C[0]))
    for c in _SIN_C[1:]:
        p = p * r2 + c
    return (p * r2) * r + r


def _cos_poly(r):
    r2 = r * r
    p = torch.full_like(r, f32(_COS_C[0]))
    for c in _COS_C[1:]:
        p = p * r2 + c
    return (p * (r2 * r2) - 0.5 * r2) + 1.0


def det_sin(x):
    """sin(x) for |x| <= 4."""
    m, r = _reduce_quadrant(x)
    s, c = _sin_poly(r), _cos_poly(r)
    v = torch.where(m % 2 == 0, s, c)
    return torch.where(m >= 2, -v, v)


def det_cos(x):
    """cos(x) for |x| <= 4."""
    m, r = _reduce_quadrant(x)
    s, c = _sin_poly(r), _cos_poly(r)
    v = torch.where(m % 2 == 0, c, -s)
    return torch.where(m >= 2, -v, v)
