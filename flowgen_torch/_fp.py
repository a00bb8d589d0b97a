"""Float32 helpers that keep the port's arithmetic identical to the JAX
package's.

PyTorch evaluates ``scalar / tensor`` as ``reciprocal(tensor) * scalar`` on
every device, and ``tensor / scalar`` as a product with the reciprocal on
CUDA; both differ from a true division in the last bit. XLA divides. So every
division in the port goes through :func:`div`, which always divides two
tensors of the same device.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def f32(x) -> float:
    """A Python float rounded to float32, as JAX rounds a weakly typed
    constant before it meets a float32 array (comparisons included)."""
    return float(np.float32(x))


def div(a, b):
    """IEEE float32 ``a / b`` where either side may be a Python scalar."""
    if not torch.is_tensor(a):
        a = torch.full_like(b, a)
    elif not torch.is_tensor(b):
        b = torch.full_like(a, b)
    return torch.div(a, b)


def sqrt(x):
    """Correctly rounded float32 square root on any device: taken in float64
    and rounded once (exact, as float64 carries more than twice the bits)."""
    return torch.sqrt(x.double()).to(x.dtype)


# XLA:CPU's float32 transcendentals are not correctly rounded: ``sin`` and
# ``cos`` call the host C library's ``sinf`` / ``cosf`` (glibc: evaluated in
# double precision on a quarter-period reduction), and ``log`` is the Cephes
# polynomial that XLA emits inline, with LLVM's FMA contractions. The three
# functions below restate them as tensor code, so the port's sampler takes
# the JAX package's bits on every device. A float32 FMA is emulated in
# float64: the product is exact there, and the sum is rounded twice.

_HPI_INV = float.fromhex("0x1.45f306dc9c883p+23")   # 2/pi * 2^24
_HPI = float.fromhex("0x1.921fb54442d18p0")          # pi/2
_PIO4 = float.fromhex("0x1.921fb6p-1")
_SIN = tuple(float.fromhex(h) for h in (
    "-0x1.555545995a603p-3", "0x1.1107605230bc4p-7", "-0x1.994eb3774cf24p-13"))
_COS = tuple(float.fromhex(h) for h in (
    "0x1p0", "-0x1.ffffffd0c621cp-2", "0x1.55553e1068f19p-5",
    "-0x1.6c087e89a359dp-10", "0x1.99343027bf8c3p-16"))


def _sincos_poly(x, x2, n):
    """glibc's ``sinf_poly`` in float64: the sine polynomial where ``n`` is
    even, the cosine one (negated for ``n & 2``) where it is odd."""
    s1, s2, s3 = _SIN
    x3 = x * x2
    s = (x + x3 * s1) + (x3 * x2) * (s2 + x2 * s3)
    c0, c1, c2, c3, c4 = _COS
    x4 = x2 * x2
    c = ((c0 + x2 * c1) + x4 * c2) + (x4 * x2) * (c3 + x2 * c4)
    c = torch.where((n & 2) != 0, -c, c)
    return torch.where((n & 1) == 0, s, c)


def _sincos(y, cosine: bool):
    torch._assert_async((y.abs() < 120.0).all(),
                        "_fp.sin/cos: |x| >= 120 is outside the ported range")
    x = y.double()
    small = y.abs() < _PIO4
    n = ((x * _HPI_INV).to(torch.int64) + 0x800000) >> 24
    n = torch.where(small, torch.zeros_like(n), n)
    r = x - n.double() * _HPI
    sign = torch.where(((n + 1) & 2) != 0, -1.0, 1.0).double()
    out = _sincos_poly(r * sign, r * r, n ^ 1 if cosine else n)
    tiny = torch.ones_like(x) if cosine else x
    out = torch.where(y.abs() < float.fromhex("0x1p-12"), tiny, out)
    return out.to(y.dtype)


def sin(x):
    """XLA:CPU's float32 ``sin`` (glibc ``sinf``) for |x| < 120."""
    return _sincos(x, cosine=False)


def cos(x):
    """XLA:CPU's float32 ``cos`` (glibc ``cosf``) for |x| < 120."""
    return _sincos(x, cosine=True)


_LOG_P = tuple(f32(p) for p in (
    7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1, -1.2420140846e-1,
    1.4249322787e-1, -1.6668057665e-1, 2.0000714765e-1, -2.4999993993e-1,
    3.3333331174e-1))


def _fma(a, b, c):
    """float32 ``a * b + c`` with one rounding of the product (float64)."""
    if not torch.is_tensor(a):
        a = torch.full_like(b, a)
    if not torch.is_tensor(c):
        c = torch.full_like(b, c)
    return (a.double() * b.double() + c.double()).to(torch.float32)


def log(x):
    """XLA:CPU's float32 ``log``: the Cephes polynomial on the mantissa
    folded into [sqrt(1/2), sqrt(2)), with LLVM's contractions."""
    p = _LOG_P
    xc = torch.clamp(x, min=float.fromhex("0x1p-126"))
    m, e = torch.frexp(xc)
    e = e.to(torch.float32)
    fold = m < f32(0.707106781186547524)
    z = torch.where(fold, (m - 1.0) + m, m - 1.0)
    e = torch.where(fold, e - 1.0, e)
    z2 = z * z
    z3 = z2 * z
    y = _fma(_fma(p[0], z, p[1]), z, p[2])
    y1 = _fma(_fma(p[3], z, p[4]), z, p[5])
    y2 = _fma(_fma(p[6], z, p[7]), z, p[8])
    y = _fma(_fma(y, z3, y1), z3, y2)
    y = _fma(y, z3, e * f32(-2.12194440e-4))
    out = _fma(f32(0.693359375), e, (z - z2 * 0.5) + y)
    out = torch.where(x == 0, torch.full_like(out, -math.inf), out)
    out = torch.where(x < 0, torch.full_like(out, math.nan), out)
    return torch.where(x == math.inf, x, out)


def mod(a, b):
    """``jnp.mod`` for floats: the sign of the divisor, built on ``fmod``
    (``torch.remainder`` computes ``a - b * floor(a / b)`` instead)."""
    if not torch.is_tensor(b):
        b = torch.full_like(a, b)
    r = torch.fmod(a, b)
    fix = (r != 0) & ((r < 0) != (b < 0))
    return torch.where(fix, r + b, r)
