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


_CONSTS: dict = {}


def const(key, device, make):
    """The tensor that ``make()`` builds from host data, moved to ``device``
    once per ``(key, device)`` and kept: later calls return the same tensor,
    so a function that needs a constant makes no host-to-device copy (each
    of which waits for the device) after its first call, and can be
    captured in a CUDA graph. Callers only read it."""
    k = (key, torch.device(device))
    t = _CONSTS.get(k)
    if t is None:
        t = _CONSTS[k] = make().to(device)
    return t


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
# float64 (:func:`_fma`, :func:`fma`).

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
    """float32 ``a * b + c`` with one rounding of the product (float64),
    the sum rounded twice (float64, then float32): away from a true FMA
    about once in 2^29, and four operations cheaper than :func:`fma`. The
    sampler's ``log`` takes it."""
    if not torch.is_tensor(a):
        a = torch.full_like(b, a)
    if not torch.is_tensor(c):
        c = torch.full_like(b, c)
    return (a.double() * b.double() + c.double()).to(torch.float32)


def fma(a, b, c):
    """float32 ``fma(a, b, c)``: ``a * b + c`` rounded once, as the card's
    ``__fmaf_rn``. The product is exact in float64; the sum is taken there
    with its rounding error (Knuth's two-sum) and rounded to odd, which
    makes the final rounding to float32 the correct one (53 >= 24 + 2
    bits)."""
    if not torch.is_tensor(a):
        a = torch.full_like(b, a)
    if not torch.is_tensor(c):
        c = torch.full_like(b, c)
    p = a.double() * b.double()
    c = c.double()
    s = p + c
    bb = s - p
    t = (p - (s - bb)) + (c - bb)
    bits = s.view(torch.int64)
    step = torch.where((t > 0) == (s > 0), 1, -1)
    odd = torch.where((t != 0) & ((bits & 1) == 0), bits + step, bits)
    return odd.view(torch.float64).to(torch.float32)


def log(x, exact: bool = False):
    """XLA:CPU's float32 ``log``: the Cephes polynomial on the mantissa
    folded into [sqrt(1/2), sqrt(2)), with LLVM's contractions; ``exact``
    takes them as true FMAs (:func:`fma`), else as :func:`_fma`."""
    mac = fma if exact else _fma
    p = _LOG_P
    xc = torch.clamp(x, min=float.fromhex("0x1p-126"))
    m, e = torch.frexp(xc)
    e = e.to(torch.float32)
    fold = m < f32(0.707106781186547524)
    z = torch.where(fold, (m - 1.0) + m, m - 1.0)
    e = torch.where(fold, e - 1.0, e)
    z2 = z * z
    z3 = z2 * z
    y = mac(mac(p[0], z, p[1]), z, p[2])
    y1 = mac(mac(p[3], z, p[4]), z, p[5])
    y2 = mac(mac(p[6], z, p[7]), z, p[8])
    y = mac(mac(y, z3, y1), z3, y2)
    y = mac(y, z3, e * f32(-2.12194440e-4))
    out = mac(f32(0.693359375), e, (z - z2 * 0.5) + y)
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


# ``log1p`` is XLA's elemental emitter: below sqrt(2) - 1 in magnitude the
# Cephes rational approximation (both polynomials by Horner, each step
# contracted into an FMA), elsewhere ``log(1 + x)``. It, ``erf_inv`` and
# the ``log`` inside them take true FMAs (:func:`fma`), as the card's
# photometric kernel does.
_LOG1P_NUM = tuple(f32(c) for c in (
    4.5270000862445199635215e-5, 4.9854102823193375972212e-1,
    6.5787325942061044846969e0, 2.9911919328553073277375e1,
    6.0949667980987787057556e1, 5.7112963590585538103336e1,
    2.0039553499201281259648e1))
_LOG1P_DEN = tuple(f32(c) for c in (
    1.0, 1.5062909083469192043167e1, 8.3047565967967209469434e1,
    2.2176239823732856465394e2, 3.0909872225312059774938e2,
    2.1642788614495947685003e2, 6.0118660497603843919306e1))


def _horner(x, coeffs):
    p = torch.zeros_like(x)
    for c in coeffs:
        p = fma(p, x, c)
    return p


def log1p(x):
    """XLA:CPU's float32 ``log1p`` (``x > -1``)."""
    x2 = x * x
    small = div(_horner(x, _LOG1P_NUM), _horner(x, _LOG1P_DEN))
    small = x + (x * x2 * small + x2 * -0.5)
    return torch.where(x.abs() < f32(0.41421356237309504880), small,
                       log(x + 1.0, exact=True))


# ``erf_inv`` is CHLO's float32 expansion (Giles' single-precision
# polynomials in w = -log1p(-x^2), split at w = 5), its Horner steps
# contracted into FMAs.
_ERFINV_LO = tuple(f32(c) for c in (
    2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
    0.00021858087, -0.00125372503, -0.00417768164, 0.246640727,
    1.50140941))
_ERFINV_HI = tuple(f32(c) for c in (
    -0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
    0.00573950773, -0.0076224613, 0.00943887047, 1.00167406,
    2.83297682))


def erf_inv(x):
    """XLA:CPU's float32 ``erf_inv`` on [-1, 1]."""
    w = -log1p(x * -x)
    lo = w < 5.0
    t = torch.where(lo, w - 2.5, sqrt(w) - 3.0)
    p = torch.full_like(x, _ERFINV_LO[0])
    p = torch.where(lo, p, torch.full_like(x, _ERFINV_HI[0]))
    for a, b in zip(_ERFINV_LO[1:], _ERFINV_HI[1:]):
        p = fma(p, t, torch.where(lo, a, b))
    return torch.where(x.abs() == 1.0, x * math.inf, p * x)


# ``pow`` is the host C library's ``powf`` (glibc 2.28 and later, from Arm's
# optimized routines): log2(x) from a 16-entry table and a degree-5
# polynomial, 2^(y log2 x) from a 32-entry table and a cubic, all in
# float64, rounded once to float32. Tables are glibc's own
# (``__powf_log2_data``, ``__exp2f_data``).
_POW_LOG2_TAB = tuple((float.fromhex(a), float.fromhex(b)) for a, b in (
    ("0x1.661ec79f8f3bep+0", "-0x1.efec65b963019p-2"),
    ("0x1.571ed4aaf883dp+0", "-0x1.b0b6832d4fca4p-2"),
    ("0x1.49539f0f010b0p+0", "-0x1.7418b0a1fb77bp-2"),
    ("0x1.3c995b0b80385p+0", "-0x1.39de91a6dcf7bp-2"),
    ("0x1.30d190c8864a5p+0", "-0x1.01d9bf3f2b631p-2"),
    ("0x1.25e227b0b8ea0p+0", "-0x1.97c1d1b3b7af0p-3"),
    ("0x1.1bb4a4a1a343fp+0", "-0x1.2f9e393af3c9fp-3"),
    ("0x1.12358f08ae5bap+0", "-0x1.960cbbf788d5cp-4"),
    ("0x1.0953f419900a7p+0", "-0x1.a6f9db6475fcep-5"),
    ("0x1.0000000000000p+0", "0x0.0p+0"),
    ("0x1.e608cfd9a47acp-1", "0x1.338ca9f24f53dp-4"),
    ("0x1.ca4b31f026aa0p-1", "0x1.476a9543891bap-3"),
    ("0x1.b2036576afce6p-1", "0x1.e840b4ac4e4d2p-3"),
    ("0x1.9c2d163a1aa2dp-1", "0x1.40645f0c6651cp-2"),
    ("0x1.886e6037841edp-1", "0x1.88e9c2c1b9ff8p-2"),
    ("0x1.767dcf5534862p-1", "0x1.ce0a44eb17bccp-2")))
_POW_LOG2_POLY = tuple(float.fromhex(h) for h in (
    "0x1.27616c9496e0bp-2", "-0x1.71969a075c67ap-2", "0x1.ec70a6ca7baddp-2",
    "-0x1.7154748bef6c8p-1", "0x1.71547652ab82bp+0"))
_POW_EXP2_TAB = (
    0x3ff0000000000000, 0x3fefd9b0d3158574, 0x3fefb5586cf9890f,
    0x3fef9301d0125b51, 0x3fef72b83c7d517b, 0x3fef54873168b9aa,
    0x3fef387a6e756238, 0x3fef1e9df51fdee1, 0x3fef06fe0a31b715,
    0x3feef1a7373aa9cb, 0x3feedea64c123422, 0x3feece086061892d,
    0x3feebfdad5362a27, 0x3feeb42b569d4f82, 0x3feeab07dd485429,
    0x3feea47eb03a5585, 0x3feea09e667f3bcd, 0x3fee9f75e8ec5f74,
    0x3feea11473eb0187, 0x3feea589994cce13, 0x3feeace5422aa0db,
    0x3feeb737b0cdc5e5, 0x3feec49182a3f090, 0x3feed503b23e255d,
    0x3feee89f995ad3ad, 0x3feeff76f2fb5e47, 0x3fef199bdd85529c,
    0x3fef3720dcef9069, 0x3fef5818dcfba487, 0x3fef7c97337b9b5f,
    0x3fefa4afa2a490da, 0x3fefd0765b6e4540)
_POW_EXP2_SHIFT = float.fromhex("0x1.8p+47")
_POW_EXP2_POLY = tuple(float.fromhex(h) for h in (
    "0x1.c6af84b912394p-5", "0x1.ebfce50fac4f3p-3", "0x1.62e42ff0c52d6p-1"))


def pow(x, y):
    """XLA:CPU's float32 ``pow`` (glibc ``powf``) for positive normal
    ``x`` and finite ``y`` with |y log2 x| < 126 (no overflow, underflow or
    special case), ``y`` a tensor or a Python float."""
    torch._assert_async(((x >= f32(2.0 ** -126)) & (x < math.inf)).all(),
                        "_fp.pow: x outside the ported range")
    dev = x.device
    ix = x.view(torch.int32).to(torch.int64)
    tmp = ix - 0x3F330000
    i = (tmp >> 19) & 15
    top = tmp & 0xFF800000
    z = ((ix - top) & 0xFFFFFFFF).to(torch.int32).view(torch.float32).double()
    k = (top - (top & 0x80000000) * 2) >> 23       # arithmetic shift of int32
    tab = const("pow_log2", dev,
                lambda: torch.tensor(_POW_LOG2_TAB, dtype=torch.float64))
    invc, logc = tab[i, 0], tab[i, 1]
    a = _POW_LOG2_POLY
    r = z * invc - 1.0
    y0 = logc + k.double()
    r2 = r * r
    q = a[0] * r + a[1]
    p = a[2] * r + a[3]
    r4 = r2 * r2
    q2 = a[4] * r + y0
    q2 = p * r2 + q2
    logx = q * r4 + q2
    yd = y.double() if torch.is_tensor(y) else float(f32(y))
    ylogx = yd * logx
    torch._assert_async((ylogx.abs() < 126.0).all(),
                        "_fp.pow: result outside the ported range")
    kd = (ylogx + _POW_EXP2_SHIFT) - _POW_EXP2_SHIFT
    r = ylogx - kd
    ki = (kd * 32.0).to(torch.int64)
    e2 = const("pow_exp2", dev,
               lambda: torch.tensor(_POW_EXP2_TAB, dtype=torch.int64))
    s = (e2[ki & 31] + ki * (1 << 47)).view(torch.float64)
    c = _POW_EXP2_POLY
    zz = c[0] * r + c[1]
    r2 = r * r
    yy = c[2] * r + 1.0
    yy = zz * r2 + yy
    return (yy * s).to(torch.float32)
