"""Counter-based random streams: threefry2x32 in PyTorch (a frozen copy of
the port's ``random/streams.py``, so that the reference derives every draw
from the seed itself). Every draw is a pure function of
``(root_seed, sample_index, stream, object, component)``; a sample's whole
randomness comes from ONE threefry call over its bits table, and call sites
read static slots of it. The slot layout (``_build_layout``) is part of the
seed contract.

The hash reproduces JAX 0.9.0's threefry2x32 with
``jax_threefry_partitionable=True`` (``jax/_src/prng.py``: ``threefry_seed``,
``_threefry_fold_in``, ``_threefry_random_bits_partitionable``) bit for bit.
PyTorch has no full uint32 arithmetic, so words are int64 tensors holding
values in [0, 2**32), masked after every add and shift.
"""

from __future__ import annotations

import enum

import numpy as np
import torch

from . import fp as _fp

_M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


class Stream(enum.IntEnum):
    """Named stream ids (values are part of the seed contract)."""

    # Background
    BG_TEX_ID = 0
    BG_INIT_ROT = 1
    BG_INIT_TRANS_X = 2
    BG_INIT_TRANS_Y = 3
    BG_ROT_TRIGGER = 4
    BG_ROT = 5
    BG_TRANS_X = 6
    BG_TRANS_Y = 7
    BG_SCALE_TRIGGER = 8
    BG_INIT_SCALE = 9
    BG_SCALE = 10
    # Foreground objects
    NUM_FG_OBJECTS = 11
    OBJ_TYPE = 12
    OBJ_TEX_ID = 13
    OBJ_INIT_TRANS_X = 14
    OBJ_INIT_TRANS_Y = 15
    OBJ_TRANS_X = 16
    OBJ_TRANS_Y = 17
    OBJ_INIT_ROT = 18
    OBJ_ROT_TRIGGER = 19
    OBJ_ROT = 20
    OBJ_INIT_SCALE = 21
    OBJ_SCALE_TRIGGER = 22
    OBJ_SCALE = 23
    OBJ_TEX_SHIFT_X = 24
    OBJ_TEX_SHIFT_Y = 25
    OBJ_TEX_ROT = 26
    OBJ_TEX_ZOOM = 27
    # Ellipse specifics
    ELLI_SCALE_X = 28
    ELLI_SCALE_Y = 29
    # Polygon specifics
    POLY_SPOKES = 30
    POLY_DPHI = 31
    POLY_R = 32
    POLY_SCALE_X = 33
    POLY_SCALE_Y = 34
    POLY_CURVE_TRIGGER = 35
    # Composite components
    COMP_INIT_TRANS_X = 36
    COMP_INIT_TRANS_Y = 37
    COMP_NUM_COMPONENTS = 38
    COMP_IS_ADDITIVE = 39
    COMP_OFFSET = 40
    COMP_OFFSET_Y = 47
    # Thin objects / deformations / generic
    OBJ_IS_EXTRA_THIN = 41
    OBJ_DEFORMS_NONRIGIDLY = 42
    GENERIC_UNIFORM = 43
    GENERIC_TRIGGER = 44
    # Warp-field synthesis
    WARP_FIELD = 45
    WARP_ASSIGN = 46


MAX_SPOKES = 20


def _build_layout():
    vec = {
        Stream.POLY_DPHI: MAX_SPOKES,
        Stream.POLY_R: MAX_SPOKES,
        Stream.POLY_CURVE_TRIGGER: MAX_SPOKES,
    }
    offsets = {}
    acc = 0
    for s in sorted(Stream, key=int):
        offsets[s] = acc
        acc += vec.get(s, 2)
    return offsets, acc


SLOT_OFFSET, SCOPE_STRIDE = _build_layout()


def _rotl(x, d: int):
    return ((x << d) & _M32) | (x >> (32 - d))


def threefry2x32(k1, k2, x1, x2):
    """The threefry2x32 hash (20 rounds) of counter words (x1, x2) under key
    (k1, k2). All arguments are int64 tensors of uint32 values, broadcast
    together; returns the two output words."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x = [(x1 + ks[0]) & _M32, (x2 + ks[1]) & _M32]
    for i in range(5):
        for r in _ROT[i % 2]:
            x[0] = (x[0] + x[1]) & _M32
            x[1] = _rotl(x[1], r) ^ x[0]
        x[0] = (x[0] + ks[(i + 1) % 3]) & _M32
        x[1] = (x[1] + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x[0], x[1]


def root_key(seed: int, device="cpu") -> torch.Tensor:
    """``jax.random.key(seed)`` for a 32-bit seed: the pair (0, seed)."""
    seed = int(seed)
    if not -(2**31) <= seed < 2**32:
        raise ValueError("seed must fit in 32 bits")
    return torch.tensor([0, seed & _M32], dtype=torch.int64, device=device)


def sample_key(root: torch.Tensor, sample_index) -> torch.Tensor:
    """``jax.random.fold_in(root, sample_index)``: threefry of the counter
    pair (0, index) under the root key. ``sample_index`` may be a tensor of
    indices; returns keys of shape index.shape + (2,). A batch of keys
    (..., 2) with one index (or as many) folds in elementwise."""
    idx = torch.as_tensor(sample_index, device=root.device).to(torch.int64)
    idx = idx & _M32
    o1, o2 = threefry2x32(root[..., 0], root[..., 1], torch.zeros_like(idx),
                          idx)
    return torch.stack([o1, o2], dim=-1)


def fold_in(key: torch.Tensor, data: int) -> torch.Tensor:
    """``jax.random.fold_in(key, data)`` for a key (2,), or a batch of keys
    (..., 2), and a Python int."""
    return sample_key(key, int(data))


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split(key, num)``: key i is threefry(key, (0, i))
    (the fold-like split of ``jax_threefry_partitionable=True``). Returns
    (num, 2), or (..., num, 2) for a batch of keys (..., 2)."""
    cnt = torch.arange(num, dtype=torch.int64, device=key.device)
    o1, o2 = threefry2x32(key[..., 0:1], key[..., 1:2], torch.zeros_like(cnt),
                          cnt)
    return torch.stack([o1, o2], dim=-1)


def _bits(key: torch.Tensor, shape) -> torch.Tensor:
    """``jax.random.bits(key, shape, uint32)`` for keys (..., 2): the
    keys' leading shape, then ``shape``; value i of the flat ``shape`` is
    word i of the key's stream."""
    n = int(np.prod(shape)) if shape else 1
    return random_bits(key, n).reshape(key.shape[:-1] + tuple(shape))


def uniform(key: torch.Tensor, a: float, b: float, shape=()) -> torch.Tensor:
    """``jax.random.uniform(key, shape, minval=a, maxval=b)`` in float32 (a
    batch of keys (..., 2) draws each key's ``shape``):
    23 random bits as the mantissa of a float in [1, 2), minus 1, then
    ``u * (b - a) + a``, held at ``a`` from below. XLA:CPU contracts that
    scale-and-shift into one fused multiply-add (one rounding), so it is
    computed here in float64 and rounded once: exact wherever the product
    and ``a`` span under 53 bits, as for every range the port draws."""
    lo = np.float32(a)
    span = np.float32(np.float32(b) - lo)
    mant = ((_bits(key, shape) >> 9) | 0x3F800000).to(torch.int32)
    u = mant.view(torch.float32) - 1.0
    v = (u.to(torch.float64) * float(span) + float(lo)).to(torch.float32)
    return torch.clamp(v, min=float(lo))


NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
SQRT2 = _fp.f32(np.sqrt(2.0))


def random_bits(keys: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.bits(key, (n,), uint32)`` for a batch of keys
    (..., 2): word i is the xor of threefry(key, (0, i)). int64 result."""
    cnt = torch.arange(n, dtype=torch.int64, device=keys.device)
    k1 = keys[..., 0:1]
    k2 = keys[..., 1:2]
    o1, o2 = threefry2x32(k1, k2, torch.zeros_like(cnt), cnt)
    return o1 ^ o2


def sample_bits_table(skeys: torch.Tensor, n_scopes: int) -> torch.Tensor:
    """All random words of each sample: (..., n_scopes, SCOPE_STRIDE) with
    uint32 values in int64, one threefry call per sample key."""
    bits = random_bits(skeys, n_scopes * SCOPE_STRIDE)
    return bits.reshape(skeys.shape[:-1] + (n_scopes, SCOPE_STRIDE))


_U24 = np.float32(1.0 / (1 << 24))


class ScopeDraws:
    """Static-slot draw accessors over scope rows (..., SCOPE_STRIDE).

    ``uniform`` is U[a, b) at 24-bit resolution, ``uniform_int`` the closed
    range [a, b] (modulo), ``normal`` a Box-Muller N(0,1) reduced to its
    cosine branch. Results carry the rows' leading shape."""

    __slots__ = ("row",)

    def __init__(self, row):
        self.row = row

    def _slot(self, stream, width=1):
        off = SLOT_OFFSET[stream]
        return self.row[..., off : off + width]

    def u01(self, stream, width=1):
        b = self._slot(stream, width)
        return (b >> 8).to(torch.float32) * float(_U24)

    def uniform(self, stream, a, b, shape=()):
        width = int(np.prod(shape)) if shape else 1
        u = self.u01(stream, width)
        val = a + u * float(np.float32(b - a))
        if shape:
            return val.reshape(val.shape[:-1] + tuple(shape))
        return val[..., 0]

    def uniform_int(self, stream, a, b):
        span = b - a + 1
        return (a + (self._slot(stream)[..., 0] % span)).to(torch.int32)

    def raw_index(self, stream):
        """Non-negative unbounded random index (callers take ``% n``)."""
        return (self._slot(stream)[..., 0] & 0x7FFFFFFF).to(torch.int32)

    def normal(self, stream):
        b = self._slot(stream, 2)
        u1 = (b[..., 0] >> 8).to(torch.float32) * float(_U24) + float(
            np.float32(0.5 / (1 << 24))
        )
        u2 = (b[..., 1] >> 8).to(torch.float32) * float(_U24)
        r = _fp.sqrt(-2.0 * _fp.log(u1))
        return r * _fp.cos(float(np.float32(2.0 * np.pi)) * u2)
