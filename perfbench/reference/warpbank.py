"""The warp-field bank of the reference: mode 9's deformation fields of a
bank epoch from the seed, restated in plain float32 PyTorch (every product
rounded on its own), one field and one direction at a time.

Content (the ``"pallas"`` stream, whose bank the program holds bit for bit
on every device):

- an epoch ``e`` of root key ``root`` has ``F`` fields; field ``i`` draws a
  hex grid of support-weighted displacers (translation, rotation, zoom) from
  ``fold_in(fold_in(fold_in(root, e), WARP_FIELD), i)``;
- each field has two directions, the flow and its inverse (the displacers'
  inverse motions); a direction's elementary field is the displacers' sum,
  added in index order, on the half lattice (coordinates ``2 i``), times
  0.5, in the deterministic elementary functions below;
- 16 doublings ``f <- f + f o (id + f)`` there, then ``2 * upsample2``
  (NaN as 0), then one doubling at full size, then values under 1e-3 set
  to 0. A pixel whose position ``p + f(p)`` leaves the field is frozen and
  flagged before each doubling and after the last; flagged pixels are NaN;
- a doubling's lookup is the separable warp: a row pass that reads each
  row at ``x + gdisp``, then a column pass at ``y + f_y``. ``gdisp`` is
  ``f_x`` at the column-inverse position: on the lattice of every 4th row
  and column, 8 fixed-point steps of ``w = y + f_y(x, y)/4`` along each
  lattice column, then ``f_x`` there, upsampled x2 twice. Every read is a
  bilinear lerp ``p0 + (p1 - p0) t`` clamped to the row;
- the band rule: a read sees only a band of 128-lane tiles that starts at
  the tile of the smallest left tap of its block, and reads 0 outside it.
  The row passes' blocks are 256 rows (a field's two channels stacked) by
  128 lanes, with bands of 3 tiles; the solve's blocks are all rows of a
  field by 128 lanes of its transposed lattice (zero-padded to a multiple
  of 128), with bands of 2 tiles.

The scene's planes of the epoch: the big fields with NaN as 0, the
column-inverse ``gdisp`` of each inverse field (the same solve), and per
bank slot (field-major, crops in :func:`crop_origins` order) the crop of
``[gdisp, iflow_y, flow_x, flow_y]`` at the frame's size; a deforming
background reads ``2 * [gdisp, iflow_y]`` x2-upscaled about the crop's
centre (:meth:`Epoch.bg_planes`).
"""

from __future__ import annotations

import math
from typing import List, NamedTuple

import torch

from . import fp
from .render import _exact
from .streams import Stream, fold_in, random_bits, split, uniform

COMPOSE_ITERS = 17
HALF_ITERS = 16
SOLVE_STRIDE = 4
SOLVE_ITERS = 8
SOLVE_BAND = 2      # tiles of 128 lanes
ROW_BAND = 3
GRID_SPACING = 200
TRANSLATION_SCALE = 3e-4
ROTATION_SCALE = 2e-6
ZOOM_SCALE = 2e-6
SUPPORT_SIGMA = 50.0
SUPPORT_SIGMA_JITTER = 20.0
CENTER_JITTER = 10.0
_M32 = 0xFFFFFFFF


def big_field_size(width: int, height: int) -> int:
    return 3 * max(width, height)


def crop_origins(width: int, height: int):
    """The bank's crop tiling of a big field: stride (W/3, H/3), from
    (W/4, H/4) up to ``big - 5W/4`` and ``big - 5H/4``; (x, y) row-major."""
    big = big_field_size(width, height)
    xs = range(width // 4, big - 5 * width // 4, width // 3)
    ys = range(height // 4, big - 5 * height // 4, height // 3)
    return [(x, y) for y in ys for x in xs]


def n_slots(width: int, height: int, fields: int) -> int:
    return len(crop_origins(width, height)) * fields


# ---------------------------------------------------------------------------
# Draws and elementary functions
# ---------------------------------------------------------------------------


def randint(key, a: int, b: int, n: int):
    """``jax.random.randint(key, (n,), a, b + 1)``: two words a value from a
    split of ``key``, reduced modulo the span with 32-bit wrap-around."""
    span = max((b + 1) - a, 1)
    k1, k2 = split(key, 2)
    hi, lo = random_bits(k1, n), random_bits(k2, n)
    mult = (2 ** 16) % span
    mult = ((mult * mult) & _M32) % span
    off = (((hi % span) * mult) & _M32) + (lo % span)
    return (a + (off & _M32) % span).to(torch.int32)


def _t(x):
    return x if torch.is_tensor(x) else torch.tensor(x, dtype=torch.float32)


def recip(y):
    """1/y for normal nonzero y: the bit-trick seed ``0x7EF311C3 - |y|``
    and three Newton steps ``r (2 - |y| r)``, the sign restored."""
    y = _t(y)
    a = torch.abs(y)
    r = (0x7EF311C3 - a.view(torch.int32)).view(torch.float32)
    for _ in range(3):
        r = r * (2.0 - a * r)
    return torch.where(y < 0, -r, r)


def exp(x):
    """exp(x) for x <= 0 (clamped at -87): ``2^k`` times a degree-6
    polynomial of the Cody-Waite remainder."""
    c = (1.9875691500e-4, 1.3981999507e-3, 8.3334519073e-3, 4.1665795894e-2,
         1.6666665459e-1, 5.0000001201e-1)
    x = torch.clamp(_t(x), min=fp.f32(-87.0))
    k = torch.floor(x * 1.44269504088896341 + 0.5)
    r = (x - k * 0.693359375) - k * -2.12194440e-4
    p = torch.full_like(r, fp.f32(c[0]))
    for ci in c[1:]:
        p = p * r + ci
    e = (p * (r * r) + r) + 1.0
    return e * ((k.to(torch.int32) + 127) << 23).view(torch.float32)


def _quadrant(x):
    x = _t(x)
    j = torch.floor(x * (2.0 / 3.141592653589793) + 0.5)
    r = ((x - j * 1.5703125) - j * 4.837512969970703125e-4) \
        - j * 7.549789948768648e-8
    return j.to(torch.int32) & 3, r


def _sin_poly(r):
    r2 = r * r
    p = torch.full_like(r, fp.f32(-1.9515295891e-4))
    for c in (8.3321608736e-3, -1.6666654611e-1):
        p = p * r2 + c
    return (p * r2) * r + r


def _cos_poly(r):
    r2 = r * r
    p = torch.full_like(r, fp.f32(2.443315711809948e-5))
    for c in (-1.388731625493765e-3, 4.166664568298827e-2):
        p = p * r2 + c
    return (p * (r2 * r2) - 0.5 * r2) + 1.0


def sin(x):
    """sin(x) for |x| <= 4: quadrant reduction and the two polynomials."""
    m, r = _quadrant(x)
    v = torch.where(m % 2 == 0, _sin_poly(r), _cos_poly(r))
    return torch.where(m >= 2, -v, v)


def cos(x):
    """cos(x) for |x| <= 4."""
    m, r = _quadrant(x)
    v = torch.where(m % 2 == 0, _cos_poly(r), -_sin_poly(r))
    return torch.where(m >= 2, -v, v)


# ---------------------------------------------------------------------------
# Displacers and the elementary field
# ---------------------------------------------------------------------------


class Displacers(NamedTuple):
    """One field's displacers, (N,) each."""

    kind: torch.Tensor       # 0 translation, 1 rotation, 2 zoom
    cx: torch.Tensor
    cy: torch.Tensor
    p0: torch.Tensor         # dx | angular speed | zoom factor
    p1: torch.Tensor         # dy
    sup_cx: torch.Tensor
    sup_cy: torch.Tensor
    sup_sx: torch.Tensor
    sup_sy: torch.Tensor
    sup_angle: torch.Tensor


def displacers(key, size: int) -> Displacers:
    """The displacers of a ``size`` x ``size`` field: a hex lattice of
    spacing 200 (rows 173 apart, odd rows shifted by 100), each jittered
    and drawn from ``key``."""
    dev = key.device
    iso = int(GRID_SPACING / 2.0 * (3.0 ** 0.5))
    rows, cols = (size + iso - 1) // iso, size // GRID_SPACING
    yi, xi = torch.meshgrid(torch.arange(rows, device=dev),
                            torch.arange(cols, device=dev), indexing="ij")
    gx = (xi * GRID_SPACING + torch.where(yi % 2 == 1, GRID_SPACING // 2, 0)
          + GRID_SPACING // 2).reshape(-1).to(torch.float32)
    gy = (yi * iso + GRID_SPACING // 2).reshape(-1).to(torch.float32)
    n = gx.shape[0]
    ks = split(key, 8)

    def u(k):
        return uniform(k, -1.0, 1.0, (n,))

    kind = randint(ks[0], 0, 2, n)
    p_a, p_b = u(ks[1]), u(ks[2])
    sup = split(ks[5], 5)
    return Displacers(
        kind=kind,
        cx=gx + u(ks[3]) * CENTER_JITTER,
        cy=gy + u(ks[4]) * CENTER_JITTER,
        p0=torch.where(kind == 0, p_a * TRANSLATION_SCALE,
                       torch.where(kind == 1,
                                   p_a * math.pi * 2.0 * ROTATION_SCALE,
                                   1.0 + p_a * ZOOM_SCALE)),
        p1=p_b * TRANSLATION_SCALE,
        sup_cx=gx + u(sup[0]) * CENTER_JITTER,
        sup_cy=gy + u(sup[1]) * CENTER_JITTER,
        sup_sx=SUPPORT_SIGMA + u(sup[2]) * SUPPORT_SIGMA_JITTER,
        sup_sy=SUPPORT_SIGMA + u(sup[3]) * SUPPORT_SIGMA_JITTER,
        sup_angle=u(sup[4]) * math.pi)


def elementary_field(d: Displacers, size: int, inverse: bool, stride: float):
    """One direction's elementary field (2, size, size) on the lattice of
    coordinates ``i * stride``: every displacer's motion (its inverse for
    ``inverse``) weighted by its rotated Gaussian support, the displacers
    added in index order."""
    dev = d.kind.device
    ys = torch.arange(size, dtype=torch.float32, device=dev) * stride
    py, px = torch.meshgrid(ys, ys, indexing="ij")
    col = lambda v: v[:, None, None]
    p0 = col(d.p0)
    dx, dy = px - col(d.cx), py - col(d.cy)
    om = p0 if inverse else -p0
    c, s = cos(om), sin(om)
    rot_x = (c * dx - s * dy) - dx
    rot_y = (s * dx + c * dy) - dy
    f = recip(p0) if inverse else p0
    zoom_x, zoom_y = (f - 1.0) * dx, (f - 1.0) * dy
    sgn = -1.0 if inverse else 1.0
    kind = col(d.kind)
    fx = torch.where(kind == 0, sgn * p0, torch.where(kind == 1, rot_x, zoom_x))
    fy = torch.where(kind == 0, sgn * col(d.p1),
                     torch.where(kind == 1, rot_y, zoom_y))
    # the support: a Gaussian of sigmas (sx, sy) rotated by the angle
    a, b = cos(col(d.sup_angle)), -sin(col(d.sup_angle))
    ex, ey = px - col(d.sup_cx), py - col(d.sup_cy)
    sx, sy = col(d.sup_sx), col(d.sup_sy)
    rx = a * ex + b * ey
    ry = (-b * ex + a * ey) * (sx * recip(sy))
    w = exp(-(rx * rx + ry * ry) * recip(2.0 * sx * sx))
    tx, ty = fx * w, fy * w
    out_x = torch.zeros((size, size), dtype=torch.float32, device=dev)
    out_y = torch.zeros_like(out_x)
    for i in range(tx.shape[0]):
        out_x = out_x + tx[i]
        out_y = out_y + ty[i]
    return torch.stack([out_x, out_y])


# ---------------------------------------------------------------------------
# Banded reads, the column-inverse solve, the doubling
# ---------------------------------------------------------------------------


def band_lerp(src, u, block_rows: int, band: int, valid: int):
    """Bilinear reads of rows ``src`` (G, L) at positions ``u`` (G, X),
    clamped to [0, valid - 1], under the band rule: per block of
    ``block_rows`` rows by 128 positions, only the ``band`` 128-lane tiles
    from the tile of the block's smallest left tap are read, 0 elsewhere."""
    G, X = u.shape
    tiles = src.shape[1] // 128
    uc = torch.clamp(u, 0.0, valid - 1.0)
    uf = torch.floor(uc)
    t = uc - uf
    u0 = uf.to(torch.int64)
    u1 = torch.clamp(u0 + 1, max=valid - 1)
    n = min(band, tiles)
    first = u0.reshape(G // block_rows, block_rows, X // 128, 128).amin((1, 3))
    first = torch.clamp(torch.clamp(first >> 7, max=tiles - n), min=0) * 128
    lo = first.repeat_interleave(block_rows, 0).repeat_interleave(128, 1)

    def read(i):
        v = torch.gather(src, 1, i)
        return torch.where((i >= lo) & (i < lo + n * 128), v,
                           torch.zeros_like(v))

    p0, p1 = read(u0), read(u1)
    return p0 + (p1 - p0) * t


def upsample2(p):
    """x2 bilinear upsample of (..., h, w) planes: values on even rows and
    columns, edge midpoints between (the last row and column repeated)."""
    h, w = p.shape[-2:]
    nxt = torch.cat([p[..., 1:, :], p[..., -1:, :]], dim=-2)
    rows = torch.stack([p, (p + nxt) * 0.5], dim=-2).reshape(
        *p.shape[:-2], 2 * h, w)
    nxt = torch.cat([rows[..., 1:], rows[..., -1:]], dim=-1)
    return torch.stack([rows, (rows + nxt) * 0.5], dim=-1).reshape(
        *p.shape[:-2], 2 * h, 2 * w)


def column_inverse(f, q=_exact):
    """``gdisp`` of one field ``f`` (2, S, S): f_x(x, y*) where
    ``w = y* + f_y(x, y*)``, solved on the stride-4 lattice along each
    lattice column and upsampled to (S, S)."""
    S = f.shape[-1]
    n = S // SOLVE_STRIDE
    lanes = -(-n // 128) * 128
    pad = (0, lanes - n)
    sub = f[:, ::SOLVE_STRIDE, ::SOLVE_STRIDE]
    dy = torch.nn.functional.pad(sub[1].t() * (1.0 / SOLVE_STRIDE), pad)
    dx = torch.nn.functional.pad(sub[0].t(), pad)
    w = torch.arange(lanes, dtype=torch.float32, device=f.device).expand(n, -1)
    d = torch.zeros_like(w)
    for _ in range(SOLVE_ITERS):
        d = q(band_lerp(dy, w - d, n, SOLVE_BAND, n))
    gd = band_lerp(dx, w - d, n, SOLVE_BAND, n)[:, :n].t()
    return q(upsample2(upsample2(gd)))


def row_pass(planes, disp):
    """Both channels of ``planes`` (2, R, L) read along their rows at
    ``x + disp`` (R, L), the channels stacked for the band rule."""
    C, R, L = planes.shape
    u = (torch.arange(L, dtype=torch.float32, device=planes.device)
         + disp).expand(C, R, L).reshape(C * R, L)
    rows = 256 if (C * R) % 256 == 0 else 128
    return band_lerp(planes.reshape(C * R, L), u, rows, ROW_BAND, L).reshape(
        C, R, L)


def double(f, flagged, q=_exact):
    """One doubling of ``f`` (2, S, S): pixels leaving the field are
    flagged and kept, the others take ``f + f o (id + f)`` by the row pass
    at ``x + gdisp`` and the column pass at ``y + f_y``."""
    S = f.shape[-1]
    ax = torch.arange(S, dtype=torch.float32, device=f.device)
    out = _leaves(f, ax)
    tmp = row_pass(f, column_inverse(f, q))
    lut = row_pass(q(tmp).transpose(1, 2), f[1].t()).transpose(1, 2)
    return q(torch.where(out, f, f + lut)), flagged | out


def _leaves(f, ax):
    tx = ax[None, :] + f[0]
    ty = ax[:, None] + f[1]
    S = f.shape[-1]
    return (tx < 0) | (tx >= S) | (ty < 0) | (ty >= S)


def compose(f_h, q=_exact):
    """The big field (2, S, S) of one direction from its half-lattice
    elementary field (already x 0.5): 16 doublings, x2 upsample, the last
    doubling, ``clamp_near_zeros``; NaN where flagged."""
    def doublings(f, n):
        flagged = torch.zeros(f.shape[1:], dtype=torch.bool, device=f.device)
        for _ in range(n):
            f, flagged = double(f, flagged, q)
        flagged = flagged | _leaves(f, torch.arange(
            f.shape[-1], dtype=torch.float32, device=f.device))
        return torch.where(flagged, torch.full_like(f, float("nan")), f)

    f = doublings(f_h, HALF_ITERS)
    f = q(2.0 * upsample2(torch.nan_to_num(f)))
    f = doublings(f, COMPOSE_ITERS - HALF_ITERS)
    return torch.where(torch.abs(f) < fp.f32(1e-3), torch.zeros_like(f), f)


# ---------------------------------------------------------------------------
# An epoch's planes
# ---------------------------------------------------------------------------


def _expand(p, dim: int, base, n: int):
    """x2 upsample about a half-pixel offset along ``dim`` of ``p``: output
    ``j`` lies at ``base + j // 2 + 0.75`` (even ``j``: 0.25 a + 0.75 b) or
    ``+ 1.25`` (odd ``j``: 0.75 b + 0.25 c) of the taps a, b, c at
    ``base + j // 2 + (0, 1, 2)``, clamped to the plane. ``base`` holds the
    first output's pair base; ``n`` outputs."""
    j = torch.arange(n, device=p.device)
    k = base + j // 2
    size = p.shape[dim]
    a, b, c = (p.index_select(dim, torch.clamp(k + s, 0, size - 1))
               for s in (0, 1, 2))
    even = (j % 2 == 0).reshape([-1 if i == dim else 1
                                 for i in range(p.dim())])
    return torch.where(even, 0.25 * a + 0.75 * b, 0.75 * b + 0.25 * c)


class Epoch:
    """One bank epoch's planes, built from ``(root, epoch)``: for each field
    its flow and inverse flow with NaN as 0, and the inverse's ``gdisp``.
    ``q`` rounds every per-pixel value (the control's bfloat16)."""

    def __init__(self, root, epoch: int, width: int, height: int,
                 fields: int, q=_exact):
        self.W, self.H = width, height
        self.origins = crop_origins(width, height)
        S = big_field_size(width, height)
        if S % 256:
            raise ValueError(f"the bank of {width}x{height} frames has big "
                             f"fields of {S}, not a multiple of 256")
        key = fold_in(root, int(epoch))
        self.flow: List[torch.Tensor] = []
        self.iflow: List[torch.Tensor] = []
        self.gdisp: List[torch.Tensor] = []
        for i in range(fields):
            d = displacers(fold_in(fold_in(key, int(Stream.WARP_FIELD)), i), S)
            pair = [compose(q(elementary_field(d, S // 2, inv, 2.0) * 0.5), q)
                    for inv in (False, True)]
            flow, iflow = (torch.nan_to_num(p) for p in pair)
            self.flow.append(flow)
            self.iflow.append(iflow)
            self.gdisp.append(column_inverse(iflow, q))

    def _slot(self, s: int):
        x, y = self.origins[s % len(self.origins)]
        return s // len(self.origins), x, y

    def obj_planes(self, s: int, rows=None):
        """Slot ``s``'s (4, len(rows), W) planes ``[gdisp, iflow_y, flow_x,
        flow_y]`` at frame rows ``rows`` (default 0..H-1; a row off the
        frame reads the big field around the crop, clamped to it)."""
        i, x, y = self._slot(s)
        if rows is None:
            rows = torch.arange(self.H, device=self.flow[i].device)
        S = self.flow[i].shape[-1]
        r = torch.clamp(rows + y, 0, S - 1)
        big = torch.stack([self.gdisp[i], self.iflow[i][1], self.flow[i][0],
                           self.flow[i][1]])
        return big[:, r, x : x + self.W]

    def bg_planes(self, s: int, rows):
        """A deforming background's (2, len(rows), W) planes ``2 * [gdisp,
        iflow_y]`` of slot ``s`` at frame rows ``rows``: the field about the
        crop's centre upsampled x2, ``D(x, y) = 2 f((x + W/2 + 0.5)/2 - 0.5,
        (y + H/2 + 0.5)/2 - 0.5)`` in crop coordinates."""
        i, x, y = self._slot(s)
        big = torch.stack([self.gdisp[i], self.iflow[i][1]])
        base_r = y + self.H // 4 - 1 + torch.div(rows, 2, rounding_mode="floor")
        a, b, c = (big[:, torch.clamp(base_r + k, 0, big.shape[-1] - 1)]
                   for k in (0, 1, 2))
        odd = (rows % 2 == 1)[None, :, None]
        r = torch.where(odd, 0.75 * b + 0.25 * c, 0.25 * a + 0.75 * b)
        return 2.0 * _expand(r, 2, x + self.W // 4 - 1, self.W)
