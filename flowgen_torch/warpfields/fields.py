"""Nonrigid deformation fields: the displacer population and the elementary
field (port of ``flowgen/warpfields/fields.py``).

A big field's elementary flow is the sum of support-weighted displacers
(translation, rotation, zoom) on a hex grid; the bank integrates it 2^17-fold
by binary doubling: in the default ``warp_bank_impl="pallas"`` stream by
separable row warps (``warpfields/compose.py``), in the ``"xla"`` stream by
quad-gather bilinear lookups (:func:`self_compose`,
:func:`make_big_fields`). Every expression here keeps the JAX package's
order of operations and goes through ``ops/detmath``: the doublings amplify
a 1-ulp difference into pixels, so the elementary field has
to be bit-identical to the JAX package's.

``elementary_field`` is batched over directions: one call evaluates every
(field, flow / inverse flow) pair of a bank epoch, accumulating the
displacers in the JAX ``fori_loop``'s order. The displacers' constants
(rotations, zoom factors, support scales) are derived for all of them at
once, elementwise and so in the same bits. On a CUDA device one kernel
(``csrc/fields.cu:elementary_field_kernel``, counted in
``elementary_field.launches``) then sums every displacer over every pixel;
its plain version, ``elementary_field_plain``, runs the terms as full-plane
PyTorch operations, one displacer after another, on the CPU and inside
``compose.plain_versions()``.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .._fp import const, f32
from ..ops.detmath import det_cos, det_div, det_exp, det_recip, det_sin
from ..ops.texture import make_quad, sample_bilinear_quad
from ..random.streams import split, uniform, uniform_int

COMPOSE_ITERS = 17
GRID_SPACING = 200
TRANSLATION_SCALE = 3e-4
ROTATION_SCALE = 2e-6  # x 2*pi
ZOOM_SCALE = 2e-6
SUPPORT_SIGMA = 50.0
SUPPORT_SIGMA_JITTER = 20.0
CENTER_JITTER = 10.0


class DisplacerGrid(NamedTuple):
    """Parameters of a hex grid of support-weighted displacers: (..., N)
    leaves (a leading axis batches several grids)."""

    kind: torch.Tensor       # int32: 0=translation, 1=rotation, 2=zoom
    cx: torch.Tensor
    cy: torch.Tensor
    p0: torch.Tensor         # translation dx | angular speed | zoom factor
    p1: torch.Tensor         # translation dy | unused
    sup_cx: torch.Tensor
    sup_cy: torch.Tensor
    sup_sx: torch.Tensor
    sup_sy: torch.Tensor
    sup_angle: torch.Tensor


def hex_grid_centers(size: int, spacing: int = GRID_SPACING, device="cpu"):
    """Hex lattice covering a size x size field: (x, y) float32 of length
    rows*cols."""
    iso = int(spacing / 2.0 * (3.0**0.5))
    rows = (size + iso - 1) // iso
    cols = size // spacing
    yidx, xidx = torch.meshgrid(torch.arange(rows, device=device),
                                torch.arange(cols, device=device), indexing="ij")
    x = xidx * spacing + torch.where(yidx % 2 == 1, spacing // 2, 0) + spacing // 2
    y = yidx * iso + spacing // 2
    return x.reshape(-1).to(torch.float32), y.reshape(-1).to(torch.float32)


def sample_displacer_grid(key: torch.Tensor, size: int) -> DisplacerGrid:
    """Random displacer population of one big field, keyed like the JAX
    package's (``jax.random.split`` / ``uniform`` / ``randint``)."""
    gx, gy = hex_grid_centers(size, device=key.device)
    n = gx.shape[0]
    ks = split(key, 8)
    kind = uniform_int(ks[0], 0, 2, (n,))

    def u(k):
        return uniform(k, -1.0, 1.0, (n,))

    p_a = u(ks[1])
    p_b = u(ks[2])
    cx = gx + u(ks[3]) * CENTER_JITTER
    cy = gy + u(ks[4]) * CENTER_JITTER
    p0 = torch.where(
        kind == 0,
        p_a * TRANSLATION_SCALE,
        torch.where(kind == 1, p_a * math.pi * 2.0 * ROTATION_SCALE,
                    1.0 + p_a * ZOOM_SCALE),
    )
    p1 = p_b * TRANSLATION_SCALE
    sup = split(ks[5], 5)
    return DisplacerGrid(
        kind=kind, cx=cx, cy=cy, p0=p0, p1=p1,
        sup_cx=gx + u(sup[0]) * CENTER_JITTER,
        sup_cy=gy + u(sup[1]) * CENTER_JITTER,
        sup_sx=SUPPORT_SIGMA + u(sup[2]) * SUPPORT_SIGMA_JITTER,
        sup_sy=SUPPORT_SIGMA + u(sup[3]) * SUPPORT_SIGMA_JITTER,
        sup_angle=u(sup[4]) * math.pi,
    )


def constant_support(x, y, factor=1.0):
    """Supports::Constant (WarpFields.cpp:50-59): ``factor`` everywhere,
    float32, in the broadcast shape of ``x`` and ``y``."""
    shape = torch.broadcast_shapes(torch.as_tensor(x).shape,
                                   torch.as_tensor(y).shape)
    dev = x.device if torch.is_tensor(x) else (
        y.device if torch.is_tensor(y) else "cpu")
    return torch.full(shape, f32(factor), dtype=torch.float32, device=dev)


def gaussian1d_support(x, y, cx, cy, sigma):
    """Isotropic Gaussian, peak-normalised (the reference's
    Supports::Gaussian1D), in detmath arithmetic."""
    d2 = (x - cx) * (x - cx) + (y - cy) * (y - cy)
    return det_exp(-det_div(d2, 2.0 * sigma * sigma))


def gaussian2d_support(x, y, cx, cy, sigma_x, sigma_y, angle):
    """Anisotropic rotated Gaussian, peak-normalised (the reference's
    Supports::Gaussian2D), in detmath arithmetic."""
    a, b = det_cos(angle), -det_sin(angle)
    rx = a * (x - cx) + b * (y - cy)
    ry = (-b * (x - cx) + a * (y - cy)) * det_div(sigma_x, sigma_y)
    r2 = rx * rx + ry * ry
    return det_exp(-r2 * det_recip(2.0 * sigma_x * sigma_x))


def _displacer_constants(grid: DisplacerGrid, inverse):
    """Every displacer's per-direction constants, each (N, M, 1, 1): its
    motion's rotation cosine and sine, the zoom or inverse zoom factor, the
    translation, and its support's rotation and scales."""
    def at(v):
        return v.t().reshape(v.shape[1], v.shape[0], 1, 1)

    inv = inverse.reshape(1, -1, 1, 1)
    p0 = at(grid.p0)
    om = torch.where(inv, p0, -p0)
    sgn = torch.where(inv, -1.0, 1.0)
    sx, sy, angle = at(grid.sup_sx), at(grid.sup_sy), at(grid.sup_angle)
    return {
        "kind": at(grid.kind), "cx": at(grid.cx), "cy": at(grid.cy),
        "c": det_cos(om), "s": det_sin(om),
        "f": torch.where(inv, det_recip(p0), p0),
        "tx": sgn * p0, "ty": sgn * at(grid.p1),
        "sup_cx": at(grid.sup_cx), "sup_cy": at(grid.sup_cy),
        "a": det_cos(angle), "b": -det_sin(angle),
        "ratio": det_div(sx, sy), "rinv": det_recip(2.0 * sx * sx),
    }


def _displacer_term(k: dict, px, py):
    """Support-weighted flow of one displacer over the pixel grid, for
    every direction at once: its constants ``k`` (M, 1, 1); returns two
    (M, S, S) planes. Elementwise the arithmetic of
    :func:`gaussian2d_support` and the JAX package's displacer term."""
    dx = px - k["cx"]
    dy = py - k["cy"]
    c, s = k["c"], k["s"]
    rot_fx = (c * dx - s * dy) - dx
    rot_fy = (s * dx + c * dy) - dy
    zoom_fx = (k["f"] - 1.0) * dx
    zoom_fy = (k["f"] - 1.0) * dy
    kind = k["kind"]
    fx = torch.where(kind == 0, k["tx"],
                     torch.where(kind == 1, rot_fx, zoom_fx))
    fy = torch.where(kind == 0, k["ty"],
                     torch.where(kind == 1, rot_fy, zoom_fy))
    del dx, dy, rot_fx, rot_fy, zoom_fx, zoom_fy
    ex, ey = px - k["sup_cx"], py - k["sup_cy"]
    a, b = k["a"], k["b"]
    rx = a * ex + b * ey
    ry = (-b * ex + a * ey) * k["ratio"]
    r2 = rx * rx + ry * ry
    w = det_exp(-r2 * k["rinv"])
    return fx * w, fy * w


def stack_grids(grids, inverse_flags):
    """One (M, N) grid from per-direction grids, with their (M,) inverse
    flags (a constant of the device, so no host-to-device copy)."""
    g = DisplacerGrid(*(torch.stack(v) for v in zip(*grids)))
    flags = tuple(bool(f) for f in inverse_flags)
    return g, const(("inverse_flags", flags), g.kind.device,
                    lambda: torch.tensor(flags, dtype=torch.bool))


def elementary_field_plain(grid: DisplacerGrid, size: int, inverse,
                           stride: float = 1.0):
    """The plain version of :func:`elementary_field`: the displacers'
    terms as full-plane PyTorch operations, one displacer after another."""
    dev = grid.kind.device
    ys = torch.arange(size, dtype=torch.float32, device=dev) * stride
    py, px = torch.meshgrid(ys, ys, indexing="ij")
    M, n = grid.kind.shape
    consts = _displacer_constants(grid, inverse)
    fx = torch.zeros((M, size, size), dtype=torch.float32, device=dev)
    fy = torch.zeros_like(fx)
    for i in range(n):
        tx, ty = _displacer_term({k: v[i] for k, v in consts.items()}, px, py)
        fx = fx + tx
        fy = fy + ty
    return torch.stack([fx, fy], dim=1)


# The order in which the kernel reads a displacer's constants
# (csrc/fields.cu:elementary_field_kernel).
_KERNEL_CONSTANTS = ("kind", "cx", "cy", "c", "s", "f", "tx", "ty", "sup_cx",
                     "sup_cy", "a", "b", "ratio", "rinv")


def _packed_constants(grid: DisplacerGrid, inverse):
    """:func:`_displacer_constants` as the kernel reads them: (M, N, 14)
    float32 in the order of ``_KERNEL_CONSTANTS``, ``kind`` as a float."""
    M, n = grid.kind.shape
    consts = _displacer_constants(grid, inverse)
    return torch.stack([consts[k].reshape(n, M).t().to(torch.float32)
                        for k in _KERNEL_CONSTANTS], dim=-1)


def elementary_field_cuda(consts, size: int, stride: float = 1.0):
    """Launch ``csrc/fields.cu:elementary_field_kernel`` on packed constants
    ``consts`` (M, N, 14) (:func:`_packed_constants`) on a CUDA device, on
    the current stream: returns (M, 2, size, size). Counted in
    ``elementary_field.launches``. Any other packing raises before the
    library loads."""
    from ..ops._build import load_fields_library
    from .compose import _ptr, _stream

    if consts.dtype != torch.float32:
        raise ValueError(f"elementary_field: constants must be float32, "
                         f"not {consts.dtype}")
    if consts.dim() != 3 or consts.shape[2] != len(_KERNEL_CONSTANTS):
        raise ValueError(f"elementary_field: constants must be (M, N, "
                         f"{len(_KERNEL_CONSTANTS)}); got {tuple(consts.shape)}")
    if not consts.is_contiguous():
        raise ValueError("elementary_field: constants must be contiguous")
    if consts.device.type != "cuda":
        raise ValueError("elementary_field: the kernel takes CUDA tensors")
    M, n, _ = consts.shape
    out = torch.empty((M, 2, size, size), dtype=torch.float32,
                      device=consts.device)
    err = load_fields_library().flowgen_elementary_field(
        _ptr(consts), _ptr(out), M, n, size, f32(stride), _stream(consts))
    if err != 0:
        raise RuntimeError(f"elementary_field kernel launch failed: CUDA "
                           f"error {err}")
    elementary_field.launches += 1
    return out


def elementary_field(grid: DisplacerGrid, size: int, inverse,
                     stride: float = 1.0):
    """Dense sum of every displacer's contribution over a size x size
    lattice with coordinates ``i * stride``, for M directions at once
    (``grid`` leaves (M, N), ``inverse`` (M,) bool). The displacers are
    added in index order, as the JAX package's ``fori_loop`` adds them.
    Returns (M, 2, size, size): planes x, y.

    CUDA tensors launch one kernel on the displacers' packed constants
    (:func:`elementary_field_cuda`); CPU tensors, and any inside
    ``compose.plain_versions()``, run :func:`elementary_field_plain`. Both
    give the same bits."""
    from .compose import _runs_plain

    if _runs_plain("elementary_field", grid.kind):
        return elementary_field_plain(grid, size, inverse, stride)
    return elementary_field_cuda(_packed_constants(grid, inverse), size,
                                 stride)


elementary_field.launches = 0


def clamp_near_zeros(field, threshold: float = 1e-3):
    """Zero out sub-threshold flows (FlowField::clamp_near_zeros)."""
    return torch.where(torch.abs(field) < f32(threshold),
                       torch.zeros_like(field), field)


def _upsample2(field):
    """Bilinear x2 upsample of (..., h, w) planes onto the full lattice
    (interleaved values and edge midpoints), as the JAX package's
    ``_upsample2`` on each channel."""
    h, w = field.shape[-2], field.shape[-1]
    nxt = torch.cat([field[..., 1:, :], field[..., -1:, :]], dim=-2)
    rows = torch.stack([field, (field + nxt) * 0.5], dim=-2).reshape(
        *field.shape[:-2], 2 * h, w)
    nxtc = torch.cat([rows[..., 1:], rows[..., -1:]], dim=-1)
    return torch.stack([rows, (rows + nxtc) * 0.5], dim=-1).reshape(
        *field.shape[:-2], 2 * h, 2 * w)


def self_compose(field, iters: int = COMPOSE_ITERS):
    """Binary-doubling integration ``f <- f + f o (id + f)``, ``iters``
    times, by quad-gather bilinear lookups: the ``warp_bank_impl="xla"``
    content stream. ``field`` (M, 2, S, S) planes x, y. A pixel whose
    lookup leaves the field keeps its value and is flagged, the last test
    comes after the last doubling, and flagged pixels are NaN. The lerps
    are FMAs (``texture.sample_bilinear_quad(contract=True)``), as XLA:CPU
    compiles the JAX package's loop."""
    M, _, S, _ = field.shape
    dev = field.device
    ys = torch.arange(S, dtype=torch.float32, device=dev)
    py, px = torch.meshgrid(ys, ys, indexing="ij")
    f = field.permute(0, 2, 3, 1).contiguous()
    flagged = torch.zeros((M, S, S), dtype=torch.bool, device=dev)

    def oob_of(f):
        tx = px + f[..., 0]
        ty = py + f[..., 1]
        return tx, ty, (tx < 0) | (tx >= S) | (ty < 0) | (ty >= S)

    for _ in range(iters):
        tx, ty, oob = oob_of(f)
        flagged = flagged | oob
        lut = sample_bilinear_quad(make_quad(f), tx, ty, wrap="clamp",
                                   channels=2, contract=True)
        f = torch.where(oob[..., None], f, f + lut)
    flagged = flagged | oob_of(f)[2]
    f = torch.where(flagged[..., None], torch.full_like(f, float("nan")), f)
    return f.permute(0, 3, 1, 2)


def compose_big_fields(f_h, coarse_iters: int = 16):
    """The doublings of :func:`make_big_fields` in the ``"xla"`` stream:
    ``coarse_iters`` of them on the half-lattice elementary fields ``f_h``
    (M, 2, size/2, size/2), ``2 * _upsample2(nan_to_num(.))``, the last
    ``COMPOSE_ITERS - coarse_iters`` at full size, ``clamp_near_zeros``.
    Returns (M, 2, size, size) with NaN at flagged pixels."""
    f_h = self_compose(f_h, coarse_iters)
    f = 2.0 * _upsample2(torch.nan_to_num(f_h))
    return clamp_near_zeros(self_compose(f, COMPOSE_ITERS - coarse_iters))


def make_big_fields(grid, inverse, size: int, coarse_iters: int = 16):
    """Composed big fields of M directions in the ``"xla"`` stream (the
    JAX package's ``make_big_field``, every direction of a bank epoch at
    once): the elementary field on the half lattice (stride 2) x 0.5, then
    :func:`compose_big_fields`. ``grid`` leaves (M, N), ``inverse`` (M,)
    bool. Returns (M, 2, size, size) with NaN at flagged pixels."""
    f_h = elementary_field(grid, size // 2, inverse, stride=2.0) * 0.5
    return compose_big_fields(f_h, coarse_iters)


def make_big_field(key, size: int, coarse_iters: int = 16):
    """One composed ``(flow, iflow)`` pair at size x size from one field
    key, each (2, size, size) planes x, y with NaN at flagged pixels."""
    grid = sample_displacer_grid(key, size)
    out = make_big_fields(*stack_grids([grid, grid], [False, True]), size,
                          coarse_iters)
    return out[0], out[1]
