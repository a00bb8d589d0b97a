"""Warp-field self-composition: the mode-9 bank producer's kernels and the
doubling loop around them (port of ``flowgen/warpfields/pallas_fields.py``).

Each big field is integrated 2^17-fold by binary doubling,
``f <- f + f o (id + f)``. The lookup ``f o (id + f)`` is a warp by a bounded
displacement, so it runs as two separable row passes (``hwarp_rows``, the
second on transposed planes), exact bilinear once pass 1 reads its
x-displacement at the row pass 2 will fetch. That column inverse is a
per-column fixed point ``w = y + f_y(x, y)``, solved on a 4x-coarse lattice
(``coarse_gdisp_batch``) and upsampled by interleaving.

Two wrappers of kernels, each with its plain PyTorch version beside it:

* ``coarse_gdisp_batch`` (TPU kernel: ``pallas_fields.py:_coarse_solve_kernel``
  via ``coarse_gdisp_batch``) -> ``csrc/fields.cu:coarse_solve_kernel``
  (the solve, reading D's strided coarse samples in place) and
  ``upsample4_kernel`` (the x4 upsample), each launch counted in
  ``coarse_gdisp_batch.launches``;
* ``hwarp_rows`` -> ``csrc/fields.cu:hwarp_rows_kernel`` (TPU kernel:
  ``pallas_fields.py:_hwarp_kernel`` via ``_hwarp_rows``), counted in
  ``hwarp_rows.launches``.

A CUDA tensor launches the kernels; a CPU tensor runs the plain version.
Inside ``with plain_versions():`` the plain versions run on any device:
the kernel-vs-plain comparisons on the card use it. Both read their taps
through the JAX kernels' banded rule (``ops/resample.py:banded_taps``) and
keep its order of operations, so the bank is the same bit for bit on the
CPU, on the card and in the JAX package.
"""

from __future__ import annotations

import contextlib
import ctypes

import torch

from ..ops.resample import banded_lerp
from .fields import COMPOSE_ITERS, _upsample2

COARSE = 4          # column-inverse lattice stride
SOLVE_ITERS = 8     # fixed-point iterations
HALF_ITERS = 16     # doublings on the half lattice (of COMPOSE_ITERS)
# Band widths in 128-lane tiles for |disp| <= 64 px (on the coarse lattice:
# 64 / COARSE lattice steps).
COARSE_SCAN = int((2 * 64.0 / COARSE + 131) // 128) + 1
HWARP_SCAN = int((2 * 64.0 + 131) // 128) + 1

_plain = False


@contextlib.contextmanager
def plain_versions():
    """Inside the block the bank kernels' wrappers run their plain versions
    on any device (the kernel-vs-plain comparisons on the card)."""
    global _plain
    prev, _plain = _plain, True
    try:
        yield
    finally:
        _plain = prev


def _runs_plain(name, t) -> bool:
    if _plain or t.device.type == "cpu":
        return True
    if t.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {t.device}")
    return False


def _round_up(x, m):
    return ((x + m - 1) // m) * m


def _ptr(t):
    return ctypes.c_void_p(t.data_ptr())


def _check_cuda(name, *ts):
    for t in ts:
        if t.device.type != "cuda" or t.dtype != torch.float32:
            raise ValueError(f"{name}: expects float32 CUDA tensors")
        if not t.is_contiguous():
            raise ValueError(f"{name}: expects contiguous tensors")


# ---------------------------------------------------------------------------
# Coarse column-inverse solve
# ---------------------------------------------------------------------------


def _coarse_solve_plain(dyT, dxT, Lv):
    """gdT[n, x, w] = dxT[n, x, y*] with w = y* + dyT[n, x, y*]: SOLVE_ITERS
    fixed-point lerps along the lanes, then the dxT lookup. Every
    (all rows, 128 lanes) block of a field takes its own band."""
    N, R, Lp = dyT.shape
    wpos = torch.arange(Lp, dtype=torch.float32, device=dyT.device)
    wpos = wpos.expand(N * R, Lp)
    dy = dyT.reshape(N * R, Lp)
    d = torch.zeros_like(wpos)
    for _ in range(SOLVE_ITERS):
        d = banded_lerp(dy, wpos - d, R, COARSE_SCAN, Lv, clamp_oob=True)
    out = banded_lerp(dxT.reshape(N * R, Lp), wpos - d, R, COARSE_SCAN, Lv,
                      clamp_oob=True)
    return out.reshape(N, R, Lp)


def coarse_solve_inputs(D):
    """The solve's inputs for displacement fields ``D`` (N, Hd, Wd, 2) in
    pixels (any strides): the COARSE-strided y and x planes, transposed,
    scaled to lattice units (y only) and zero-padded to 128 lanes, ``(dyT,
    dxT)`` (N, Wd/COARSE, Lp); and ``Lv`` = Hd/COARSE, the valid lanes."""
    Hc = D.shape[1] // COARSE
    Dc = D[:, ::COARSE, ::COARSE]
    pad = (0, _round_up(Hc, 128) - Hc)
    # * (1/COARSE): the stride is a power of two, so the product is exact.
    dyT = torch.nn.functional.pad(
        Dc[..., 1].transpose(1, 2) * (1.0 / COARSE), pad).contiguous()
    dxT = torch.nn.functional.pad(Dc[..., 0].transpose(1, 2), pad).contiguous()
    return dyT, dxT, Hc


def _stream(t):
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def coarse_gdisp_plain(D):
    """The plain version of :func:`coarse_gdisp_batch`: the solve on the
    planes of :func:`coarse_solve_inputs`, then two ``_upsample2``."""
    dyT, dxT, Hc = coarse_solve_inputs(D)
    gd = _coarse_solve_plain(dyT, dxT, Hc)[..., :Hc].transpose(1, 2)
    for _ in range(COARSE.bit_length() - 1):
        gd = _upsample2(gd)
    return gd


def coarse_gdisp_batch(D):
    """Column-inverse-corrected pass-1 x-displacement of a batch of
    displacement fields ``D`` (N, Hd, Wd, 2) in pixels (any strides):
    gdisp(x, w) = D_x(x, y*), w = y* + D_y(x, y*). Solved on the
    COARSE-strided transposed lattice, then upsampled x2 per octave.
    Returns (N, Hd, Wd) f32.

    A CUDA ``D`` (float32) launches the solve (``coarse_solve_kernel``, or
    ``coarse_solve_wide_kernel`` for Wd over 4096), which reads the solve's
    planes straight from ``D`` and writes the coarse result (N, Hd/4,
    Wd/4), then ``upsample4_kernel``; each launch counts in
    ``coarse_gdisp_batch.launches``, and the two output allocations are its
    only PyTorch calls (the wide solve keeps its iterate in the fine
    output, which the upsample then overwrites). A CPU ``D`` runs
    :func:`coarse_gdisp_plain`."""
    if _runs_plain("coarse_gdisp_batch", D):
        return coarse_gdisp_plain(D)
    from ..ops._build import load_fields_library

    N, Hd, Wd, C = D.shape
    if D.dtype != torch.float32 or C != 2 or Hd % COARSE or Wd % COARSE:
        raise ValueError("coarse_gdisp_batch: expects float32 (N, Hd, Wd, 2) "
                         f"with Hd and Wd multiples of {COARSE}")
    Hc, Wc = Hd // COARSE, Wd // COARSE
    gd = torch.empty((N, Hc, Wc), dtype=torch.float32, device=D.device)
    out = torch.empty((N, Hd, Wd), dtype=torch.float32, device=D.device)
    lib = load_fields_library()
    stream = _stream(D)
    err = lib.flowgen_coarse_solve(
        _ptr(D), *D.stride(), 1.0 / COARSE, _ptr(gd), _ptr(out), N, Hc, Wc,
        SOLVE_ITERS, COARSE_SCAN, stream)
    if err != 0:
        raise RuntimeError(f"coarse_solve kernel launch failed: CUDA error {err}")
    coarse_gdisp_batch.launches += 1
    err = lib.flowgen_upsample4(_ptr(gd), _ptr(out), N, Hc, Wc, stream)
    if err != 0:
        raise RuntimeError(f"upsample4 kernel launch failed: CUDA error {err}")
    coarse_gdisp_batch.launches += 1
    return out


coarse_gdisp_batch.launches = 0


# ---------------------------------------------------------------------------
# Row-tiled horizontal warp
# ---------------------------------------------------------------------------


def _row_tile(rows: int) -> int:
    return 256 if rows % 256 == 0 else 128


def hwarp_rows_plain(planes, disp):
    """out[m, c, r, x] = lerp of row planes[m, c, r] at x + disp[m, r, x],
    clamped to the row (the JAX ``_hwarp_kernel`` over the stacked
    (M*C*R, Sp) rows, row_tile x 128 blocks with their bands)."""
    M, C, R, Sp = planes.shape
    G = M * C * R
    xs = torch.arange(Sp, dtype=torch.float32, device=planes.device)
    u = (xs + disp[:, None]).expand(M, C, R, Sp).reshape(G, Sp)
    out = banded_lerp(planes.reshape(G, Sp), u, _row_tile(G), HWARP_SCAN, Sp,
                      clamp_oob=True)
    return out.reshape(M, C, R, Sp)


def hwarp_rows(planes, disp):
    """Horizontal bounded-displacement warp of (M, C, R, Sp) row planes,
    the channels of field m sharing its displacement ``disp`` (M, R, Sp),
    |disp| <= 64 px, Sp a multiple of 128. The JAX package stacks the
    channels' rows and broadcasts the displacement (``_hwarp_rows`` on
    (M*C*R, Sp)); the kernel indexes the shared rows instead, with the same
    row_tile x 128 band blocks over the stacked rows, and lerps the C
    channel blocks of a field together where R is a multiple of row_tile
    (they share their positions, so their band). CUDA tensors launch
    ``hwarp_rows_kernel`` (counted in ``hwarp_rows.launches``); CPU tensors
    run the plain version."""
    M, C, R, Sp = planes.shape
    if Sp % 128 or (M * C * R) % 128:
        raise ValueError("hwarp_rows: rows and lanes must be multiples of 128")
    if _runs_plain("hwarp_rows", planes):
        return hwarp_rows_plain(planes, disp)
    from ..ops._build import load_fields_library

    _check_cuda("hwarp_rows", planes, disp)
    if tuple(disp.shape) != (M, R, Sp):
        raise ValueError(f"hwarp_rows: disp shape {tuple(disp.shape)}")
    out = torch.empty_like(planes)
    lib = load_fields_library()
    err = lib.flowgen_hwarp_rows(
        _ptr(planes), _ptr(disp), _ptr(out), M * C * R, Sp, C * R, R,
        _row_tile(M * C * R), HWARP_SCAN,
        ctypes.c_void_p(torch.cuda.current_stream(planes.device).cuda_stream),
    )
    if err != 0:
        raise RuntimeError(f"hwarp_rows kernel launch failed: CUDA error {err}")
    hwarp_rows.launches += 1
    return out


hwarp_rows.launches = 0


def _edge_pad2(x, S):
    """Replicate the last row and column of (..., s, s) out to (..., S, S)."""
    s = x.shape[-1]
    idx = torch.clamp(torch.arange(S, device=x.device), max=s - 1)
    return x[..., idx, :][..., idx]


def displace_planes_batch(srcs, gd, vd):
    """``out_mc(x, y) = src_mc(x + gd_m(x, y), y + vd_m(x, y))`` over
    (M, C, S, S) planes, positions clamped: ``hwarp_rows`` along x with the
    column-inverse-corrected ``gd`` (M, S, S), then again on the transposed
    planes with ``vd``. Sizes that are not multiples of 128 are edge-padded
    (exact: a clamp at the padded edge of a constant extension equals the
    clamp at the true edge)."""
    M, C, S = srcs.shape[0], srcs.shape[1], srcs.shape[2]
    Sp = _round_up(S, 128)
    if Sp != S:
        srcs, gd, vd = (_edge_pad2(t, Sp) for t in (srcs, gd, vd))
    tmp = hwarp_rows(srcs.contiguous(), gd.contiguous())
    outT = hwarp_rows(tmp.transpose(2, 3).contiguous(),
                      vd.transpose(1, 2).contiguous())
    return outT.transpose(2, 3)[:, :, :S, :S]


def self_compose_batch(f, iters):
    """``iters`` doublings of ``f <- f + f o (id + f)`` for M fields at once,
    ``f`` (M, 2, S, S) planes x, y. A pixel whose lookup leaves the field is
    frozen and flagged; flagged pixels are NaN at the end."""
    M, _, S, _ = f.shape
    ys = torch.arange(S, dtype=torch.float32, device=f.device)
    py, px = torch.meshgrid(ys, ys, indexing="ij")
    flagged = torch.zeros((M, S, S), dtype=torch.bool, device=f.device)

    def oob_of(f):
        tx = px + f[:, 0]
        ty = py + f[:, 1]
        return (tx < 0) | (tx >= S) | (ty < 0) | (ty >= S)

    for _ in range(iters):
        oob = oob_of(f)
        flagged = flagged | oob
        gd = coarse_gdisp_batch(f.permute(0, 2, 3, 1))
        lut = displace_planes_batch(f, gd, f[:, 1])
        f = torch.where(oob[:, None], f, f + lut)
    flagged = flagged | oob_of(f)
    return torch.where(flagged[:, None], torch.full_like(f, float("nan")), f)


def make_big_fields(grid, inverse, size):
    """Composed big fields of M directions (the JAX package's
    ``make_big_fields_pallas``): elementary fields on the half lattice,
    HALF_ITERS doublings there, x2 upsample, the remaining doublings at
    full size, ``clamp_near_zeros``. ``grid`` leaves (M, N), ``inverse``
    (M,) bool. Returns (M, 2, size, size) with NaN at flagged pixels."""
    from .fields import clamp_near_zeros, elementary_field

    half = size // 2
    f_h = elementary_field(grid, half, inverse, stride=2.0) * 0.5
    f_h = self_compose_batch(f_h, HALF_ITERS)
    f = 2.0 * _upsample2(torch.nan_to_num(f_h))
    out = self_compose_batch(f, COMPOSE_ITERS - HALF_ITERS)
    return clamp_near_zeros(out)
