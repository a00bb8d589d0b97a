"""Warp-field self-composition: the mode-9 bank producer's kernels and the
doubling loop around them (port of ``flowgen/warpfields/pallas_fields.py``).

Each big field is integrated 2^17-fold by binary doubling,
``f <- f + f o (id + f)``. The lookup ``f o (id + f)`` is a warp by a bounded
displacement, so it runs as two separable row passes (``hwarp_rows``, the
second on transposed planes), exact bilinear once pass 1 reads its
x-displacement at the row pass 2 will fetch. That column inverse is a
per-column fixed point ``w = y + f_y(x, y)``, solved on a 4x-coarse lattice
(``coarse_gdisp_batch``) and upsampled by interleaving.

The JAX module's public functions and their counterparts here (the port
keeps fields as (..., 2, S, S) planes x, y where the JAX package keeps
(..., S, S, 2)): ``coarse_gdisp_batch`` and ``coarse_gdisp`` (any
power-of-two stride and step count), ``displace_planes_batch``,
``displace_planes``, ``displace_plane``, ``self_compose_pallas_batch`` ->
``self_compose_batch``, ``self_compose_pallas`` -> ``self_compose``,
``make_big_fields_pallas`` -> ``make_big_fields_keyed`` (and
``make_big_fields`` on displacer grids), ``make_big_field_pallas`` ->
``make_big_field``.

Two wrappers of kernels, each with its plain PyTorch version beside it:

* ``coarse_gdisp_batch`` (TPU kernel: ``pallas_fields.py:_coarse_solve_kernel``
  via ``coarse_gdisp_batch``) -> ``csrc/fields.cu:coarse_solve_kernel``
  (the solve, reading D's strided coarse samples in place) and
  ``upsample4_kernel`` (the x4 upsample of the bank's stride 4;
  ``upsample2_kernel`` per octave at other strides), each launch counted
  in ``coarse_gdisp_batch.launches``;
* ``hwarp_rows`` -> ``csrc/fields.cu:hwarp_rows_kernel`` (TPU kernel:
  ``pallas_fields.py:_hwarp_kernel`` via ``_hwarp_rows``), counted in
  ``hwarp_rows.launches``.

A CUDA tensor launches the kernels; a CPU tensor runs the plain version.
Inside ``with plain_versions():`` the plain versions run on any device:
the kernel-vs-plain comparisons on the card use it. The bank's third
kernel, ``fields.elementary_field``, follows the same rule (``_runs_plain``). Both read their taps
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
SOLVE_MAX_ITER = 2 * 0xFFFF   # csrc/fields.cu:kSolveMaxIter (16-bit step tags)


def coarse_scan(stride: int) -> int:
    """Band width in 128-lane tiles of the solve at lattice ``stride``:
    |disp| <= 64 px is 64 / stride lattice steps (the JAX kernel's rule)."""
    return int((2 * 64.0 / stride + 131) // 128) + 1


# Band widths in 128-lane tiles for |disp| <= 64 px.
COARSE_SCAN = coarse_scan(COARSE)
HWARP_SCAN = int((2 * 64.0 + 131) // 128) + 1

_plain = False


@contextlib.contextmanager
def plain_versions():
    """Inside the block the bank kernels' wrappers (here and
    ``fields.elementary_field``) run their plain versions on any device
    (the kernel-vs-plain comparisons on the card)."""
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


def _coarse_solve_plain(dyT, dxT, Lv, n_iter=SOLVE_ITERS, scan=COARSE_SCAN):
    """gdT[n, x, w] = dxT[n, x, y*] with w = y* + dyT[n, x, y*]: ``n_iter``
    fixed-point lerps along the lanes, then the dxT lookup. Every
    (all rows, 128 lanes) block of a field takes its own band of ``scan``
    tiles."""
    N, R, Lp = dyT.shape
    wpos = torch.arange(Lp, dtype=torch.float32, device=dyT.device)
    wpos = wpos.expand(N * R, Lp)
    dy = dyT.reshape(N * R, Lp)
    d = torch.zeros_like(wpos)
    for _ in range(n_iter):
        d = banded_lerp(dy, wpos - d, R, scan, Lv, clamp_oob=True)
    out = banded_lerp(dxT.reshape(N * R, Lp), wpos - d, R, scan, Lv,
                      clamp_oob=True)
    return out.reshape(N, R, Lp)


def _check_stride(D, stride):
    if stride <= 0 or stride & (stride - 1):
        raise ValueError(f"coarse_gdisp_batch: stride {stride} is not a "
                         "power of two")
    if D.shape[1] % stride or D.shape[2] % stride:
        raise ValueError(f"coarse_gdisp_batch: Hd and Wd must be multiples "
                         f"of the stride {stride}; got {tuple(D.shape)}")


def coarse_solve_inputs(D, stride=COARSE):
    """The solve's inputs for displacement fields ``D`` (N, Hd, Wd, 2) in
    pixels (any strides): the ``stride``-strided y and x planes, transposed,
    scaled to lattice units (y only) and zero-padded to 128 lanes, ``(dyT,
    dxT)`` (N, Wd/stride, Lp); and ``Lv`` = Hd/stride, the valid lanes."""
    Hc = D.shape[1] // stride
    Dc = D[:, ::stride, ::stride]
    pad = (0, _round_up(Hc, 128) - Hc)
    # * (1/stride): the stride is a power of two, so the product is exact.
    dyT = torch.nn.functional.pad(
        Dc[..., 1].transpose(1, 2) * (1.0 / stride), pad).contiguous()
    dxT = torch.nn.functional.pad(Dc[..., 0].transpose(1, 2), pad).contiguous()
    return dyT, dxT, Hc


def _stream(t):
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def coarse_gdisp_plain(D, stride=COARSE, n_iter=SOLVE_ITERS):
    """The plain version of :func:`coarse_gdisp_batch`: the solve on the
    planes of :func:`coarse_solve_inputs`, then log2(stride)
    ``_upsample2``."""
    _check_stride(D, stride)
    dyT, dxT, Hc = coarse_solve_inputs(D, stride)
    gd = _coarse_solve_plain(dyT, dxT, Hc, n_iter, coarse_scan(stride))
    gd = gd[..., :Hc].transpose(1, 2)
    for _ in range(stride.bit_length() - 1):
        gd = _upsample2(gd)
    return gd


def coarse_gdisp_batch(D, stride=COARSE, n_iter=SOLVE_ITERS):
    """Column-inverse-corrected pass-1 x-displacement of a batch of
    displacement fields ``D`` (N, Hd, Wd, 2) in pixels (any strides):
    gdisp(x, w) = D_x(x, y*), w = y* + D_y(x, y*). Solved by ``n_iter``
    fixed-point steps on the transposed lattice of power-of-two ``stride``
    (a divisor of Hd and Wd), then upsampled x2 per octave. Returns (N, Hd,
    Wd) f32: the JAX package's ``pallas_fields.coarse_gdisp_batch(D,
    stride, n_iter)``, in the same layout.

    A CUDA ``D`` (float32) launches the solve (``coarse_solve_kernel``, or
    ``coarse_solve_wide_kernel`` past 1024 coarse rows), which reads the
    solve's planes straight from ``D`` and writes the coarse result (N,
    Hd/stride, Wd/stride), then the upsample: ``upsample4_kernel`` at the
    bank's stride 4, else log2(stride) launches of ``upsample2_kernel``
    (none at stride 1, where the solve writes the output). Each launch
    counts in ``coarse_gdisp_batch.launches``; the output allocations are
    its only PyTorch calls (the wide solve keeps its iterate in the fine
    output where it fits beside the coarse result, else in a buffer of the
    size ``flowgen_coarse_scratch_floats`` gives). The kernels take at most
    ``SOLVE_MAX_ITER`` steps and coarse lattices under 65536 rows. A CPU
    ``D`` runs :func:`coarse_gdisp_plain`."""
    _check_stride(D, stride)
    if _runs_plain("coarse_gdisp_batch", D):
        return coarse_gdisp_plain(D, stride, n_iter)
    from ..ops._build import load_fields_library

    N, Hd, Wd, C = D.shape
    if D.dtype != torch.float32 or C != 2:
        raise ValueError("coarse_gdisp_batch: expects float32 (N, Hd, Wd, 2)")
    Hc, Wc = Hd // stride, Wd // stride
    if not 0 <= n_iter <= SOLVE_MAX_ITER or Hc > 0xFFFF:
        raise ValueError(f"coarse_gdisp_batch: the kernels take 0 to "
                         f"{SOLVE_MAX_ITER} steps and under 65536 coarse "
                         f"rows; got {n_iter} and {Hc}")
    levels = stride.bit_length() - 1
    dev = D.device
    out = torch.empty((N, Hd, Wd), dtype=torch.float32, device=dev)
    gd = (out if levels == 0 else
          torch.empty((N, Hc, Wc), dtype=torch.float32, device=dev))
    lib = load_fields_library()
    # The wide solve's iterate: in the fine output where it fits beside gd.
    need = lib.flowgen_coarse_scratch_floats(N, Hc, Wc, coarse_scan(stride))
    scratch = (out if need == 0 or (levels and need <= out.numel()) else
               torch.empty(need, dtype=torch.float32, device=dev))
    stream = _stream(D)
    err = lib.flowgen_coarse_solve(
        _ptr(D), *D.stride(), stride, _ptr(gd), _ptr(scratch), scratch.numel(),
        N, Hc, Wc, n_iter, coarse_scan(stride), stream)
    if err != 0:
        raise RuntimeError(f"coarse_solve kernel launch failed: CUDA error {err}")
    coarse_gdisp_batch.launches += 1
    if levels == 2:
        err = lib.flowgen_upsample4(_ptr(gd), _ptr(out), N, Hc, Wc, stream)
        if err != 0:
            raise RuntimeError(f"upsample4 kernel launch failed: CUDA error {err}")
        coarse_gdisp_batch.launches += 1
        return out
    for k in range(levels):
        h, w = Hc << k, Wc << k
        dst = (out if k == levels - 1 else
               torch.empty((N, 2 * h, 2 * w), dtype=torch.float32, device=dev))
        err = lib.flowgen_upsample2(_ptr(gd), _ptr(dst), N, h, w, stream)
        if err != 0:
            raise RuntimeError(f"upsample2 kernel launch failed: CUDA error {err}")
        coarse_gdisp_batch.launches += 1
        gd = dst
    return out


coarse_gdisp_batch.launches = 0


def coarse_gdisp(D, stride=COARSE, n_iter=SOLVE_ITERS):
    """:func:`coarse_gdisp_batch` of one field ``D`` (S, S, 2) (or (Hd, Wd,
    2)): returns (Hd, Wd), as the JAX package's ``coarse_gdisp``."""
    return coarse_gdisp_batch(D[None], stride, n_iter)[0]


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


def displace_planes(srcs, gd, vd):
    """:func:`displace_planes_batch` of one field: ``srcs`` (C, S, S),
    ``gd`` and ``vd`` (S, S). Returns (C, S, S), the JAX package's
    ``displace_planes`` in the same layout."""
    return displace_planes_batch(srcs[None], gd[None], vd[None])[0]


def displace_plane(src, gd, vd):
    """:func:`displace_planes` of one (S, S) plane, the JAX package's
    ``displace_plane``."""
    return displace_planes(src[None], gd, vd)[0]


def self_compose(field, iters):
    """:func:`self_compose_batch` of one field (2, S, S) planes x, y (the
    JAX package's ``self_compose_pallas`` of an (S, S, 2) field is this of
    ``field.permute(2, 0, 1)``, permuted back)."""
    return self_compose_batch(field[None], iters)[0]


def compose_big_fields(f_h, coarse_iters: int = HALF_ITERS):
    """The doublings of :func:`make_big_fields`: ``coarse_iters`` of them on
    the half-lattice elementary fields ``f_h`` (M, 2, size/2, size/2), x2
    upsample, the remaining ``COMPOSE_ITERS - coarse_iters`` at full size,
    ``clamp_near_zeros``. Returns (M, 2, size, size) with NaN at flagged
    pixels."""
    from .fields import clamp_near_zeros

    f_h = self_compose_batch(f_h, coarse_iters)
    f = 2.0 * _upsample2(torch.nan_to_num(f_h))
    out = self_compose_batch(f, COMPOSE_ITERS - coarse_iters)
    return clamp_near_zeros(out)


def make_big_fields(grid, inverse, size, coarse_iters: int = HALF_ITERS):
    """Composed big fields of M directions (the JAX package's
    ``make_big_fields_pallas`` on grids): elementary fields on the half
    lattice, then :func:`compose_big_fields`. ``grid`` leaves (M, N),
    ``inverse`` (M,) bool. Returns (M, 2, size, size) with NaN at flagged
    pixels."""
    from .fields import elementary_field

    f_h = elementary_field(grid, size // 2, inverse, stride=2.0) * 0.5
    return compose_big_fields(f_h, coarse_iters)


def make_big_fields_keyed(keys, size, coarse_iters: int = HALF_ITERS):
    """The JAX package's ``make_big_fields_pallas(keys, size,
    coarse_iters)``: each key's displacer grid (``fields.
    sample_displacer_grid``), its flow and inverse flow composed together
    through shared launches. ``keys``: threefry keys of
    ``random/streams.py`` (a sequence, or a (F, 2) tensor). Returns (flow,
    iflow), each (F, 2, size, size) planes x, y with NaN at flagged pixels
    (the JAX layout (F, size, size, 2) is ``.permute(0, 2, 3, 1)``)."""
    from .fields import sample_displacer_grid, stack_grids

    grids, flags = [], []
    for key in keys:
        g = sample_displacer_grid(key, size)
        grids += [g, g]
        flags += [False, True]
    out = make_big_fields(*stack_grids(grids, flags), size, coarse_iters)
    return out[0::2], out[1::2]


def make_big_field(key, size, coarse_iters: int = HALF_ITERS):
    """One key's ``(flow, iflow)``, each (2, size, size): the JAX package's
    ``make_big_field_pallas``."""
    flow, iflow = make_big_fields_keyed([key], size, coarse_iters)
    return flow[0], iflow[0]
