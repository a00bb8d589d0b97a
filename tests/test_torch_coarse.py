"""The arithmetic of the redesigned coarse_gdisp_batch kernels
(flowgen_torch/csrc/fields.cu), restated in PyTorch and held to the plain
version bit for bit:

* upsample4_kernel (fine_block) writes each fine 4x4 block from its 2x2
  coarse neighbourhood (rows i, min(i + 1, h - 1), columns j, min(j + 1,
  w - 1)), through the first stage's 3x3 nodes and the rounded
  (a + b) * 0.5 steps of two _upsample2 stages: equal to
  _upsample2(_upsample2(gd)) on 1x1, 1xn, nx1, 48x48 and 96x96 planes
  holding +-0, subnormals and values whose sums overflow;
* coarse_solve_kernel reads the solve's planes straight from D's element
  strides (dyT[n, r, l] = D[n, 4l, 4r, 1] * 0.25, dxT from channel 0):
  equal to coarse_solve_inputs on the bank's permuted planes, a nan_to_num
  copy as the background gdisp takes it, contiguous, cropped and
  transposed views;
* the solve splits each (field, 128-lane tile) block over 16 CTAs, each
  a slab of rows, starts the first step's band at the tile's first lane,
  exchanges partial minima only where the band can move (more lane tiles
  than COARSE_SCAN), and reads taps from a staged window of the tile and a
  32-lane halo, else from D; slabs over 64 rows (fields over 4096 px wide)
  stage nothing and read every tap from D: equal to the plain solve, with
  band starts at tile 0 and 1, taps outside the halo, uneven and empty
  slabs, and the wide solve all occurring.

CPU only; a few seconds."""

import numpy as np
import pytest
import torch

from flowgen_torch.warpfields import compose as tcomp
from flowgen_torch.warpfields.fields import _upsample2

torch.set_num_threads(1)

F32 = torch.float32
HALO = 32             # fields.cu:kSolveHalo
SPLIT = 16            # fields.cu:kSolveSplit
MAX_ROWS = 64         # fields.cu:kSolveMaxRows


def _bits_equal(a, b):
    return torch.equal(a.contiguous().view(torch.int32),
                       b.contiguous().view(torch.int32))


def _mid(a, b):
    return (a + b) * 0.5


def _fine_blocks(c00, c01, c10, c11, i, j, h, w):
    """fields.cu:fine_block for coarse nodes (i, j) of an (h, w) plane (i
    and j broadcast against the c planes) from gd at rows i, i1 = min(i + 1,
    h - 1) and columns j, j1 = min(j + 1, w - 1): (..., 4, 4) fine values,
    [ry][rx] at fine (4i + ry, 4j + rx)."""

    def at(ii, jj):
        return torch.where(ii != i, torch.where(jj != j, c11, c10),
                           torch.where(jj != j, c01, c00))

    u = [[None] * 3 for _ in range(3)]
    for ka in range(3):
        a = torch.clamp(2 * i + ka, max=2 * h - 1)
        ia = a >> 1
        for kb in range(3):
            b = torch.clamp(2 * j + kb, max=2 * w - 1)
            jb = b >> 1

            def row(jj):
                v = at(ia, jj)
                return torch.where((a & 1) == 1,
                                   _mid(v, at(torch.clamp(ia + 1, max=h - 1), jj)), v)

            v = row(jb)
            u[ka][kb] = torch.where((b & 1) == 1,
                                    _mid(v, row(torch.clamp(jb + 1, max=w - 1))), v)
    fine = []
    for ry in range(4):
        ka = ry >> 1
        for rx in range(4):
            kb = rx >> 1

            def row2(k):
                return _mid(u[ka][k], u[ka + 1][k]) if ry & 1 else u[ka][k]

            r = row2(kb)
            fine.append(_mid(r, row2(kb + 1)) if rx & 1 else r)
    return torch.stack(fine, dim=-1).reshape(*fine[0].shape, 4, 4)


def _upsample4_restated(gd):
    """The fine blocks of every coarse node of gd (N, h, w), assembled."""
    N, h, w = gd.shape
    i = torch.arange(h)[:, None]
    j = torch.arange(w)[None, :]
    i1 = torch.clamp(i + 1, max=h - 1)
    j1 = torch.clamp(j + 1, max=w - 1)
    blocks = _fine_blocks(gd[:, i, j], gd[:, i, j1], gd[:, i1, j],
                          gd[:, i1, j1], i, j, h, w)          # (N, h, w, 4, 4)
    return blocks.permute(0, 1, 3, 2, 4).reshape(N, 4 * h, 4 * w)


def _values(rng, shape, huge=False):
    """Seeded values with exact +-0, subnormals and (``huge``) magnitudes
    whose pairwise sums overflow."""
    v = (rng.standard_normal(shape) * 30.0).astype(np.float32)
    pick = rng.random(shape)
    v[pick < 0.08] = 0.0
    v[(pick >= 0.08) & (pick < 0.16)] = -0.0
    sub = (pick >= 0.16) & (pick < 0.26)
    v[sub] = (rng.standard_normal(int(sub.sum())) * 1e-39).astype(np.float32)
    if huge:
        v[(pick >= 0.26) & (pick < 0.3)] = 3.0e38
    return torch.from_numpy(v)


@pytest.mark.parametrize("shape", [(1, 1, 1), (2, 1, 7), (2, 7, 1),
                                   (1, 48, 48), (2, 96, 96)])
def test_fused_upsample4_is_two_upsample2(shape):
    rng = np.random.default_rng(sum(shape))
    gd = _values(rng, shape, huge=shape[1] == 48)
    want = _upsample2(_upsample2(gd))
    got = _upsample4_restated(gd)
    assert got.shape == want.shape == (shape[0], 4 * shape[1], 4 * shape[2])
    assert _bits_equal(got, want)
    if shape[1] == 48:
        assert bool(torch.isinf(want).any())


def _planes_from_strides(D):
    """coarse_solve_kernel's reads (CoarseSrc): element n*sN + 4l*sH + 4r*sW
    (+ sC for y) of D's storage, y times 0.25; (dyT, dxT) (N, Wd/4, Hd/4)."""
    N, Hd, Wd, _ = D.shape
    sN, sH, sW, sC = D.stride()
    flat = torch.as_strided(D, (D.untyped_storage().nbytes() // 4,), (1,), 0)
    n = torch.arange(N)[:, None, None]
    r = torch.arange(Wd // 4)[None, :, None]
    lane = torch.arange(Hd // 4)[None, None, :]
    at = D.storage_offset() + n * sN + 4 * lane * sH + 4 * r * sW
    return flat[at + sC] * 0.25, flat[at]


def _layouts(rng, M, Hd, Wd):
    """D (M, Hd, Wd, 2) in the layouts the kernel meets and may meet."""
    f = _values(rng, (M, 2, Hd, Wd))
    f_nan = f.clone()
    f_nan[:, :, :: max(Hd // 3, 1), 1::3] = float("nan")
    big = _values(rng, (M, 2, Hd + 8, Wd + 12))
    sq = _values(rng, (M, 2, Wd, Hd))
    return {
        "bank": f.permute(0, 2, 3, 1),
        "nan_to_num": torch.nan_to_num(f_nan).permute(0, 2, 3, 1),
        "contiguous": f.permute(0, 2, 3, 1).contiguous(),
        "cropped": big[:, :, 4 : 4 + Hd, 8 : 8 + Wd].permute(0, 2, 3, 1),
        "transposed": sq.permute(0, 3, 2, 1),
    }


@pytest.mark.parametrize("hd,wd", [(4, 4), (4, 28), (28, 4), (192, 192),
                                   (384, 384)])
def test_solve_reads_planes_from_strides(hd, wd):
    rng = np.random.default_rng(hd * 1000 + wd)
    for name, D in _layouts(rng, 2, hd, wd).items():
        assert D.shape == (2, hd, wd, 2), name
        dyT, dxT, Lv = tcomp.coarse_solve_inputs(D)
        sy, sx = _planes_from_strides(D)
        assert Lv == hd // 4
        assert _bits_equal(sy, dyT[..., :Lv]), name
        assert _bits_equal(sx, dxT[..., :Lv]), name
        assert not bool(dyT[..., Lv:].any())


def _left_tap(u, Lv):
    return torch.floor(torch.clamp(u, 0.0, float(Lv - 1))).long()


def _solve_restated(D):
    """coarse_solve_kernel over each (field, tile) block: SPLIT slabs of
    rows, the first step's band from the tile's first lane, partial minima
    combined only where the band can move, taps from the staged window
    (tile and halo, within [0, Lv)) or else from the plane itself; with
    slabs over MAX_ROWS, coarse_solve_wide_kernel: nothing staged. Returns
    gd (N, Lv, R) and counts of what happened."""
    dyT, dxT, Lv = tcomp.coarse_solve_inputs(D)
    N, R, Lp = dyT.shape
    n_src = Lp // 128
    scan = min(tcomp.COARSE_SCAN, n_src)
    exchange = n_src > tcomp.COARSE_SCAN
    rows_cta = -(-R // SPLIT)
    wide = rows_cta > MAX_ROWS
    gd = torch.empty((N, Lv, R), dtype=F32)
    seen = {"tile0": set(), "outside_halo": 0, "exchanges": 0, "wide": wide,
            "slab_rows": {min(rows_cta, max(R - r0, 0))
                          for r0 in range(0, SPLIT * rows_cta, rows_cta)}}
    for n in range(N):
        for t in range(n_src):
            wpos = torch.arange(t * 128, t * 128 + 128, dtype=F32).expand(R, 128)
            wlo, whi = max(t * 128 - HALO, 0), min(t * 128 + 128 + HALO, Lv)
            if wide:
                wlo = whi = 0
            d = torch.zeros((R, 128), dtype=F32)
            for it in range(tcomp.SOLVE_ITERS + 1):
                bmin = t * 128
                if it > 0 and exchange:
                    seen["exchanges"] += 1
                    parts = [int(_left_tap(wpos[r0 : r0 + rows_cta] - d[r0 : r0 + rows_cta], Lv).min())
                             for r0 in range(0, R, rows_cta)]
                    bmin = min(parts)
                tile0 = max(min(bmin >> 7, n_src - scan), 0)
                seen["tile0"].add(tile0)
                lo, hi = tile0 * 128, tile0 * 128 + scan * 128
                src = (dxT if it == tcomp.SOLVE_ITERS else dyT)[n]
                staged = src[:, wlo:whi]
                uc = torch.clamp(wpos - d, 0.0, float(Lv - 1))
                uf = torch.floor(uc)
                fx = uc - uf
                u0 = uf.long()
                u1 = torch.clamp(u0 + 1, max=Lv - 1)

                def tap(u):
                    inside = (u >= wlo) & (u < whi)
                    band = (u >= lo) & (u < hi)
                    seen["outside_halo"] += int((band & ~inside).sum())
                    v = src.gather(1, u)
                    if whi > wlo:
                        v = torch.where(inside, staged.gather(
                            1, torch.clamp(u - wlo, 0, whi - wlo - 1)), v)
                    return torch.where(band, v, torch.zeros_like(v))

                p0, p1 = tap(u0), tap(u1)
                d = p0 + (p1 - p0) * fx
            lanes = min(Lv - t * 128, 128)
            gd[n, t * 128 : t * 128 + lanes] = d[:, :lanes].t()
    return gd, seen


def _wavy(rng, M, Hd, Wd, amp):
    """Smooth (M, Hd, Wd, 2) displacements up to ``amp`` px, the y channel
    of field 0 nowhere positive and of field 1 nowhere negative."""
    y = torch.arange(Hd, dtype=F32)[:, None]
    x = torch.arange(Wd, dtype=F32)[None, :]
    out = []
    for m in range(M):
        ph = torch.from_numpy(rng.random(3).astype(np.float32)) * 6.0
        bump = 0.5 - 0.5 * torch.cos(y * (6.2831855 / Hd) + ph[0])
        dy = amp * bump * (0.6 + 0.4 * torch.sin(x * 0.05 + ph[1]))
        dy = -dy if m % 2 == 0 else dy
        dx = amp * 0.7 * torch.sin(y * 0.004 + x * 0.07 + ph[2])
        out.append(torch.stack([dx, dy], dim=-1))
    return torch.stack(out)


@pytest.mark.parametrize("hd,wd,amp", [
    (96, 40, 20.0),          # one lane tile: no exchange
    (1536, 80, 60.0),        # three tiles: the band moves
    (1536, 148, 240.0),      # taps past the halo, uneven and empty slabs
    (1536, 4100, 60.0),      # slabs of 65 rows: the wide solve
])
def test_split_solve_equals_plain(hd, wd, amp):
    D = _wavy(np.random.default_rng(hd + wd), 2, hd, wd, amp)
    got, seen = _solve_restated(D)
    dyT, dxT, Lv = tcomp.coarse_solve_inputs(D)
    want = tcomp._coarse_solve_plain(dyT, dxT, Lv)[..., :Lv].transpose(1, 2)
    assert want.shape == got.shape == (2, hd // 4, wd // 4)
    assert _bits_equal(got, want)
    if hd == 1536:
        assert seen["tile0"] == {0, 1} and seen["exchanges"] > 0
    else:
        assert seen["exchanges"] == 0
    assert seen["wide"] == (wd > 4096)
    if wd == 148:
        assert seen["slab_rows"] == {3, 1, 0}
    if not seen["wide"]:
        assert (seen["outside_halo"] > 0) == (amp > 4 * HALO)
