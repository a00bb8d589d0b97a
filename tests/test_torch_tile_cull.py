"""The staging culls of the redesigned CUDA kernels, restated in PyTorch and
held to the dense sums they stand for, bit for bit:

* the scene kernel (flowgen_torch/csrc/scene.cu:stage_unit_edges) stages,
  per 8x32 CTA tile and work unit, the edges that pass the TPU kernel's own
  culls (not left of the window; row blocks meeting the tile's) and
  coverage.cuh's exact row and column culls (kEdgeMargin) against the box
  of the cells it evaluates; each pixel then repeats the row-block test per
  edge. Over every tile of sampler scenes at 128x96 in modes 7 and 13 the
  culled in-order sums equal the plain version's (ops/scene.py:_poly_area);
* for a deforming frame-1 unit (mode 9) the cells are the pixels' taps on
  the expanded window, and the box is the tile's measured taps: with
  displacements past WARP_D = 48 px the culled sums still equal the plain
  ones, while a box that trusted WARP_D would drop non-zero terms;
* polygon_coverage (csrc/window.cu) closes the outline itself, boxes each
  8x32 tile of any grid, stages the surviving edges and culls again per
  point: on regular and jittered grids, with n_edges = E and with 3 edges,
  its sums equal the dense ones, and the plain version agrees with the JAX
  package's kernel (interpret mode) on a jittered grid.

Sums start at +0 and skipped terms are +-0, so a culled sum is never -0."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flowgen_torch
from flowgen.ops.pallas_raster import polygon_coverage_pallas
from flowgen_torch.compose import fused
from flowgen_torch.ops import scene as ps
from flowgen_torch.ops import window
from flowgen_torch.params.sampler import sample_scene_batch
from flowgen_torch.pipeline.generator import make_slab_packer
from flowgen_torch.random.streams import root_key

torch.set_num_threads(1)

MARGIN = 2.0          # coverage.cuh:kEdgeMargin
TILE_H, TILE_W = 8, 32
F32 = torch.float32


def _cuts(ax, ay, bx, by):
    """coverage.cuh:edge_record's culls: (xcut, ylc, yhc), never cut for an
    edge with an endpoint that is not finite."""
    fin = (torch.isfinite(ax) & torch.isfinite(ay) & torch.isfinite(bx)
           & torch.isfinite(by))
    inf = torch.tensor(float("inf"))
    xcut = torch.where(fin, torch.maximum(ax, bx) + MARGIN, inf)
    ylc = torch.where(fin, torch.minimum(ay, by) - MARGIN, -inf)
    yhc = torch.where(fin, torch.maximum(ay, by) + MARGIN, inf)
    return xcut, ylc, yhc


def _box_keep(cuts, xlo, ylo, yhi):
    """edge_rows_live and edge_cols_live against a box of cells: lower-left
    x at least ``xlo``, rows in [ylo, yhi] (lowest lower-left, highest
    upper corner)."""
    xcut, ylc, yhc = cuts
    return ~((ylo >= yhc) | (yhi <= ylc)) & ~(xlo >= xcut)


def _terms(e, cx, cy):
    """Each edge's term (rows of ``e`` (n, 4)) at cell centres ``cx``, ``cy``
    (any shape): the dense loop body, one edge at a time."""
    one = torch.ones(1, dtype=torch.int32)
    return torch.stack([
        window._area_accumulate(e[i, 0].view(1, 1), e[i, 1].view(1, 1),
                                e[i, 2].view(1, 1), e[i, 3].view(1, 1), one,
                                cx[None], cy[None])[0]
        for i in range(e.shape[0])])


def _in_order(terms, keep):
    """Sum from +0 in edge order of the terms ``keep`` lets through."""
    area = torch.zeros(terms.shape[1:], dtype=F32)
    for t, k in zip(terms, keep):
        area = torch.where(k, area + t, area)
    return area


def _row_blocks(ay, by, oy, wh):
    """The TPU kernel's row blocks [rb0, rb1) of each edge on a window of wh
    rows at frame row oy (scene.cu:stage_unit_edges, ops/scene.py:
    _poly_area)."""
    oyf = torch.tensor(float(oy), dtype=F32)
    rlo = torch.floor(torch.minimum(ay, by) - oyf).long() - 1
    rhi = torch.floor(torch.maximum(ay, by) - oyf).long()
    rb0 = torch.clamp(rlo, 0, wh) >> 3
    rb1 = torch.clamp((torch.clamp(rhi, -1, wh - 1) >> 3) + 1, max=wh // 8)
    return rb0, rb1


def _bits_equal(a, b):
    return torch.equal(a.contiguous().view(torch.int32),
                       b.contiguous().view(torch.int32))


# ---------------------------------------------------------------------------
# The scene kernel, rigid units (modes 7 and 13)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", [7, 13])
def test_scene_tile_staging_is_exact(mode):
    """Every (unit, 8x32 tile) pair of sampler scenes at 128x96: the staged
    edges, summed in order with the per-pixel row-block test, give the plain
    version's area at every owned pixel, bit for bit."""
    H, W, B = 96, 128, 2
    cfg = flowgen_torch.DataGenConfig(mode=mode, batch_size=B, width=W,
                                      height=H)
    dev = torch.device("cpu")
    slabs = make_slab_packer(cfg, dev)(
        flowgen_torch.procedural_atlas(3, height=H, width=W))
    scenes = sample_scene_batch(root_key(0, dev), torch.arange(B), cfg)
    args, _ = fused.scene_tables(scenes, cfg, *slabs)
    omi, tmi, edges, wl, nu = args[1], args[3], args[6], args[9], args[10]
    K = omi.shape[1]
    wh, ww = min(ps.WIN_H, H), min(ps.WIN_W, W)
    n_pairs = n_dropped = 0
    for b in range(B):
        for fr in (0, 1):
            for j in range(int(nu[b, fr])):
                k, t = divmod(int(wl[b, fr * K * ps.MAX_TILES + j]),
                              ps.MAX_TILES)
                tm = [int(v) for v in tmi[b, k, fr, t]]
                y0w, x0w = tm[0] & ~7, tm[1] & ~127
                oy0, oy1, ox0, ox1 = tm[2:6]
                om = omi[b, k, fr]
                er = edges[b, k, fr]
                ys = torch.arange(oy0, oy1)
                xs = torch.arange(ox0, ox1)
                if not len(ys) or not len(xs):
                    continue
                yy, xx = torch.meshgrid(ys, xs, indexing="ij")
                # The tile of each owned pixel and its box of owned cells.
                tiles = (yy // TILE_H) * (W // TILE_W) + xx // TILE_W
                rb = (yy - y0w) >> 3
                for c in range(int(om[ps.OMI_NPRIMS])):
                    if not (int(om[ps.OMI_POLY_BITS]) >> c) & 1:
                        continue
                    ne = int(om[ps.OMI_NEDGES + c])
                    e = er[:, c * 120: c * 120 + ne].T.contiguous()
                    ax, ay, bx, by = e.unbind(1)
                    cuts = _cuts(ax, ay, bx, by)
                    rb0, rb1 = _row_blocks(ay, by, y0w, wh)
                    left = torch.maximum(ax, bx) >= float(x0w)
                    keep = torch.zeros((ne,) + yy.shape, dtype=torch.bool)
                    for tile in tiles.unique():
                        sel = tiles == tile
                        r0, r1 = int(yy[sel].min()), int(yy[sel].max())
                        c0 = int(xx[sel].min())
                        cb0, cb1 = (r0 - y0w) >> 3, (r1 - y0w) >> 3
                        kt = (left & (rb0 <= cb1) & (cb0 < rb1)
                              & _box_keep(cuts, float(c0), float(r0),
                                          float(r1) + 1.0))
                        keep[:, sel] = kt[:, None]
                        n_pairs += ne
                        n_dropped += int((~kt).sum())
                    blocks = (rb[None] >= rb0[:, None, None]) & (
                        rb[None] < rb1[:, None, None])
                    terms = _terms(e, xx.to(F32) + 0.5, yy.to(F32) + 0.5)
                    culled = _in_order(terms, keep & blocks)
                    plain = ps._poly_area(er.tolist(), c * 120, ne, y0w, x0w,
                                          wh, ww, dev)
                    want = plain[oy0 - y0w: oy1 - y0w, ox0 - x0w: ox1 - x0w]
                    assert _bits_equal(culled, want), (b, fr, k, t, c)
                    assert not bool((torch.signbit(culled) & (culled == 0))
                                    .any())
    assert n_pairs > 0 and n_dropped > 0.5 * n_pairs


# ---------------------------------------------------------------------------
# The scene kernel, a deforming frame-1 unit (mode 9)
# ---------------------------------------------------------------------------


def _warp_tap(u, n):
    """warp.cuh:warp_tap: clipped lerp indices of positions ``u``."""
    uc = torch.clamp(u, 0.0, float(n - 1))
    i0 = torch.floor(uc).long()
    return i0, torch.clamp(i0 + 1, max=n - 1)


def test_warp_tap_staging_is_exact_past_warp_d():
    """A deforming unit at 512x384 displaced by up to 65 px (the bank's
    seed-0 epoch reaches 64.93): each tile's box is its pixels' taps on the
    expanded window; the culled sums at every tap equal the plain version's
    expanded-window coverage, and a box taken from WARP_D would have dropped
    non-zero terms."""
    H, W = 384, 512
    geo = ps._warp_geometry(H, W)
    whE, wwE = geo["whE"], geo["wwE"]
    rng = np.random.default_rng(9)
    y0w, x0w = 96, 128
    ey0 = min(max(y0w - ps.WARP_EY, 0), H - whE) & ~7
    ex0 = min(max(x0w - ps.WARP_EX, 0), W - wwE)
    # A 120-edge star around the window's centre, and the edge table.
    ang = np.sort(rng.uniform(0, 2 * np.pi, 120))
    r = rng.uniform(40, 110, 120)
    pts = np.stack([256 + 1.4 * r * np.cos(ang), 192 + r * np.sin(ang)], -1)
    e = torch.from_numpy(np.concatenate([pts, np.roll(pts, -1, 0)], -1)
                         .astype(np.float32))
    ax, ay, bx, by = e.unbind(1)
    # Smooth displacement planes reaching +-65 px.
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float64)
    ph = rng.uniform(0, 2 * np.pi, 4)
    gdp = torch.from_numpy((65.0 * np.sin(xx / 37.0 + ph[0])
                            * np.cos(yy / 53.0 + ph[1])).astype(np.float32))
    vdp = torch.from_numpy((65.0 * np.cos(xx / 41.0 + ph[2])
                            * np.sin(yy / 29.0 + ph[3])).astype(np.float32))
    # The owned pixels: the window's tiles, the pixels' taps (warp_taps).
    ys, xs = torch.meshgrid(torch.arange(y0w, y0w + 192),
                            torch.arange(x0w, x0w + 256), indexing="ij")
    tv0, tv1 = _warp_tap((ys.to(F32) + vdp[ys, xs]) - float(ey0), whE)
    taps = []
    for wi in (tv0, tv1):
        gd = gdp[ey0 + wi, xs]
        c0, c1 = _warp_tap((xs.to(F32) + gd) - float(ex0), wwE)
        taps += [(wi, c0), (wi, c1)]
    rows = torch.stack([t[0] for t in taps])          # (4, 192, 256)
    cols = torch.stack([t[1] for t in taps])
    assert float(vdp.abs().max()) > ps.WARP_D
    tiles = ((ys - y0w) // TILE_H) * (256 // TILE_W) + (xs - x0w) // TILE_W
    cuts = _cuts(ax, ay, bx, by)
    rb0, rb1 = _row_blocks(ay, by, ey0, whE)
    left = torch.maximum(ax, bx) >= float(ex0)
    keep = torch.zeros((120, 4) + ys.shape, dtype=torch.bool)
    trusted = torch.zeros_like(keep)
    for tile in range(tiles.max() + 1):
        sel = tiles == tile
        lo, hi = int(rows[:, sel].min()), int(rows[:, sel].max())
        cl = int(cols[:, sel].min())
        kt = (left & (rb0 <= hi >> 3) & ((lo >> 3) < rb1)
              & _box_keep(cuts, float(cl) + ex0, float(lo) + ey0,
                          float(hi) + ey0 + 1.0))
        keep[:, :, sel] = kt[:, None, None]
        # The box WARP_D would give: the tile's pixels +- 48 px.
        py0, py1 = int(ys[sel].min()), int(ys[sel].max())
        px0 = int(xs[sel].min())
        tl = max(py0 - ps.WARP_D - ey0, 0)
        th = min(py1 + ps.WARP_D - ey0, whE - 1)
        tc = max(px0 - ps.WARP_D - ex0, 0)
        kd = (left & (rb0 <= th >> 3) & ((tl >> 3) < rb1)
              & _box_keep(cuts, float(tc) + ex0, float(tl) + ey0,
                          float(th) + ey0 + 1.0))
        trusted[:, :, sel] = kd[:, None, None]
    rbt = rows >> 3
    blocks = (rbt[None] >= rb0.view(-1, 1, 1, 1)) & (
        rbt[None] < rb1.view(-1, 1, 1, 1)) & left.view(-1, 1, 1, 1)
    terms = _terms(e, (cols + ex0).to(F32) + 0.5, (rows + ey0).to(F32) + 0.5)
    culled = _in_order(terms, keep & blocks)
    plain = ps._poly_area(e.T.tolist(), 0, 120, ey0, ex0, whE, wwE,
                          torch.device("cpu"))
    assert _bits_equal(culled, plain[rows, cols])
    assert not bool((torch.signbit(culled) & (culled == 0)).any())
    assert int((~keep & blocks).sum()) > 0
    assert bool(((terms != 0) & blocks & ~trusted).any())


# ---------------------------------------------------------------------------
# polygon_coverage
# ---------------------------------------------------------------------------


def _outline(rng, n, E=120):
    ang = np.sort(rng.uniform(0, 2 * np.pi, n))
    r = rng.uniform(9.0, 30.0, n)
    pts = np.stack([70 + 1.5 * r * np.cos(ang), 20 + r * np.sin(ang)], -1)
    pad = rng.uniform(-500, 500, (E - n, 2))          # slots past n_edges
    return np.concatenate([pts, pad]).astype(np.float32)


def _closed_in_kernel(pts, ne):
    """window.cu:polygon_coverage_kernel's closing rule: edge e from point e
    to point e + 1, edge ne - 1 back to point 0."""
    nxt = [i + 1 if i + 1 < ne else 0 for i in range(ne)]
    return torch.cat([pts[:ne], pts[nxt]], 1)         # (ne, 4)


def _grid(kind, rng, h=40, w=150):
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    px, py = xs + 0.5 - 3.0, ys + 0.5
    if kind == "jittered":
        px = px + rng.uniform(-0.45, 0.45, px.shape).astype(np.float32)
        py = py + rng.uniform(-0.45, 0.45, py.shape).astype(np.float32)
    return torch.from_numpy(px), torch.from_numpy(py)


@pytest.mark.parametrize("kind", ["regular", "jittered"])
@pytest.mark.parametrize("n", [120, 3])
def test_polygon_coverage_tile_staging_is_exact(kind, n):
    """Tile boxes from the points themselves, staged edges, per-point culls:
    the sums equal the dense sum over the plain version's closed table, and
    so do its outputs."""
    rng = np.random.default_rng(n + (kind == "jittered"))
    pts = torch.from_numpy(_outline(rng, n))
    px, py = _grid(kind, rng)
    h, w = px.shape
    closed = window._closed_edges(pts[None], torch.tensor([n]))[0]
    e = _closed_in_kernel(pts, n)
    assert _bits_equal(e, closed[:, :n].T)
    ax, ay, bx, by = e.unbind(1)
    cuts = _cuts(ax, ay, bx, by)
    xlo, ylo = px - 0.5, py - 0.5
    keep = torch.zeros((n, h, w), dtype=torch.bool)
    for i0 in range(0, h, TILE_H):
        for j0 in range(0, w, TILE_W):
            tl = (slice(i0, i0 + TILE_H), slice(j0, j0 + TILE_W))
            kt = _box_keep(cuts, float(xlo[tl].min()), float(ylo[tl].min()),
                           float(ylo[tl].max()) + 1.0)
            keep[(slice(None),) + tl] = kt[:, None, None]
    xcut, ylc, yhc = cuts
    per_point = ~((ylo[None] >= yhc.view(-1, 1, 1))
                  | (ylo[None] + 1.0 <= ylc.view(-1, 1, 1))
                  | (xlo[None] >= xcut.view(-1, 1, 1)))
    culled = _in_order(_terms(e, px, py), keep & per_point)
    dense = window._area_accumulate(*(closed[None, i] for i in range(4)),
                                    torch.tensor([n]), px[None], py[None])[0]
    assert _bits_equal(culled, dense)
    assert int((~keep).sum()) > 0
    aa, inside = window.polygon_coverage_plain(pts[None], torch.tensor([n]),
                                               px[None], py[None])
    a = culled.abs()
    assert _bits_equal(torch.minimum(a, torch.ones_like(a)), aa[0])
    assert torch.equal(a >= 0.5, inside[0])
    assert 0 < float(inside.float().mean()) < 1


def test_polygon_coverage_jittered_grid_matches_jax():
    """The plain version (which the kernel equals bit for bit on the card)
    against polygon_coverage_pallas in interpret mode on a jittered grid,
    n_edges = E: coverage within 1e-5 (XLA:CPU may contract an FMA), masks
    equal."""
    rng = np.random.default_rng(7)
    pts = _outline(rng, 120)
    px, py = (t.numpy() for t in _grid("jittered", rng, h=32, w=128))
    want_aa, want_in = polygon_coverage_pallas(
        jnp.asarray(pts), jnp.int32(120), jnp.asarray(px), jnp.asarray(py),
        interpret=True)
    aa, inside = window.polygon_coverage_plain(
        torch.from_numpy(pts), 120, torch.from_numpy(px), torch.from_numpy(py))
    np.testing.assert_array_equal(inside.numpy(), np.asarray(want_in))
    np.testing.assert_allclose(aa.numpy(), np.asarray(want_aa), atol=1e-5)
