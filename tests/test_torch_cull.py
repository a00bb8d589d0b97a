"""The facts behind object_window's culls (flowgen_torch/csrc/window.cu), on
the plain arithmetic that the kernel repeats bit for bit:

* an edge's exact-area term (the loop body of ``ops/window.py:
  _area_accumulate``) is exactly 0 for every cell whose row lies a pixel or
  more beyond the edge's y-span, and for every cell a pixel or more right of
  the edge's largest x (the kernel cuts 2 px out);
* a pixel's sum over the edges that survive those culls, taken in edge
  order, equals the dense sum bit for bit;
* an ellipse's chord coverage (the window kernel's ellipse form) is 0 for
  every cell ``ELL_CULL_M`` px beyond its extent, in rows (the TPU kernel's
  row cull) and in columns, while the ellipse is no more than
  ``ELL_CULL_ANISO`` times longer than wide; a needle's reaches further.

Edges and ellipses are seeded with numpy and include horizontal edges,
|dy| = 2e-12, vertical edges, endpoints on whole and half rows and long
edges."""

import numpy as np
import pytest
import torch

from flowgen_torch.ops import affine, window
from flowgen_torch.ops.scene import ELL_CULL_M, ELL_R_MAX

torch.set_num_threads(1)

MARGIN = 1.0   # the facts hold from 1 px; csrc/window.cu cuts from 2 px


def _edges(rng):
    """(n, 4) float32 edges [ax, ay, bx, by] of every awkward kind."""
    e = []
    for _ in range(24):                       # random, some long
        a = rng.uniform(-40, 140, 2)
        e.append([*a, *(a + rng.normal(0, rng.choice([3.0, 40.0, 400.0]), 2))])
    for y in (10.0, 10.5, 33.25, 64.0):       # horizontal, on whole/half rows
        x = rng.uniform(0, 60)
        e.append([x, y, x + rng.uniform(5, 70), y])
        e.append([x + 30, y, x - 12.5, y])
    for dy in (2e-12, -2e-12, 5e-7):          # barely not horizontal
        x, y = rng.uniform(0, 80, 2)
        e.append([x, y, x + 37.0, y + dy])
    for x in (20.0, 20.5, 71.75):             # vertical
        y = rng.uniform(0, 40)
        e.append([x, y, x, y + rng.uniform(3, 60)])
        e.append([x, y + 50, x, y - 7.5])
    for _ in range(12):                       # endpoints on whole / half rows
        ay, by = (np.floor(rng.uniform(-5, 90, 2) * 2) / 2)
        e.append([rng.uniform(0, 100), ay, rng.uniform(0, 100), by])
    return np.asarray(e, np.float32)


def _cells(x0=-48, y0=-48, w=256, h=192):
    """Cell centres (1, h, w) over a grid that extends past every edge."""
    ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float32) + y0,
                            torch.arange(w, dtype=torch.float32) + x0,
                            indexing="ij")
    return (xs + 0.5)[None], (ys + 0.5)[None]


def _term(e, cx, cy):
    """One edge's term at every cell (the dense loop with one edge)."""
    t = torch.from_numpy(e)[None, :, None]
    return window._area_accumulate(t[:, 0], t[:, 1], t[:, 2], t[:, 3],
                                   torch.ones(1, dtype=torch.int32), cx, cy)


def _skipped(e, cx, cy):
    """Cells the culls skip for edge ``e``: rows MARGIN beyond its y-span,
    columns MARGIN right of it (cell lower-left corners xlo, ylo)."""
    ax, ay, bx, by = (float(v) for v in e)
    xlo, ylo = cx - 0.5, cy - 0.5
    return ((ylo >= max(ay, by) + MARGIN) | (ylo + 1.0 <= min(ay, by) - MARGIN)
            | (xlo >= max(ax, bx) + MARGIN))


def test_skipped_edge_terms_are_zero():
    edges = _edges(np.random.default_rng(0))
    cx, cy = _cells()
    n_skipped = 0
    for e in edges:
        term = _term(e, cx, cy)
        skip = _skipped(e, cx, cy)
        assert bool((term[skip] == 0).all()), f"edge {e.tolist()}"
        n_skipped += int(skip.sum())
        # The rows the edge spans and the cells left of it are not all 0.
        if abs(float(e[3] - e[1])) > 1.0:
            assert bool((term[~skip] != 0).any())
    assert n_skipped > 0.5 * len(edges) * cx.numel()


@pytest.mark.parametrize("seed", [1, 2])
def test_culled_sum_in_order_equals_dense(seed):
    """Outlines (a closed star and the awkward edges as one list) summed
    over the surviving terms in edge order equal the dense sum bit for
    bit."""
    rng = np.random.default_rng(seed)
    ang = np.sort(rng.uniform(0, 2 * np.pi, 120))
    r = rng.uniform(10, 70, 120)
    pts = np.stack([40 + r * np.cos(ang), 50 + r * np.sin(ang)], -1)
    star = np.concatenate([pts, np.roll(pts, -1, 0)], -1).astype(np.float32)
    cx, cy = _cells()
    for edges in (star, _edges(rng)):
        t = torch.from_numpy(edges).T[None]                 # (1, 4, n)
        dense = window._area_accumulate(
            t[:, 0], t[:, 1], t[:, 2], t[:, 3],
            torch.tensor([len(edges)], dtype=torch.int32), cx, cy)
        area = torch.zeros_like(cx)
        for e in edges:
            keep = ~_skipped(e, cx, cy)
            area = torch.where(keep, area + _term(e, cx, cy), area)
        assert torch.equal(area.view(torch.int32), dense.view(torch.int32))
        assert not bool((torch.signbit(area) & (area == 0)).any())


def _ellipse_window(rng, aniso):
    """One ellipse window's tables (edges, meta, fmeta) in the kernel's
    layout, rotated, scaled and ``aniso`` times longer than wide on screen,
    with its exact screen centre and half extents (float64)."""
    C, E = 7, 120
    edges = np.zeros((1, 4, C * E), np.float32)
    meta = np.zeros((1, 3 + 3 * C), np.int32)
    meta[0, 0] = meta[0, 3] = 1                   # one additive ellipse
    fmeta = np.zeros((1, 6 + 8 * C), np.float32)
    th = rng.uniform(0, np.pi)
    s = rng.uniform(0.4, 1.6)
    c, si = np.cos(th), np.sin(th)
    tr = np.array([[s * c, -s * si, rng.uniform(-20, 120)],
                   [s * si, s * c, rng.uniform(-20, 120)]], np.float32)
    r = rng.uniform(3, 250)
    rx, ry = np.float32([r, r / aniso] if rng.uniform() < 0.5
                        else [r / aniso, r])
    fmeta[0, 6:12] = affine.invert(torch.from_numpy(tr)).numpy().reshape(-1)
    fmeta[0, 12:14] = rx, ry
    trd = tr.astype(np.float64)
    lin = trd[:, :2] * np.array([rx, ry], np.float64)
    assert np.sqrt((lin ** 2).sum()) < ELL_R_MAX
    hx, hy = np.sqrt((lin ** 2).sum(1))
    return (edges, meta, fmeta), trd[:, 2], (hx, hy)


def _beyond(tabs, centre, half):
    """Coverage of the window's ellipse over a grid reaching 20 px past its
    extent, and how far beyond the extent each cell lies (in rows or
    columns, whichever is further; negative inside)."""
    (cx, cy), (hx, hy) = centre, half
    x0, y0 = int(np.floor(cx - hx)) - 20, int(np.floor(cy - hy)) - 20
    w, h = int(2 * hx) + 42, int(2 * hy) + 42
    ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float32) + y0,
                            torch.arange(w, dtype=torch.float32) + x0,
                            indexing="ij")
    aa, _ = window._window_coverage(*(torch.from_numpy(t) for t in tabs),
                                    xs[None], ys[None])
    xlo, ylo = xs.double().numpy(), ys.double().numpy()
    dist = np.maximum.reduce([ylo - (cy + hy), (cy - hy) - (ylo + 1),
                              xlo - (cx + hx), (cx - hx) - (xlo + 1)])
    return aa[0].numpy(), dist


@pytest.mark.parametrize("aniso", [1.0, 2.0, window.ELL_CULL_ANISO])
def test_ellipse_coverage_is_zero_beyond_extent(aniso):
    """Within the culled axis ratios an ellipse covers nothing ELL_CULL_M
    px beyond its extent, in rows or in columns."""
    rng = np.random.default_rng(int(4 * aniso))
    for _ in range(16):
        tabs, centre, half = _ellipse_window(rng, aniso)
        aa, dist = _beyond(tabs, centre, half)
        assert (aa[dist >= ELL_CULL_M] == 0).all()
        assert (aa[dist < 0] > 0).any()


def test_needle_ellipse_reaches_beyond_the_margin():
    """A needle's chords reach further than ELL_CULL_M past its extent,
    which is why the kernel culls only ellipses within ELL_CULL_ANISO."""
    rng = np.random.default_rng(5)
    reach = 0.0
    for _ in range(8):
        aa, dist = _beyond(*_ellipse_window(rng, 128.0))
        reach = max(reach, float(dist[aa > 0].max()))
    assert reach > ELL_CULL_M
