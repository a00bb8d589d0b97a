"""The plain versions of the windowed renderer's kernels (flowgen_torch/ops/
window.py) against the JAX package's Pallas kernels in interpret mode
(flowgen/ops/pallas_raster.py), on seeded inputs:

* ``polygon_coverage`` on the square, padded star and full-slot outlines of
  tests/test_pallas_raster.py, and on a batch of seeded outlines;
* ``object_window`` on seeded windows of additive and subtractive polygons
  and ellipses, with ``use_aa`` and ``emit_flow`` on and off.

Both sides evaluate the same expressions in float32; XLA:CPU may contract a
product and a sum into an FMA inside the interpret-mode kernel, so the
coverage is held to 1e-5, the binary masks equal, the blended images to
1 level on under 1% of values and the flow to the flow gate. The CUDA
wrappers refuse CPU tensors."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flowgen.ops import raster as jraster
from flowgen.ops.pallas_raster import object_window_pallas, polygon_coverage_pallas
from flowgen_torch.ops import window

torch.set_num_threads(1)

C, E = 7, 120


def _grid(w, h, x0=0.0, y0=0.0):
    px, py = jraster.pixel_grid(w, h)
    return np.asarray(px) + x0, np.asarray(py) + y0


def _compare_coverage(pts, n_edges, w=128, h=32):
    px, py = _grid(w, h)
    want_aa, want_in = polygon_coverage_pallas(
        jnp.asarray(pts), jnp.int32(n_edges), jnp.asarray(px),
        jnp.asarray(py), interpret=True)
    aa, inside = window.polygon_coverage_plain(
        torch.from_numpy(pts), n_edges, torch.from_numpy(px),
        torch.from_numpy(py))
    assert inside.dtype == torch.bool
    np.testing.assert_array_equal(inside.numpy(), np.asarray(want_in))
    np.testing.assert_allclose(aa.numpy(), np.asarray(want_aa), atol=1e-5)
    assert 0 < inside.float().mean() < 1


def _star(rng, n, cx=64.0, cy=16.0, r0=5.0, r1=14.0):
    ang = np.sort(rng.uniform(0, 2 * np.pi, n))
    r = rng.uniform(r0, r1, n)
    return np.stack([cx + r * np.cos(ang), cy + r * np.sin(ang)],
                    -1).astype(np.float32)


def test_square():
    sq = np.array([[20.0, 5.0], [60.0, 5.0], [60.0, 25.0], [20.0, 25.0]],
                  np.float32)
    _compare_coverage(np.concatenate([sq, np.tile(sq[:1], (12, 1))]), 4)


def test_padded_star():
    pts = _star(np.random.default_rng(1), 9)
    _compare_coverage(np.concatenate([pts, np.tile(pts[:1], (23, 1))]), 9)


def test_full_slots():
    """No padding: the closing edge back to point 0 is forced."""
    _compare_coverage(_star(np.random.default_rng(2), 16, r0=6.0), 16)


def test_batched_coverage_matches_single():
    """A batch of outlines, each over its own grid, equals the calls one by
    one (the renderer's batched form)."""
    rng = np.random.default_rng(3)
    pts, ne, pxs, pys = [], [], [], []
    for i, n in enumerate((5, 40, 120)):
        p = _star(rng, n)
        pts.append(np.concatenate([p, np.tile(p[:1], (E - n, 1))]))
        ne.append(n)
        px, py = _grid(128, 32, x0=0.5 * i, y0=-0.25 * i)
        pxs.append(px)
        pys.append(py)
    T = torch.from_numpy
    aa, inside = window.polygon_coverage_plain(
        T(np.stack(pts)), T(np.array(ne, np.int32)), T(np.stack(pxs)),
        T(np.stack(pys)))
    for i in range(3):
        a, b = window.polygon_coverage_plain(T(pts[i]), ne[i], T(pxs[i]),
                                             T(pys[i]))
        np.testing.assert_array_equal(aa[i].numpy(), a.numpy())
        np.testing.assert_array_equal(inside[i].numpy(), b.numpy())


def _tables(rng, x0, y0, wh, ww):
    """One window's (edges, meta, fmeta): an additive star, a subtractive
    ellipse, an additive rotated ellipse and a subtractive star, placed
    over the window at (x0, y0)."""
    cx, cy = x0 + ww / 2, y0 + wh / 2
    pts = np.zeros((C, E, 2), np.float32)
    n_edges = np.zeros(C, np.int32)
    is_poly = np.array([1, 0, 0, 1, 0, 0, 0], np.int32)
    additive = np.array([1, 0, 1, 0, 1, 1, 1], np.int32)
    for c, (n, r0, r1, dx) in ((0, (60, 8.0, 30.0, -20.0)),
                               (3, (7, 3.0, 9.0, 30.0))):
        p = _star(rng, n, cx + dx, cy, r0, r1)
        pts[c, :n] = p
        pts[c, n:] = p[0]
        n_edges[c] = n
    b = np.roll(pts, -1, axis=1)
    edges = np.stack([pts[..., 0], pts[..., 1], b[..., 0], b[..., 1]],
                     0).reshape(4, C * E)
    ell = np.zeros((C, 8), np.float32)
    ell[:, 0] = ell[:, 4] = ell[:, 6] = ell[:, 7] = 1.0
    for c, (ex, ey, rx, ry, th) in ((1, (cx - 15, cy + 2, 9.0, 5.0, 0.0)),
                                    (2, (cx + 20, cy - 3, 14.0, 6.0, 0.7))):
        # Inverse of rotate(th) then translate(ex, ey).
        co, si = np.cos(th), np.sin(th)
        ell[c, :6] = [co, si, -(co * ex + si * ey),
                      -si, co, si * ex - co * ey]
        ell[c, 6:] = rx, ry
    motion = np.array([1.02, -0.05, 3.5, 0.04, 0.97, -2.25], np.float32)
    meta = np.concatenate([[4, x0, y0], additive, is_poly, n_edges]).astype(
        np.int32)
    fmeta = np.concatenate([motion, ell.reshape(-1)]).astype(np.float32)
    return edges.astype(np.float32), meta, fmeta


WINDOWS = [(37, 11, 32, 128), (0, 0, 32, 128), (90, 40, 32, 128)]


@pytest.mark.parametrize("use_aa", [True, False])
@pytest.mark.parametrize("emit_flow", [True, False])
def test_object_window_matches_interpret_kernel(use_aa, emit_flow):
    rng = np.random.default_rng(11)
    tabs = [_tables(rng, *w) for w in WINDOWS]
    wh, ww = WINDOWS[0][2:]
    n = len(WINDOWS)
    tex = rng.uniform(0, 255, (n, wh, ww, 3)).astype(np.float32)
    frame = np.round(rng.uniform(0, 255, (n, wh, ww, 3))).astype(np.float32)
    flow = rng.normal(0, 2, (n, wh, ww, 2)).astype(np.float32)
    T = torch.from_numpy
    got_f, got_fl = window.object_window_plain(
        *(T(np.stack(t)) for t in zip(*tabs)), T(tex), T(frame), T(flow),
        use_aa=use_aa, emit_flow=emit_flow)
    for i, (e, m, f) in enumerate(tabs):
        want_f, want_fl = (np.asarray(a) for a in object_window_pallas(
            *(jnp.asarray(a) for a in (e, m, f, tex[i], frame[i], flow[i])),
            use_aa=use_aa, emit_flow=emit_flow, interpret=True))
        d = np.abs(got_f[i].numpy() - want_f)
        assert d.max() <= 1.0 and (d >= 1).mean() < 0.01
        assert (got_f[i].numpy() != frame[i]).any()
        dfl = np.abs(got_fl[i].numpy() - want_fl)
        assert np.median(dfl) < 1e-4 and (dfl > 0.01).mean() < 1e-3
        if not emit_flow:
            np.testing.assert_array_equal(got_fl[i].numpy(), flow[i])
        else:
            assert (got_fl[i].numpy() != flow[i]).any()


def test_cuda_wrappers_refuse_cpu_tensors():
    """The CUDA launch paths take CUDA tensors only: the public wrappers
    run the plain versions on the CPU and nowhere fall back."""
    pts = torch.zeros((1, E, 2))
    px = torch.zeros((1, 4, 4))
    with pytest.raises(ValueError, match="CUDA"):
        window._polygon_coverage_cuda(pts, torch.ones(1, dtype=torch.int32),
                                      px, px)
    e, m, f = (torch.from_numpy(np.stack([a])) for a in
               _tables(np.random.default_rng(0), 0, 0, 32, 128))
    win = torch.tensor([[0, 32, 128, 0]], dtype=torch.int32)
    frames = torch.zeros((1, 32, 128, 3))
    with pytest.raises(ValueError, match="CUDA"):
        window._object_window_cuda(
            e, m, f, win, frames, torch.zeros((1, 32, 128, 2)),
            torch.zeros((1, 64, 256, 12), dtype=torch.uint8),
            crop=(16, 64, 32, 128), sampled=False, use_aa=True,
            emit_flow=True, max_hw=(32, 128))
