"""Exact-area coverage in the PyTorch port against flowgen.ops.raster on
sampled shapes: per-edge cell areas, polygon coverage and the ellipse chord
coverage agree to 1e-6."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flowgen.ops import affine as jaff
from flowgen.ops import raster as jr
from flowgen_torch.ops import affine as taff
from flowgen_torch.ops import raster as tr

torch.set_num_threads(1)


def _grid(h=40, w=56, x0=-8.0, y0=-6.0):
    ys = np.arange(h, dtype=np.float32) + np.float32(y0 + 0.5)
    xs = np.arange(w, dtype=np.float32) + np.float32(x0 + 0.5)
    py, px = np.meshgrid(ys, xs, indexing="ij")
    return px, py


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_edge_cell_area_matches(seed):
    rng = np.random.default_rng(seed)
    px, py = _grid()
    e = rng.uniform(-12, 52, (64, 4)).astype(np.float32)
    e[::7, 2] = e[::7, 0]          # vertical edges
    e[::9, 3] = e[::9, 1]          # horizontal edges
    for ax, ay, bx, by in e:
        a = np.asarray(jr.edge_cell_area(ax, ay, bx, by, jnp.asarray(px),
                                         jnp.asarray(py)))
        b = tr.edge_cell_area(torch.tensor(ax), torch.tensor(ay),
                              torch.tensor(bx), torch.tensor(by),
                              torch.from_numpy(px), torch.from_numpy(py)).numpy()
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-6)


@pytest.mark.parametrize("seed", [0, 1])
def test_polygon_coverage_matches(seed):
    rng = np.random.default_rng(seed)
    px, py = _grid()
    n = 40
    ang = np.sort(rng.uniform(0, 2 * np.pi, n))
    r = rng.uniform(6, 22, n)
    pts = np.stack([20 + r * np.cos(ang), 14 + r * np.sin(ang)], -1)
    pts = pts.astype(np.float32)
    ja, ji = jr.polygon_coverage(jnp.asarray(pts), jnp.asarray(px),
                                 jnp.asarray(py))
    ta, ti = tr.polygon_coverage(torch.from_numpy(pts), torch.from_numpy(px),
                                 torch.from_numpy(py))
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=0, atol=1e-6)
    # The binary mask may only differ where the area sits on 0.5.
    flip = ta.numpy().astype(bool) != np.asarray(ja).astype(bool)
    assert (ti.numpy() != np.asarray(ji)).sum() <= int(flip.sum()) + 2


@pytest.mark.parametrize("rot,rx,ry", [
    (0.0, 30.0, 18.0), (0.4, 12.0, 25.0), (-1.1, 6.0, 5.0), (2.5, 45.0, 9.0),
])
def test_ellipse_chord_coverage_matches(rot, rx, ry):
    px, py = _grid(64, 96, -20.0, -16.0)
    jt = jaff.chain(jaff.rotation(rot), jaff.translation(21.3, 17.6))
    tt = taff.chain(taff.rotation(rot), taff.translation(21.3, 17.6))
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), atol=1e-6)
    ja, ji = jr.ellipse_coverage(jt, jnp.float32(rx), jnp.float32(ry),
                                 jnp.asarray(px), jnp.asarray(py))
    ta, ti = tr.ellipse_coverage(torch.from_numpy(np.asarray(jt)),
                                 torch.tensor(rx), torch.tensor(ry),
                                 torch.from_numpy(px), torch.from_numpy(py))
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=0, atol=1e-6)
    assert (ta.numpy() > 0).sum() > 50
    diff = ti.numpy() != np.asarray(ji)
    assert diff.sum() <= 2


def test_halfplanes3_matches():
    rng = np.random.default_rng(4)
    n = 5000
    th = rng.uniform(-np.pi, np.pi, n)
    args = []
    for dth in (0.0, 0.063, -0.063):
        args += [rng.uniform(-1.2, 1.2, n), np.cos(th + dth), np.sin(th + dth)]
    args = [a.astype(np.float32) for a in args]
    a = np.asarray(jr.halfplanes3_cell_coverage(*map(jnp.asarray, args)))
    b = tr.halfplanes3_cell_coverage(*map(torch.from_numpy, args)).numpy()
    np.testing.assert_allclose(b, a, rtol=0, atol=1e-6)
