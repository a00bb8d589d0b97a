"""The rest of the JAX package's public surface in the port, each function
held against its JAX twin on the same inputs (numpy, from a seed), on the
CPU. The JAX kernels run in Pallas interpret mode, jitted.
``tests/test_torch_coarse_strides.py`` holds ``warpfields/compose.py``'s
wrappers.

* ``warpfields/generator.py``: ``make_warp_aux`` and ``make_bank_and_aux``
  with ``n_iter=4, coarse=2`` in both bank streams: bit for bit;
* ``warpfields/fields.py``: ``constant_support``, ``gaussian1d_support``:
  bit for bit;
* ``ops/texture.py``: ``affine_warp``, ``randomized_crop``,
  ``warp_by_flow`` on one image, called eagerly as the JAX tests call
  them (nothing contracted): bit for bit;
* ``ops/raster.py``: ``halfplane_cell_coverage``: bit for bit;
* ``ops/resample.py``: ``affine_resample`` with band widths
  (``x_tiles_scan``, ``y_tiles_scan``) down to one tile, too narrow for
  the affine: the same taps read 0 (equal zero patterns), values within
  2e-2 (the interpret-mode kernel contracts its lerps, as
  tests/test_torch_resample.py states);
* ``texture_io``: ``native_loader_available`` (builds the loader);
* ``train/flownet.py``: ``init_params`` from a threefry key against flax's
  init of the JAX model: bit for bit.

About 35 s on one worker, a third of it flax's import and first init."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flowgen
import flowgen_torch
from flowgen.ops import affine as jaff
from flowgen.ops import pallas_resample as jres
from flowgen.ops import raster as jraster
from flowgen.ops import texture as jtex
from flowgen.random.streams import root_key as j_root
from flowgen.warpfields import fields as jfields
from flowgen.warpfields import generator as jg
from flowgen_torch.interop import bank_from_numpy
from flowgen_torch.ops import raster as traster
from flowgen_torch.ops import resample as tres
from flowgen_torch.ops import texture as ttex
from flowgen_torch.random.streams import root_key
from flowgen_torch.warpfields import fields as tfields
from flowgen_torch.warpfields import generator as tg

torch.set_num_threads(1)


def _bits(a):
    return np.ascontiguousarray(np.asarray(a), np.float32).view(np.int32)


def _assert_bits(got, want):
    got = got.numpy() if torch.is_tensor(got) else got
    np.testing.assert_array_equal(_bits(got), _bits(want))


# ---------------------------------------------------------------------------
# warpfields/generator.py
# ---------------------------------------------------------------------------

W, H, B = 128, 96, 2


def _cfgs(impl):
    kw = dict(mode=9, batch_size=B, width=W, height=H, warp_bank_impl=impl)
    return flowgen.DataGenConfig(**kw), flowgen_torch.DataGenConfig(**kw)


@pytest.mark.parametrize("impl", ["pallas", "xla"])
def test_make_bank_and_aux_n_iter_coarse(impl):
    jc, tc = _cfgs(impl)
    bank, (obj, bg) = jax.jit(lambda r: jg.make_bank_and_aux(
        r, 0, jc, n_iter=4, coarse=2))(j_root(1))
    tbank, aux = tg.make_bank_and_aux(root_key(1), 0, tc, n_iter=4, coarse=2)
    _assert_bits(tbank.flow, bank.flow)
    _assert_bits(tbank.iflow, bank.iflow)
    _assert_bits(aux.obj, obj)
    _assert_bits(aux.bg, bg)


@pytest.mark.parametrize("use_pallas", [True, False])
def test_make_warp_aux_n_iter_coarse(use_pallas):
    jc, _ = _cfgs("pallas")
    jb = jax.jit(lambda r: jg.make_warp_bank(r, 0, jc))(j_root(2))
    obj, bg = jax.jit(lambda b: jg.make_warp_aux(
        b, n_iter=4, coarse=2, use_pallas=use_pallas,
        interpret=use_pallas))(jb)
    aux = tg.make_warp_aux(bank_from_numpy(jax.tree.map(np.asarray, jb)),
                           n_iter=4, coarse=2, use_pallas=use_pallas)
    _assert_bits(aux.obj, obj)
    _assert_bits(aux.bg, bg)


# ---------------------------------------------------------------------------
# warpfields/fields.py, ops/raster.py, ops/texture.py
# ---------------------------------------------------------------------------


def test_supports():
    yy, xx = np.meshgrid(np.arange(64, dtype=np.float32),
                         np.arange(64, dtype=np.float32), indexing="ij")
    x, y = torch.from_numpy(xx), torch.from_numpy(yy)
    jx, jy = jnp.asarray(xx), jnp.asarray(yy)
    _assert_bits(tfields.constant_support(x, y, factor=0.75),
                 jfields.constant_support(jx, jy, factor=0.75))
    assert tfields.constant_support(x[:1], y[:, :1]).shape == (64, 64)
    for cx, cy, s in ((32.0, 32.0, 8.0), (10.5, 50.25, 20.0)):
        _assert_bits(tfields.gaussian1d_support(x, y, cx, cy, s),
                     jfields.gaussian1d_support(jx, jy, cx, cy, s))


def test_halfplane_cell_coverage():
    rng = np.random.default_rng(4)
    th = rng.uniform(-np.pi, np.pi, 4000).astype(np.float32)
    d = rng.uniform(-1.2, 1.2, 4000).astype(np.float32)
    nx, ny = np.cos(th), np.sin(th)
    nx[:8] = [1, 0, -1, 0, 0.6, 0.8, 1e-10, 1]
    ny[:8] = [0, 1, 0, -1, 0.8, -0.6, 1, 1e-10]
    want = jraster.halfplane_cell_coverage(*map(jnp.asarray, (d, nx, ny)))
    got = traster.halfplane_cell_coverage(*map(torch.from_numpy, (d, nx, ny)))
    _assert_bits(got, want)
    assert 0.0 in np.asarray(want) and 1.0 in np.asarray(want)


@pytest.fixture(scope="module")
def image():
    return np.random.default_rng(5).uniform(0, 255, (96, 128, 3)).astype(
        np.float32)


def test_affine_warp(image):
    t = np.array(jaff.chain(
        jaff.translation(3.5, -2.0),
        jaff.conjugate_about(jaff.rotation(0.3), 64.0, 48.0),
        jaff.scaling(1.2)))
    yy, xx = np.meshgrid(np.arange(96, dtype=np.float32),
                         np.arange(128, dtype=np.float32), indexing="ij")
    for wrap in ("reflect", "clamp", "zero"):
        want = jtex.affine_warp(jnp.asarray(image), jnp.asarray(t),
                                jnp.asarray(xx), jnp.asarray(yy), wrap=wrap)
        got = ttex.affine_warp(torch.from_numpy(image), torch.from_numpy(t),
                               torch.from_numpy(xx), torch.from_numpy(yy),
                               wrap=wrap)
        _assert_bits(got, want)


def test_randomized_crop(image):
    src = np.random.default_rng(6).uniform(0, 255, (200, 260, 3)).astype(
        np.float32)
    f = np.float32
    for ang, zoom, sx, sy in ((f(0.4), f(1.3), f(5), f(-7)),
                              (f(-0.9), f(0.8), f(0), f(12))):
        want = jtex.randomized_crop(jnp.asarray(src), 96, 128, ang, zoom, sx, sy)
        got = ttex.randomized_crop(torch.from_numpy(src), 96, 128, ang, zoom,
                                   sx, sy)
        assert got.shape == (96, 128, 3)
        _assert_bits(got, want)


def test_warp_by_flow(image):
    rng = np.random.default_rng(7)
    iflow = rng.uniform(-20, 20, (96, 128, 2)).astype(np.float32)
    iflow[rng.uniform(size=(96, 128)) < 0.05] = np.nan
    for wrap in ("zero", "reflect"):
        want = jtex.warp_by_flow(jnp.asarray(image), jnp.asarray(iflow), wrap)
        got = ttex.warp_by_flow(torch.from_numpy(image),
                                torch.from_numpy(iflow), wrap)
        _assert_bits(got, want)


# ---------------------------------------------------------------------------
# ops/resample.py: the standalone resampler's band widths
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def slabs():
    img = np.random.default_rng(8).integers(0, 256, (160, 256, 3)).astype(
        np.uint8)
    return (np.asarray(jres.pack_padded_slab(jnp.asarray(img), 32, 32)),
            tres.pack_padded_slab(torch.from_numpy(img), 32, 32))


@pytest.mark.parametrize("rot,zoom", [(0.0, 1.0), (35.0, 0.75), (-20.0, 0.85),
                                      (40.0, 0.6)])
def test_affine_resample_band_widths(slabs, rot, zoom):
    """Band widths of 1 to 4 tiles: where a tap falls outside its block's
    band, both read 0 (so the zero patterns are equal and every value stays
    within 2e-2, the interpret kernel's contraction)."""
    t = np.asarray(jaff.compose(jaff.chain(
        jaff.translation(2.0, 1.5),
        jaff.conjugate_about(jaff.rotation(np.deg2rad(rot)), 128.0, 80.0),
        jaff.scaling(1.0 / zoom)), jaff.translation(32.0, 32.0)))
    P = jres.max_row_span(64, 128, 0.7, 1.35)
    zeros_seen = 0
    for xs, ys in ((4, 4), (1, 1), (1, 4), (4, 1), (2, 1)):
        want = np.asarray(jres.affine_resample_pallas(
            jnp.asarray(slabs[0]), t, 4, 8, wh=64, ww=128, P=P,
            x_tiles_scan=xs, y_tiles_scan=ys, interpret=True))
        got = tres.affine_resample(slabs[1], torch.from_numpy(t.copy()), 4, 8,
                                   wh=64, ww=128, P=P, x_tiles_scan=xs,
                                   y_tiles_scan=ys).numpy()
        np.testing.assert_array_equal(got == 0, want == 0)
        np.testing.assert_allclose(got, want, rtol=0, atol=2e-2)
        zeros_seen += int((want == 0).sum())
    assert zeros_seen > 0


# ---------------------------------------------------------------------------
# texture_io, train/flownet.py
# ---------------------------------------------------------------------------


def test_native_loader_available():
    from flowgen_torch import texture_io
    from flowgen_torch.texture_io import native

    assert texture_io.native_loader_available is native.native_loader_available
    assert texture_io.native_loader_available() is True
    assert native.BUILD_INFO["path"]


@pytest.mark.parametrize("seed", [0, 7])
def test_init_params_is_flax_init(seed):
    from flowgen.train import flownet as jfn
    from flowgen_torch.interop import flownet_params_from_flax
    from flowgen_torch.train import flownet as tfn

    jp = jfn.init_params(jfn.create_model(8), jax.random.key(seed), 64, 64)
    want = flownet_params_from_flax(jax.tree.map(np.asarray, jp))
    model = tfn.create_model(8)
    got = tfn.init_params(model, root_key(seed), 64, 64)
    assert set(got) == set(want) == set(model.state_dict())
    for k in want:
        _assert_bits(got[k], want[k].numpy())
    model.load_state_dict(got)
