"""Mode 9's "xla" warp bank stream against the JAX package on the CPU: the
quad-gather doublings (``fields.self_compose``), the big field
(``fields.make_big_field``), the gather solve (``generator._gdisp_xla``),
``bg_upscale``, ``make_warp_aux(use_pallas=False)`` and the whole
``make_bank_and_aux(impl="xla")`` at 128x96 (big field 384^2). None of it
involves Pallas. The JAX side is jitted, as its pipeline runs it; XLA:CPU
then contracts each bilinear lerp into an FMA, and the port restates them
with ``_fp.fma``, so the building blocks are compared bit for bit (NaN
where the JAX package has NaN). The whole bank is also held by the
repo's mode-9 bank gate (tools/check_pallas_tpu.py): NaN-mask mismatch
under 1e-4, median |d| < 1e-4 px, under 1e-3 of values with |d| > 0.01 px.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flowgen
import flowgen_torch
from flowgen.compose.render import WarpBank as JBank
from flowgen.ops.pallas_scene import BG_EY
from flowgen.random import streams as js
from flowgen.warpfields import fields as jf
from flowgen.warpfields import generator as jg
from flowgen_torch.interop import bank_from_numpy
from flowgen_torch.random import streams as ts
from flowgen_torch.warpfields import fields as tf
from flowgen_torch.warpfields import generator as tg

torch.set_num_threads(1)

W, H = 128, 96


def _cfgs(**kw):
    kw = dict(mode=9, batch_size=2, width=W, height=H, **kw)
    return flowgen.DataGenConfig(**kw), flowgen_torch.DataGenConfig(**kw)


def _bit_equal(got, want):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def _planes(a):
    """JAX (..., S, S, 2) fields as the port's (..., 2, S, S) planes."""
    return np.moveaxis(np.asarray(a), -1, -3)


def _smooth_field(seed, s, mag):
    """A sigma~50 px smooth field with |f| <= mag px, as
    tests/test_pallas_fields.py makes it."""
    grid = jf.sample_displacer_grid(js.root_key(seed), s)
    f = jf.elementary_field(grid, s, inverse=False)
    return np.asarray(f * (mag / jnp.maximum(jnp.max(jnp.abs(f)), 1e-9)))


@pytest.mark.parametrize("seed,mag", [(7, 0.25), (3, 2.0), (11, 6.0)])
def test_self_compose_bit_equal(seed, mag):
    f0 = _smooth_field(seed, 256, mag)
    want = jax.jit(lambda f: jf.self_compose(f, iters=5))(f0)
    got = tf.self_compose(torch.from_numpy(_planes(f0)[None].copy()), 5)[0]
    _bit_equal(got, _planes(want))
    assert 0.0 < np.isnan(np.asarray(want)).mean() < 0.5


def test_make_big_field_bit_equal():
    key = js.stream_key(js.root_key(3), js.Stream.WARP_FIELD, 0)
    flow, iflow = jax.jit(lambda k: jf.make_big_field(k, 384))(key)
    got = tf.make_big_field(
        ts.stream_key(ts.root_key(3), ts.Stream.WARP_FIELD, 0), 384)
    _bit_equal(got[0], _planes(flow))
    _bit_equal(got[1], _planes(iflow))
    assert 1.0 < float(np.nanmax(np.abs(np.asarray(flow)))) < 120.0


def test_separate_lerps_miss_the_jax_bits(monkeypatch):
    """Why the stream's lerps are FMAs: with a separate multiply and add
    each, the doublings and the gather solve miss the jitted JAX
    package's bits."""
    from flowgen_torch.ops import texture

    for mod, name in ((tf, "sample_bilinear_quad"), (tg, "sample_bilinear")):
        monkeypatch.setattr(mod, name, lambda *a, _f=getattr(texture, name),
                            **k: _f(*a, **{**k, "contract": False}))
    f0 = _smooth_field(3, 256, 2.0)
    want = _planes(jax.jit(lambda f: jf.self_compose(f, iters=5))(f0))
    got = tf.self_compose(torch.from_numpy(_planes(f0)[None].copy()), 5)[0]
    assert (got.numpy().view(np.int32) != want.view(np.int32)).sum() > 0
    iflow = np.nan_to_num(_bank().iflow[:6])
    want = np.asarray(jax.jit(lambda D: jg._gdisp_xla(D, 4, 4))(iflow))
    got = tg._gdisp_xla(torch.from_numpy(iflow), 4, 4).numpy()
    assert (got.view(np.int32) != want.view(np.int32)).sum() > 0


def _bank(seed=5):
    """A seeded xla-stream bank of the JAX package, carried across."""
    jc, _ = _cfgs(warp_bank_impl="xla")
    return jax.tree.map(np.asarray, jax.jit(
        functools.partial(jg.make_warp_bank, cfg=jc))(js.root_key(seed),
                                                      jnp.int32(0)))


def test_gdisp_xla_and_bg_upscale_bit_equal():
    bank = _bank()
    iflow = np.nan_to_num(bank.iflow[:6])
    want = jax.jit(lambda D: jg._gdisp_xla(D, 4, 4))(iflow)
    _bit_equal(tg._gdisp_xla(torch.from_numpy(iflow), 4, 4), want)
    want_bg = jax.jit(lambda D: jg.bg_upscale(D, BG_EY))(iflow)
    _bit_equal(tg.bg_upscale(torch.from_numpy(iflow), BG_EY), want_bg)


def test_make_warp_aux_bit_equal():
    bank = _bank()
    jb = JBank(*(jnp.asarray(a[:6]) for a in bank))
    obj, bg = jax.jit(lambda b: jg.make_warp_aux(b, use_pallas=False))(jb)
    got = tg.make_warp_aux(bank_from_numpy(jb), use_pallas=False)
    _bit_equal(got.obj, obj)
    _bit_equal(got.bg, bg)
    assert got.bg_band.dtype == torch.int32


@pytest.fixture(scope="module")
def xla_bank():
    jc, tc = _cfgs(warp_bank_impl="xla")
    bank, aux = jax.jit(functools.partial(jg.make_bank_and_aux, cfg=jc))(
        js.root_key(0), jnp.int32(0))
    got = tg.make_bank_and_aux(ts.root_key(0), 0, tc)
    return {"want": (jax.tree.map(np.asarray, bank),
                     tuple(np.asarray(a) for a in aux)), "got": got}


def _bank_gate(got, want):
    got = got.numpy()
    nan_g, nan_w = np.isnan(got), np.isnan(want)
    assert (nan_g != nan_w).mean() < 1e-4
    both = ~nan_g & ~nan_w
    d = np.abs(got - want)[both]
    assert np.median(d) < 1e-4
    assert (d > 0.01).mean() < 1e-3


@pytest.mark.parametrize("name", ["flow", "iflow", "obj", "bg"])
def test_make_bank_and_aux_meets_bank_gate(xla_bank, name):
    (jbank, (jobj, jbg)), (tbank, taux) = xla_bank["want"], xla_bank["got"]
    got = {"flow": tbank.flow, "iflow": tbank.iflow, "obj": taux.obj,
           "bg": taux.bg}[name]
    want = {"flow": jbank.flow, "iflow": jbank.iflow, "obj": jobj,
            "bg": jbg}[name]
    assert got.shape == want.shape
    _bank_gate(got, want)
    _bit_equal(got, want)


def test_default_stream_is_pallas_and_xla_differs():
    """The stream is the config's, never the device's: the default bank
    equals ``impl="pallas"`` bit for bit, and ``"xla"`` is another
    stream."""
    _, tc = _cfgs()
    root = ts.root_key(5)
    default = tg.make_warp_bank(root, 0, tc)
    _bit_equal(default.flow, tg.make_warp_bank(root, 0, tc, impl="pallas").flow)
    xla = tg.make_warp_bank(root, 0, tc, impl="xla")
    d = (torch.nan_to_num(xla.flow) - torch.nan_to_num(default.flow)).abs()
    assert float(d.max()) > 0.0
    with pytest.raises(ValueError, match="stream"):
        tg.make_warp_bank(root, 0, tc, impl="triton")


def test_bank_cache_keys_on_stream():
    """Two configurations that differ only in warp_bank_impl never share a
    cached bank epoch."""
    from flowgen_torch.pipeline.generator import BankEpochCache

    built = []

    def build(root, step):
        built.append(step)
        return len(built)

    a = BankEpochCache(build, 2, "pallas")
    b = BankEpochCache(build, 2, "xla")
    assert a.get(0, 0) == 1 and b.get(0, 0) == 2
    assert a.get(0, 1) == 1 and b.get(0, 1) == 2
    assert a._epoch(1) != b._epoch(1)
