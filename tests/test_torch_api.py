"""The port's public API against the JAX package's on the CPU: the top-level
exports, the per-step mode mixture, ``render_sample`` and
``background_flow``, and the copies of ``utils/flow_io.py``,
``utils/metrics.py`` and ``pipeline/prototxt.py``, pinned to the originals
(files written by one read back by the other byte for byte, equal metrics,
equal configurations from ``examples/train.prototxt``)."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flowgen
import flowgen_torch
from flowgen.compose import render as jrender
from flowgen.params.sampler import sample_scene_batch as j_sample
from flowgen.pipeline import generator as jgen
from flowgen.pipeline import prototxt as jproto
from flowgen.random.streams import root_key as j_root
from flowgen.utils import flow_io as jio
from flowgen.utils import metrics as jmetrics
from flowgen_torch.compose import render as trender
from flowgen_torch.interop import scene_from_numpy
from flowgen_torch.pipeline import generator as tgen
from flowgen_torch.pipeline import prototxt as tproto
from flowgen_torch.utils import flow_io as tio
from flowgen_torch.utils import metrics as tmetrics

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W, H = 128, 96
def test_exports_match_jax():
    """Every name the JAX package exports, its sharding module's two
    included."""
    missing = set(flowgen.__all__) - set(flowgen_torch.__all__)
    assert missing == set()
    for name in flowgen.__all__:
        assert hasattr(flowgen_torch, name), name
    for name in ("KIND_COMPOSITE", "KIND_ELLIPSE", "KIND_POLYGON",
                 "MAX_COMPONENTS", "MAX_OBJECTS", "DEFAULT_HEIGHT",
                 "DEFAULT_WIDTH", "__version__"):
        assert getattr(flowgen_torch, name) == getattr(flowgen, name), name
    for name in ("Background", "Objects", "Primitives", "Scene",
                 "RenderOutput", "WarpBank"):
        assert (getattr(flowgen_torch, name)._fields
                == getattr(flowgen, name)._fields), name


def _ingredients(pkg, **kw):
    base = dict(batch_size=1, width=W, height=H, seed=4, **kw)
    return [pkg.DataGenConfig(mode=m, **base) for m in (1, 7, 3)]


def _picks(module, pkg, steps, weights):
    """The ingredient ``module.make_mixed_generate_fn`` calls at each step,
    with each ingredient's generating function replaced by its index."""
    real = module.make_generate_fn
    module.make_generate_fn = lambda cfg, *a: (
        lambda root, step, atlas, m=cfg.mode: m)
    try:
        fn = module.make_mixed_generate_fn(_ingredients(pkg), weights)
        return [fn(None, s, None) for s in steps]
    finally:
        module.make_generate_fn = real


@pytest.mark.parametrize("weights", [None, (0.2, 0.5, 0.3), (1, 0, 3)])
def test_mixed_picks_match_jax(weights):
    steps = list(range(64)) + [10**6, 2**31 - 1]
    got = _picks(tgen, flowgen_torch, steps, weights)
    assert got == _picks(jgen, flowgen, steps, weights)
    assert len(set(got)) == (2 if weights == (1, 0, 3) else 3)


def test_mixed_batches_and_signature_check():
    """The mixed stream returns the picked ingredient's own batch, bit for
    bit; ingredients of different output signatures raise as in JAX."""
    cfgs = _ingredients(flowgen_torch)
    atlas = flowgen_torch.procedural_atlas(2, height=H, width=W)
    fn = tgen.make_mixed_generate_fn(cfgs, device="cpu")
    for step in (0, 1):
        mode = _picks(tgen, flowgen_torch, [step], None)[0]
        cfg = next(c for c in cfgs if c.mode == mode)
        want = tgen.generate_batch(cfg.seed, step, atlas, cfg, device="cpu")
        got = fn(cfg.seed, step, atlas)
        for k in want:
            torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)
    bad = [cfgs[0], dataclasses.replace(cfgs[1], emit_masks=True)]
    with pytest.raises(ValueError) as tv:
        tgen.make_mixed_generate_fn(bad, device="cpu")
    with pytest.raises(ValueError) as jv:
        jgen.make_mixed_generate_fn(
            [flowgen.DataGenConfig(**dataclasses.asdict(c)) for c in bad])
    assert str(tv.value) == str(jv.value)
    with pytest.raises(ValueError, match="at least one"):
        tgen.make_mixed_generate_fn([], device="cpu")


def test_render_sample_is_render_batch_of_one():
    cfg = flowgen_torch.DataGenConfig(mode=7, batch_size=2, width=W, height=H,
                                      compute_inverse_flow=True,
                                      emit_masks=True)
    scenes = flowgen_torch.sample_scene_batch(
        flowgen_torch.pipeline.generator.root_key(3), torch.arange(2), cfg)
    atlas = flowgen_torch.prepare_atlas(
        torch.from_numpy(flowgen_torch.procedural_atlas(2, height=H, width=W)))
    batch = flowgen_torch.render_batch(scenes, atlas, cfg)
    one = flowgen_torch.render_sample(
        flowgen_torch.params.blueprint.map_scene(lambda t: t[1], scenes),
        atlas, cfg)
    assert isinstance(one, flowgen_torch.RenderOutput)
    for got, want in zip(one, batch):
        torch.testing.assert_close(got, want[1], rtol=0, atol=0)
    plain = dataclasses.replace(cfg, compute_inverse_flow=False,
                                emit_masks=False)
    out = flowgen_torch.render_sample(
        flowgen_torch.params.blueprint.map_scene(lambda t: t[0], scenes),
        atlas, plain)
    assert out.flow1 is None and out.ids is None
    assert out.image0.shape == (H, W, 3) and out.flow0.shape == (H, W, 2)


@pytest.mark.parametrize("inverse", [False, True])
def test_background_flow_matches_jax(inverse):
    """The affine flow planes of the background, bit for bit against the
    JAX function run eagerly, op by op (the contract the scene kernel's flow
    init follows). Jitted, XLA:CPU fuses and contracts the inverse's
    arithmetic, and its inverse flow differs from the eager one in the last
    bits (up to 3.8e-6 px on a fifth of the pixels at this size)."""
    kw = dict(mode=7, batch_size=3, width=W, height=H,
              compute_inverse_flow=inverse)
    jc, tc = flowgen.DataGenConfig(**kw), flowgen_torch.DataGenConfig(**kw)
    scenes = jax.tree.map(np.asarray,
                          j_sample(j_root(2), jnp.arange(3), jc))
    want = jax.vmap(lambda s: jrender.background_flow(s, jc))(
        jax.tree.map(jnp.asarray, scenes))
    ts = scene_from_numpy(scenes)
    for i in range(3):
        got = trender.background_flow(
            flowgen_torch.params.blueprint.map_scene(lambda t: t[i], ts), tc)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w)[i])
    assert float(np.abs(np.asarray(want[0])).max()) > 0.1


def _files(tmp_path, mod, tag, flow, img, mono):
    paths = {ext: str(tmp_path / f"{tag}.{ext}")
             for ext in ("flo", "pfm", "pfm3", "ppm", "pgm")}
    mod.write_flo(paths["flo"], flow)
    mod.write_pfm(paths["pfm"], flow)
    mod.write_pfm(paths["pfm3"], img.astype(np.float32))
    mod.write_ppm(paths["ppm"], img)
    mod.write_pgm(paths["pgm"], mono)
    return paths


def test_flow_io_round_trips_byte_equal(tmp_path):
    rng = np.random.default_rng(0)
    flow = rng.normal(0, 7, (H, W, 2)).astype(np.float32)
    img = rng.uniform(0, 255, (H, W, 3)).astype(np.float32)
    mono = rng.integers(0, 256, (H, W), dtype=np.uint8)
    a = _files(tmp_path, jio, "jax", flow, img, mono)
    b = _files(tmp_path, tio, "port", flow, img, mono)
    for ext in a:
        assert open(a[ext], "rb").read() == open(b[ext], "rb").read(), ext
    np.testing.assert_array_equal(tio.read_flo(a["flo"]), flow)
    np.testing.assert_array_equal(tio.read_pfm(a["pfm"])[..., :2], flow)
    np.testing.assert_array_equal(tio.read_ppm(a["ppm"]),
                                  jio.read_ppm(b["ppm"]))
    np.testing.assert_array_equal(tio.flow_to_color(flow),
                                  jio.flow_to_color(flow))


def test_metrics_match_jax_on_numpy_and_tensors():
    rng = np.random.default_rng(1)
    a = rng.normal(0, 3, (2, H, W, 2)).astype(np.float32)
    b = a + rng.normal(0, 1, a.shape).astype(np.float32)
    mask = rng.uniform(size=(2, H, W)) < 0.7
    want = jmetrics.epe_stats(a, b)
    assert tmetrics.epe_stats(a, b) == want
    assert tmetrics.epe_stats(torch.from_numpy(a), torch.from_numpy(b)) == want
    assert tmetrics.epe(torch.from_numpy(a), b,
                        torch.from_numpy(mask)) == jmetrics.epe(a, b, mask)
    for x, y in zip(tmetrics.flow_magnitude_histogram(torch.from_numpy(a)),
                    jmetrics.flow_magnitude_histogram(a)):
        np.testing.assert_array_equal(x, y)


def test_prototxt_copy_pinned():
    """The port's prototxt module is the JAX package's, its import lines
    aside, and ``examples/train.prototxt`` gives the same configuration in
    both, with and without overrides."""
    def body(mod):
        return [ln for ln in open(mod.__file__).read().splitlines()
                if not ln.startswith("from ..")]

    assert body(tproto) == body(jproto)
    path = os.path.join(ROOT, "examples", "train.prototxt")
    for kw in ({}, dict(layout="nhwc", texture_dbases=()),
               dict(batch_size=2, mode=7)):
        got = tproto.load_config(path, **kw)
        assert isinstance(got, flowgen_torch.DataGenConfig)
        assert dataclasses.asdict(got) == dataclasses.asdict(
            jproto.load_config(path, **kw))
    assert tproto.load_config(path).mode == 9
