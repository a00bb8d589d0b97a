"""The port's mode-7 slice against the JAX package on the CPU, at 128x96 with
B=2: the scene-kernel tables from a scene carried across, the plain render
of that scene, and the port's own generate_batch from the same seed and
step. The JAX side runs its scene megakernel in Pallas interpret mode, once
per file.

Images and flow are held to the gates of the JAX package's own on-device
check (tools/check_pallas_tpu.py): under 1% of image values >= 1 level
apart and under 1e-4 >= 2 levels; flow median |d| < 1e-4 px and under 1e-3
of values with |d| > 0.01 px."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flowgen
import flowgen_torch
from flowgen.compose import fused as jf
from flowgen.ops import pallas_scene as jps
from flowgen.params.sampler import sample_scene_batch as j_sample
from flowgen.pipeline.generator import generate_batch as j_generate
from flowgen.random.streams import root_key as j_root
from flowgen_torch.compose import fused as tf
from flowgen_torch.interop import scene_from_numpy, slabs_from_numpy
from flowgen_torch.ops import scene as tps
from flowgen_torch.pipeline.generator import (
    _adapt_output,
    generate_batch as t_generate,
    make_slab_packer,
)

torch.set_num_threads(1)

W, H, B = 128, 96, 2
SEED, STEP = 0, 1
N_TEX = 3


def _cfgs():
    return (flowgen.DataGenConfig(mode=7, batch_size=B, width=W, height=H),
            flowgen_torch.DataGenConfig(mode=7, batch_size=B, width=W, height=H))


@pytest.fixture(scope="module")
def ref():
    jc, _ = _cfgs()
    atlas = flowgen.procedural_atlas(N_TEX, height=H, width=W)
    out = j_generate(j_root(SEED), STEP, jnp.asarray(atlas), jc)
    scenes = j_sample(j_root(SEED), STEP * B + jnp.arange(B), jc)
    return {
        "atlas": atlas,
        "out": {k: np.asarray(v) for k, v in out.items()},
        "scenes": jax.tree.map(np.asarray, scenes),
    }


def _gates(a, b):
    dimg = [np.abs(a[k] - b[k]) for k in ("image0", "image1")]
    dflow = np.abs(a["flow0"] - b["flow0"])
    assert max((d >= 1).mean() for d in dimg) < 0.01
    assert max((d >= 2).mean() for d in dimg) < 1e-4
    assert np.median(dflow) < 1e-4
    assert (dflow > 0.01).mean() < 1e-3


def test_scene_tables_match(ref):
    jc, tc = _cfgs()
    js = jax.tree.map(jnp.asarray, ref["scenes"])
    jt = [np.asarray(x) for x in
          jax.vmap(lambda s: jf.prepare_scene_inputs(s, jc, N_TEX))(js)]
    ts = scene_from_numpy(ref["scenes"])
    tt = [x.numpy() for x in tf.prepare_scene_inputs(ts, tc, N_TEX)]
    names = ("count", "order", "omi", "omf", "tmi", "tmf", "edges")
    for name, a, b in zip(names, jt, tt):
        assert a.shape == b.shape, name
        if a.dtype.kind in "iu":
            np.testing.assert_array_equal(b, a, err_msg=name)
        else:
            np.testing.assert_allclose(b, a, rtol=0, atol=1e-5, err_msg=name)
    jw = jps.build_worklists(*map(jnp.asarray, jt[:3]))
    tw = tps.build_worklists(*map(torch.from_numpy, tt[:3]))
    for a, b in zip(jw, tw):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    assert int(tw[1].sum()) > 0
    jb = np.asarray(jax.vmap(
        lambda s: jf._bg_meta_payload(s, jc, 2 * H, 2 * W))(js))
    tb = tf._bg_meta_payload(ts, tc, 2 * H, 2 * W).numpy()
    np.testing.assert_allclose(tb, jb, rtol=0, atol=1e-5)


def test_slabs_match(ref):
    _, tc = _cfgs()
    atlas = ref["atlas"]
    obj, bg, src, _ = make_slab_packer(tc, "cpu")(atlas)
    assert src == (2 * H, 2 * W)
    np.testing.assert_array_equal(
        obj.numpy(), np.asarray(jps.prepare_slabs(jnp.asarray(atlas), H, W)))
    np.testing.assert_array_equal(
        bg.numpy(), np.asarray(jps.prepare_bg_slabs(jnp.asarray(atlas))))
    np.testing.assert_array_equal(
        slabs_from_numpy(np.asarray(jps.prepare_slabs(jnp.asarray(atlas), H, W))
                         ).numpy(), obj.numpy())


def test_render_carried_scene_meets_gates(ref):
    _, tc = _cfgs()
    ts = scene_from_numpy(ref["scenes"])
    obj, bg, src, _ = make_slab_packer(tc, "cpu")(ref["atlas"])
    i0, i1, f0 = tf.render_batch_fused(ts, obj, bg, src, tc)
    out = {k: v.numpy() for k, v in _adapt_output(i0, i1, f0, None, tc).items()}
    assert out["image0"].shape == (B, H, W, 3)
    assert out["flow0"].shape == (B, H, W, 2)
    _gates(out, ref["out"])
    # The slice has real objects: flow is not the background motion alone.
    bg_only = tf.render_batch_fused(ts, obj, bg, src, tc, bg_only=True)
    assert (np.abs(bg_only[2].numpy() - out["flow0"]) > 0.5).mean() > 0.05


def test_generate_batch_meets_gates(ref):
    _, tc = _cfgs()
    out = t_generate(SEED, STEP, ref["atlas"], tc, device="cpu")
    assert set(out) == set(ref["out"])
    _gates({k: v.numpy() for k, v in out.items()}, ref["out"])


def test_ellipse_radius_bound_enforced():
    """The ellipse row cull (ELL_CULL_M) holds only below ELL_R_MAX px of
    screen radius: every built-in mode is within it, a mode whose ranges
    exceed it is refused, and a scene whose ellipse exceeds it fails in
    prepare_scene_inputs."""
    import dataclasses

    for mode in range(1, 14):
        tf.check_ellipse_bound(flowgen_torch.MODES[mode])
    big = dataclasses.replace(flowgen_torch.MODES[7], ellipse_radius_factor=2000.0)
    with pytest.raises(ValueError, match="ELL_CULL_M"):
        tf.check_ellipse_bound(big)

    _, tc = _cfgs()
    from flowgen_torch.params.sampler import sample_scene_batch
    from flowgen_torch.random.streams import root_key

    scenes = sample_scene_batch(root_key(SEED), torch.arange(4), tc)
    tf.prepare_scene_inputs(scenes, tc, N_TEX)
    p = scenes.prims
    fat = p.valid & ~p.is_poly
    assert bool(fat.any())
    huge = scenes._replace(prims=p._replace(
        ell_rx=torch.where(fat, torch.full_like(p.ell_rx, 3000.0), p.ell_rx)))
    with pytest.raises(RuntimeError, match="ELL_CULL_M"):
        tf.prepare_scene_inputs(huge, tc, N_TEX)


def test_generate_batch_layouts():
    """BGR and NCHW adapters, on the port alone (cheap): channels reverse,
    axes move, content stays."""
    _, tc = _cfgs()
    atlas = flowgen.procedural_atlas(N_TEX, height=H, width=W)
    base = t_generate(SEED, 0, atlas, tc, device="cpu")
    cfg = flowgen_torch.DataGenConfig(mode=7, batch_size=B, width=W, height=H,
                                      channel_order="bgr", layout="nchw")
    alt = t_generate(SEED, 0, atlas, cfg, device="cpu")
    assert alt["image0"].shape == (B, 3, H, W)
    torch.testing.assert_close(alt["image0"], base["image0"].flip(-1).movedim(-1, 1))
    torch.testing.assert_close(alt["flow0"], base["flow0"].movedim(-1, 1))
