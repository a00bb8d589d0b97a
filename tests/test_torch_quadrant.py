"""The port's quadrant modes (11 and 13) against the JAX package on the CPU:
the quadrant factoring and the scene-kernel tables at 512x384 and 256x96,
the slabs with their rot90 copies, and mode 13 with inverse flow and masks
from seed to batch at 256x96, B=1, where the frame-1 textures take the 2x2
sub-windows (tsplit=2). The JAX side runs its scene megakernel in Pallas
interpret mode once per file; the arrays its kernel received and returned
are kept, so the id images are compared on the very tables the JAX kernel
rendered.

Images and flows are held to the gates of the JAX package's own on-device
check (tools/check_pallas_tpu.py): under 1% of image values >= 1 level
apart and under 1e-4 >= 2 levels; flow median |d| < 1e-4 px and under 1e-3
of values with |d| > 0.01 px. The id images and the motion boundaries must
be equal; the occlusion mask may differ on at most 1e-4 of pixels, and only
where the forward flow differs (it rounds p + flow to a pixel)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flowgen
import flowgen_torch
from flowgen.compose import fused as jf
from flowgen.ops import pallas_scene as jps
from flowgen.pipeline.generator import generate_batch as j_generate
from flowgen.random.streams import root_key as j_root
from flowgen_torch.compose import fused as tf
from flowgen_torch.ops import scene as tps
from flowgen_torch.params.sampler import sample_scene_batch as t_sample
from flowgen_torch.pipeline.generator import generate_batch as t_generate
from flowgen_torch.random.streams import root_key as t_root

torch.set_num_threads(1)

N_TEX = 3
SEED, STEP = 0, 0
OUTPUTS = dict(compute_inverse_flow=True, emit_masks=True)


def _cfgs(mode, W, H, B, **kw):
    return (flowgen.DataGenConfig(mode=mode, batch_size=B, width=W, height=H,
                                  **kw),
            flowgen_torch.DataGenConfig(mode=mode, batch_size=B, width=W,
                                        height=H, **kw))


def capture_scene_render(run):
    """Run ``run()`` with the JAX package's scene_render_pallas wrapped so
    that the arrays it is given and returns are kept: (result, record)."""
    record = {}
    real = jps.scene_render_pallas

    def wrapped(*args, **kw):
        out = real(*args, **kw)
        record.update(args=[None if a is None else np.asarray(a) for a in args],
                      kw=kw, out=[None if o is None else np.asarray(o)
                                  for o in out])
        return out

    jps.scene_render_pallas = wrapped
    try:
        return run(), record
    finally:
        jps.scene_render_pallas = real


@pytest.fixture(scope="module")
def ref():
    jc, _ = _cfgs(13, 256, 96, 1, **OUTPUTS)
    atlas = flowgen.procedural_atlas(N_TEX, height=96, width=256)
    out, rec = capture_scene_render(
        lambda: j_generate(j_root(SEED), STEP, jnp.asarray(atlas), jc))
    return {"atlas": atlas, "out": {k: np.asarray(v) for k, v in out.items()},
            "rec": rec}


def _gates(a, b, flows=("flow0", "flow1")):
    dimg = [np.abs(a[k] - b[k]) for k in ("image0", "image1")]
    assert max((d >= 1).mean() for d in dimg) < 0.01
    assert max((d >= 2).mean() for d in dimg) < 1e-4
    for k in flows:
        d = np.abs(a[k] - b[k])
        assert np.median(d) < 1e-4, k
        assert (d > 0.01).mean() < 1e-3, k


def _port_scenes(tc):
    """The first seed's batch that holds objects of both quadrant kinds
    (rot90 copy and not)."""
    idx = torch.arange(tc.batch_size)
    for seed in range(32):
        ts = t_sample(t_root(seed), idx, tc)
        _, rot = tf._quadrant_factor(ts.objects.motion_inv,
                                     float(tc.width), float(tc.height))
        valid = ts.objects.valid
        if bool((rot & valid).any()) and bool((~rot & valid).any()):
            return ts
    raise AssertionError("no seed with objects of both quadrant kinds")


def _to_jax(tree):
    return jax.tree.map(lambda t: jnp.asarray(t.numpy()), tree)


@pytest.mark.parametrize("mode,W,H", [(11, 512, 384), (13, 512, 384),
                                      (11, 256, 96), (13, 256, 96)])
def test_quadrant_tables_match(mode, W, H):
    """The quadrant factor (rot90 flags exactly, residual affines to 1e-5)
    and the scene-kernel tables with it: integers exactly (OMI_TEX of an odd
    quadrant points into [T:2T]), floats to 1e-5."""
    jc, tc = _cfgs(mode, W, H, 2)
    assert tps.resample_params(tc.mode_spec, H, W) == jps.resample_params(
        jc.mode_spec, H, W)
    assert tps.resample_params(tc.mode_spec, H, W)[6] == 2
    ts = _port_scenes(tc)
    js = _to_jax(ts)
    minv = ts.objects.motion_inv
    t_eff, rot = tf._quadrant_factor(minv, float(W), float(H))
    j_eff, j_rot = jf._quadrant_factor(
        jnp.asarray(minv.reshape(-1, 2, 3).numpy()), float(W), float(H))
    np.testing.assert_array_equal(rot.reshape(-1).numpy(), np.asarray(j_rot))
    np.testing.assert_allclose(t_eff.reshape(-1, 2, 3).numpy(),
                               np.asarray(j_eff), rtol=0, atol=1e-5)
    jt = [np.asarray(x) for x in jax.vmap(
        lambda s: jf.prepare_scene_inputs(s, jc, N_TEX, quadrant=True))(js)]
    tt = [x.numpy() for x in tf.prepare_scene_inputs(ts, tc, N_TEX,
                                                     quadrant=True)]
    for name, a, b in zip(("count", "order", "omi", "omf", "tmi", "tmf",
                           "edges"), jt, tt):
        assert a.shape == b.shape, name
        if a.dtype.kind in "iu":
            np.testing.assert_array_equal(b, a, err_msg=name)
        else:
            np.testing.assert_allclose(b, a, rtol=0, atol=1e-5, err_msg=name)
    # Frame-1 texture ids of both quadrant kinds.
    tex1 = tt[2][:, :, 1, tps.OMI_TEX][ts.objects.valid.numpy()]
    assert (tex1 >= N_TEX).any() and (tex1 < N_TEX).any()
    assert int(tf.envelope_violations(ts, tc)) == int(
        jf.envelope_violations(js, jc)) == 0


@pytest.mark.parametrize("W,H", [(256, 96), (512, 384)])
def test_quadrant_slabs_match(W, H):
    atlas = flowgen.procedural_atlas(N_TEX, height=H, width=W)
    want = np.asarray(jps.prepare_slabs(jnp.asarray(atlas), H, W,
                                        quadrant=True))
    got = tps.prepare_slabs(torch.from_numpy(atlas), H, W, quadrant=True)
    assert got.shape == want.shape and want.shape[0] == 2 * N_TEX
    np.testing.assert_array_equal(got.numpy(), want)


def test_scene_tables_match_jax_kernel_inputs(ref):
    """The port's own sampler and precompute, from the same seed and step,
    give the tables the JAX kernel rendered: integers exactly, floats to
    1e-5 relative (the sampler's floats agree with the JAX package's to an
    ulp or two, tests/test_torch_sampler.py, and mode 13 moves objects by
    hundreds of pixels)."""
    _, tc = _cfgs(13, 256, 96, 1, **OUTPUTS)
    atlas = torch.from_numpy(ref["atlas"])
    slabs = tps.prepare_slabs(atlas, 96, 256, quadrant=True)
    bgslabs = tps.prepare_bg_slabs(atlas)
    scenes = t_sample(t_root(SEED), torch.arange(1), tc)
    args, opts = tf.scene_tables(scenes, tc, slabs, bgslabs, (192, 512))
    j = ref["rec"]["args"]
    assert opts["spec_key"] == ref["rec"]["kw"]["spec_key"]
    assert opts["spec_key"][6] == 2
    for name, got, want in zip(
            ("bg_meta", "omi", "omf", "tmi", "tmf", "bgm", "edges", "slabs",
             "bgslabs"), args[:9], j[2:11]):
        if want.dtype.kind in "iu":
            np.testing.assert_array_equal(got.numpy(), want, err_msg=name)
        else:
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                                       atol=1e-5, err_msg=name)
    wl, nu = tps.build_worklists(*(torch.from_numpy(a) for a in j[:2]),
                                 args[1])
    np.testing.assert_array_equal(wl.numpy(), args[9].numpy())
    np.testing.assert_array_equal(nu.numpy(), args[10].numpy())


def test_plain_render_of_jax_tables(ref):
    """scene_render_plain on the JAX kernel's own inputs: the id images
    equal the JAX kernel's; frames and all four flow planes meet the
    gates."""
    j = ref["rec"]["args"]
    T = torch.from_numpy
    count, order, bg_meta, omi, omf, tmi, tmf, bgm, edges, slabs, bgslabs = (
        T(a) for a in j[:11])
    wl, nu = tps.build_worklists(count, order, omi)
    frames, flow, ids = tps.scene_render_plain(
        bg_meta, omi, omf, tmi, tmf, bgm, edges, slabs, bgslabs, wl, nu,
        spec_key=ref["rec"]["kw"]["spec_key"], use_aa=True, inverse_flow=True,
        emit_masks=True)
    jframes, jflow, jids = ref["rec"]["out"]
    np.testing.assert_array_equal(ids.numpy(), jids)
    assert len(np.unique(jids)) > 3
    unpack = lambda v: np.stack([(v >> s) & 0xFF for s in (16, 8, 0)], -1)
    d = np.abs(unpack(frames.numpy()) - unpack(jframes))
    assert (d >= 1).mean() < 0.01 and (d >= 2).mean() < 1e-4
    d = np.abs(flow.numpy() - jflow)
    assert flow.shape[1] == 4
    assert np.median(d) < 1e-4 and (d > 0.01).mean() < 1e-3


def test_generate_batch_meets_gates(ref):
    _, tc = _cfgs(13, 256, 96, 1, **OUTPUTS)
    out = {k: v.numpy() for k, v in
           t_generate(SEED, STEP, ref["atlas"], tc, device="cpu").items()}
    want = ref["out"]
    assert set(out) == set(want)
    _gates(out, want)
    # Inverse flow is a real output: not the forward flow negated.
    assert (np.abs(out["flow1"] + out["flow0"]) > 0.5).mean() > 0.05
    np.testing.assert_array_equal(out["motion_boundary"],
                                  want["motion_boundary"])
    occ = out["occlusion"] != want["occlusion"]
    assert occ.mean() <= 1e-4
    moved = np.abs(out["flow0"] - want["flow0"]).max(-1) > 0
    assert not (occ & ~moved).any()
    assert 0.01 < want["occlusion"].mean() < 0.99
