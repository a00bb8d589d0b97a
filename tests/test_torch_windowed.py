"""The port's windowed renderer against the JAX package on the CPU, at 300x200
with B=2: width 300 is not a multiple of 128, so both packages render through
the windowed renderer, and both window classes (192x256 and the full frame)
are used. The JAX side runs its composed branch (no Pallas kernel on the
CPU); the port runs the same, and with ``use_pallas="always"`` the plain
versions of its window kernels.

Images and flow are held to the gates of the JAX package's own on-device
check (tools/check_pallas_tpu.py): under 1% of image values >= 1 level apart
and under 1e-4 >= 2 levels; flow median |d| < 1e-4 px and under 1e-3 of
values with |d| > 0.01 px. Motion boundaries are equal; occlusion differs on
at most 1e-4 of pixels, only where the forward flow differs (a 1-ulp flow
difference can move a rounded target pixel)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flowgen
import flowgen_torch
from flowgen.pipeline.generator import generate_batch as j_generate
from flowgen.random.streams import root_key as j_root
from flowgen_torch.compose import render as tr
from flowgen_torch.ops import window
from flowgen_torch.params.blueprint import map_scene
from flowgen_torch.params.sampler import sample_scene_batch as t_sample
from flowgen_torch.pipeline.generator import generate_batch as t_generate
from flowgen_torch.pipeline.generator import make_atlas_packer, use_fused_path
from flowgen_torch.random.streams import root_key as t_root

torch.set_num_threads(1)

W, H, B = 300, 200, 2
N_TEX = 3
SEED = 3

CASES = {
    "mode1": dict(mode=1),
    "mode7": dict(mode=7),
    "mode7_flow1_masks": dict(mode=7, compute_inverse_flow=True,
                              emit_masks=True),
    "mode7_no_aa": dict(mode=7, use_antialiasing=False),
}


def _cfg(pkg, case, **kw):
    return pkg.DataGenConfig(**{"batch_size": B, "width": W, "height": H,
                                "seed": SEED, **CASES[case], **kw})


@pytest.fixture(scope="module")
def atlas():
    return flowgen.procedural_atlas(N_TEX, height=H, width=W)


_REF = {}


def _jax_ref(case, atlas):
    if case not in _REF:
        jc = _cfg(flowgen, case)
        out = j_generate(j_root(SEED), 0, jnp.asarray(atlas), jc)
        _REF[case] = {k: np.asarray(v) for k, v in out.items()}
    return _REF[case]


def assert_gates(out, want):
    assert set(out) == set(want)
    dimg = [np.abs(out[k] - want[k]) for k in ("image0", "image1")]
    assert max((d >= 1).mean() for d in dimg) < 0.01
    assert max((d >= 2).mean() for d in dimg) < 1e-4
    for k in ("flow0", "flow1"):
        if k in want:
            d = np.abs(out[k] - want[k])
            assert np.median(d) < 1e-4 and (d > 0.01).mean() < 1e-3, k
    if "motion_boundary" in want:
        np.testing.assert_array_equal(out["motion_boundary"],
                                      want["motion_boundary"])
        occ = out["occlusion"] != want["occlusion"]
        assert occ.mean() <= 1e-4
        moved = np.abs(out["flow0"] - want["flow0"]).max(-1) > 0
        assert not (occ & ~moved).any()


def _port(cfg, atlas, step=0):
    return {k: v.numpy() for k, v in t_generate(
        cfg.seed, step, atlas, cfg, device="cpu").items()}


def test_prepare_atlas_matches_jax(atlas):
    """The quad-packed atlas the windowed renderer samples is byte-equal to
    the JAX package's."""
    from flowgen.compose.render import prepare_atlas as j_prepare

    got = make_atlas_packer("cpu")(atlas)
    assert got.dtype == torch.uint8 and got.shape == atlas.shape[:3] + (12,)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(j_prepare(jnp.asarray(atlas))))


@pytest.mark.parametrize("wrap", ["reflect", "zero"])
def test_samplers_match_jax(wrap):
    """The quad-table and plain bilinear samplers, in and far out of range,
    bit-equal to the JAX package's."""
    from flowgen.ops import texture as jtex
    from flowgen_torch.ops import texture as ttex

    rng = np.random.default_rng(5)
    img = rng.uniform(0, 255, (2, 24, 40, 3)).astype(np.float32)
    x = rng.uniform(-90, 130, (2, 50, 60)).astype(np.float32)
    y = rng.uniform(-60, 85, (2, 50, 60)).astype(np.float32)
    x[:, :5] = np.round(x[:, :5])                 # texel centres, edges
    quad = np.stack([np.asarray(jtex.make_quad(jnp.asarray(im)))
                     for im in img])
    np.testing.assert_array_equal(ttex.make_quad(torch.from_numpy(img)).numpy(),
                                  quad)
    base = (torch.arange(2) * (24 * 40)).reshape(2, 1, 1)
    got = ttex.sample_bilinear_quad_flat(
        torch.from_numpy(quad).reshape(-1, 12), base, 24, 40,
        torch.from_numpy(x), torch.from_numpy(y), wrap=wrap).numpy()
    got_b = ttex.sample_bilinear(torch.from_numpy(img), torch.from_numpy(x),
                                 torch.from_numpy(y), wrap=wrap).numpy()
    for i in range(2):
        want = np.asarray(jtex.sample_bilinear_quad(
            jnp.asarray(quad[i]), jnp.asarray(x[i]), jnp.asarray(y[i]),
            wrap=wrap))
        np.testing.assert_array_equal(got[i], want)
        want_b = np.asarray(jtex.sample_bilinear(
            jnp.asarray(img[i]), jnp.asarray(x[i]), jnp.asarray(y[i]),
            wrap=wrap))
        np.testing.assert_array_equal(got_b[i], want_b)


@pytest.mark.parametrize("case", list(CASES))
def test_generate_batch_meets_gates(case, atlas):
    cfg = _cfg(flowgen_torch, case)
    assert not use_fused_path(cfg, "cpu")
    assert_gates(_port(cfg, atlas), _jax_ref(case, atlas))


@pytest.mark.parametrize("case", ["mode7", "mode7_flow1_masks"])
def test_plain_kernel_versions_meet_gates(case, atlas):
    """``use_pallas="always"`` on the CPU: ``object_window`` and
    ``polygon_coverage`` through their plain versions."""
    cfg = _cfg(flowgen_torch, case, use_pallas="always")
    window.polygon_coverage.launches = window.object_window.launches = 0
    assert_gates(_port(cfg, atlas), _jax_ref(case, atlas))
    assert window.object_window.launches == 0   # nothing launched on the CPU


def test_scenes_use_both_window_classes(atlas):
    """The scenes of these tests put objects in both window classes."""
    cfg = _cfg(flowgen_torch, "mode7")
    scenes = t_sample(t_root(SEED), torch.arange(B), cfg)
    (lo0, hi0), _ = tr._all_bboxes(scenes.prims, scenes.objects.motion)
    on = scenes.objects.valid & ~tr._offscreen(lo0, hi0, tr.AA_MARGIN, H, W)
    cls = tr._size_classes(lo0, hi0, tr.AA_MARGIN, tr.WINDOW_CLASSES)[on]
    assert set(cls.tolist()) == {0, 1}


@pytest.mark.parametrize("mode", [1, 7])
@pytest.mark.parametrize("use_pallas", ["auto", "always"])
def test_windowed_equals_full_frame(mode, use_pallas, atlas):
    """Per-object windows give the full-frame result bit for bit."""
    kw = dict(mode=mode, batch_size=B, width=W, height=H, seed=SEED,
              use_pallas=use_pallas, compute_inverse_flow=True)
    win = _port(flowgen_torch.DataGenConfig(**kw), atlas)
    full = _port(flowgen_torch.DataGenConfig(windowed=False, **kw), atlas)
    for k in win:
        np.testing.assert_array_equal(win[k], full[k], err_msg=k)


def test_fused_flow0_equals_windowed():
    """The forward flow does not depend on the renderer (256x192, mode 7)."""
    atlas = flowgen_torch.procedural_atlas(N_TEX, height=192, width=256)
    kw = dict(mode=7, batch_size=B, width=256, height=192, seed=SEED)
    fused = flowgen_torch.DataGenConfig(**kw)
    windowed = flowgen_torch.DataGenConfig(render_impl="windowed", **kw)
    assert use_fused_path(fused, "cpu") and not use_fused_path(windowed, "cpu")
    np.testing.assert_array_equal(_port(windowed, atlas)["flow0"],
                                  _port(fused, atlas)["flow0"])


@pytest.mark.parametrize("use_pallas", ["auto", "always"])
def test_rank_batched_equals_per_sample(use_pallas, atlas):
    """Rendering a batch by painter rank equals rendering each sample on its
    own, bit for bit."""
    cfg = _cfg(flowgen_torch, "mode7_flow1_masks", batch_size=3,
               use_pallas=use_pallas)
    scenes = t_sample(t_root(SEED), torch.arange(3), cfg)
    atlas_q = make_atlas_packer("cpu")(atlas)
    batch = tr.render_batch(scenes, atlas_q, cfg)
    one = dataclasses.replace(cfg, batch_size=1)
    for b in range(3):
        single = tr.render_batch(map_scene(lambda t: t[b : b + 1], scenes),
                                 atlas_q, one)
        for x, y in zip(batch, single):
            np.testing.assert_array_equal(x[b : b + 1].numpy(), y.numpy())
