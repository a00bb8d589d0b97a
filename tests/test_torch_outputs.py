"""The port's inverse flow and masks against the JAX package on the CPU, in
mode 9 at 128x96 with B=2, where a deforming object's frame-1 inverse flow
and id come from the warped binary mask: the port's own generate_batch from
the same seed and step, the plain render of the JAX kernel's own inputs
(id images equal), and ``masks_from_ids`` on ids and flows made from a seed.
The seed and step are the first whose two samples hold at least two
deforming objects and a deforming background. The JAX side runs its bank
kernels and scene megakernel in Pallas interpret mode once per file.

Gates as in tests/test_torch_quadrant.py: images and both flows the JAX
package's on-device gates; id images and motion boundaries equal; occlusion
differing on at most 1e-4 of pixels, only where the forward flow differs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flowgen
import flowgen_torch
from flowgen.compose import fused as jf
from flowgen.pipeline.generator import generate_batch as j_generate
from flowgen.random.streams import root_key as j_root
from flowgen.warpfields import generator as jg
from flowgen_torch.compose import fused as tf
from flowgen_torch.interop import aux_from_numpy
from flowgen_torch.ops import scene as tps
from flowgen_torch.params.sampler import sample_scene_batch as t_sample
from flowgen_torch.pipeline.generator import generate_batch as t_generate
from flowgen_torch.random.streams import root_key as t_root
from flowgen_torch.warpfields import generator as tg
from test_torch_quadrant import capture_scene_render

torch.set_num_threads(1)

W, H, B = 128, 96, 2
N_TEX = 3
OUTPUTS = dict(compute_inverse_flow=True, emit_masks=True)


def _cfgs():
    return (flowgen.DataGenConfig(mode=9, batch_size=B, width=W, height=H,
                                  **OUTPUTS),
            flowgen_torch.DataGenConfig(mode=9, batch_size=B, width=W,
                                        height=H, **OUTPUTS))


def _find_seed_step(tc):
    n_slots = tg.bank_size(tc)
    for seed in range(40):
        for step in range(4):
            sc = t_sample(t_root(seed), step * B + torch.arange(B), tc,
                          n_warp_slots=n_slots)
            if (int((sc.objects.warp & sc.objects.valid).sum()) >= 2
                    and int(sc.background.warp.sum()) >= 1):
                return seed, step
    raise AssertionError("no seed with deforming objects and background")


@pytest.fixture(scope="module")
def ref():
    jc, tc = _cfgs()
    seed, step = _find_seed_step(tc)
    bank, aux = jax.jit(lambda r, s: jg.make_bank_and_aux(r, s, jc))(
        j_root(seed), jnp.int32(step))
    atlas = flowgen.procedural_atlas(N_TEX, height=H, width=W)
    out, rec = capture_scene_render(lambda: j_generate(
        j_root(seed), step, jnp.asarray(atlas), jc, warp_bank=bank,
        warp_aux=aux))
    return {"seed": seed, "step": step, "atlas": atlas, "rec": rec,
            "out": {k: np.asarray(v) for k, v in out.items()}}


def test_generate_batch_meets_gates(ref):
    _, tc = _cfgs()
    out = {k: v.numpy() for k, v in t_generate(
        ref["seed"], ref["step"], ref["atlas"], tc, device="cpu").items()}
    want = ref["out"]
    assert set(out) == set(want) == {"image0", "image1", "flow0", "flow1",
                                     "occlusion", "motion_boundary"}
    dimg = [np.abs(out[k] - want[k]) for k in ("image0", "image1")]
    assert max((d >= 1).mean() for d in dimg) < 0.01
    assert max((d >= 2).mean() for d in dimg) < 1e-4
    for k in ("flow0", "flow1"):
        d = np.abs(out[k] - want[k])
        assert np.median(d) < 1e-4 and (d > 0.01).mean() < 1e-3, k
    np.testing.assert_array_equal(out["motion_boundary"],
                                  want["motion_boundary"])
    occ = out["occlusion"] != want["occlusion"]
    assert occ.mean() <= 1e-4
    moved = np.abs(out["flow0"] - want["flow0"]).max(-1) > 0
    assert not (occ & ~moved).any()


def test_plain_render_of_jax_tables(ref):
    """scene_render_plain on the JAX kernel's own inputs, warp planes
    included: ids equal, and deforming frame-1 units paint ids and inverse
    flow under their warped masks."""
    j = ref["rec"]["args"]
    T = torch.from_numpy
    count, order, bg_meta, omi, omf, tmi, tmf, bgm, edges, slabs, bgslabs = (
        T(a) for a in j[:11])
    aux = aux_from_numpy((j[11], j[12]))
    wl, nu = tps.build_worklists(count, order, omi)
    frames, flow, ids = tps.scene_render_plain(
        bg_meta, omi, omf, tmi, tmf, bgm, edges, slabs, bgslabs, wl, nu,
        *aux, spec_key=ref["rec"]["kw"]["spec_key"], use_aa=True, inverse_flow=True,
        emit_masks=True)
    jframes, jflow, jids = ref["rec"]["out"]
    np.testing.assert_array_equal(ids.numpy(), jids)
    d = np.abs(flow.numpy() - jflow)
    assert np.median(d) < 1e-4 and (d > 0.01).mean() < 1e-3
    # A deforming object's id is in frame 1.
    warp_ids = {tps.FG_ID_BASE + k for b, k in zip(*np.nonzero(
        omi[:, :, 1, tps.OMI_WARP].numpy() & omi[:, :, 1, tps.OMI_ON].numpy()))}
    assert warp_ids & set(np.unique(jids[:, 1]).tolist())


@pytest.mark.parametrize("seed", [0, 1])
def test_masks_from_ids_match_jax(seed):
    """Occlusion and motion boundary from ids and flows made from a seed,
    with flows at exact half pixels and leaving the frame."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, 5, (3, 2, 24, 32)).astype(np.int32)
    ids[:, :, 8:16, 8:20] = 12
    fx = rng.normal(0, 4, (3, 24, 32)).astype(np.float32)
    fy = rng.normal(0, 4, (3, 24, 32)).astype(np.float32)
    fx[:, ::3] = np.round(fx[:, ::3]) + 0.5
    fy[:, :, ::4] = np.round(fy[:, :, ::4]) - 0.5
    got = tf.masks_from_ids(*(torch.from_numpy(a) for a in (ids, fx, fy)))
    want = jf.masks_from_ids(*(jnp.asarray(a) for a in (ids, fx, fy)))
    for g, w in zip(got, want):
        assert g.dtype == torch.bool
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert 0.05 < got[0].float().mean().item() < 0.95
