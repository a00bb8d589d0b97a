"""The port's mode-9 slice against the JAX package on the CPU, at 128x96 with
B=2: the sampled scenes and the scene-kernel tables with warp flags and
slots, the plain render of a scene and bank carried across, the port's own
generate_batch from the same seed and step, the bank-epoch cache of
make_generate_fn, and the warp_oob="nan" decode. The seed and step are the
first whose two samples hold at least two deforming objects and a deforming
background (the scan of tests/test_fused.py). The JAX side runs its bank
kernels and its scene megakernel in Pallas interpret mode, once per file:
its generate_batch, given the bank and aux of make_bank_and_aux, is the
render both port paths are held to.

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
from flowgen.params.sampler import sample_scene_batch as j_sample
from flowgen.pipeline.generator import _adapt_output as j_adapt
from flowgen.pipeline.generator import generate_batch as j_generate
from flowgen.random.streams import root_key as j_root
from flowgen.warpfields import generator as jg
from flowgen_torch.compose import fused as tf
from flowgen_torch.interop import aux_from_numpy, scene_from_numpy
from flowgen_torch.params.sampler import sample_scene_batch as t_sample
from flowgen_torch.pipeline.generator import (
    BankEpochCache,
    _adapt_output,
    generate_batch as t_generate,
    make_generate_fn,
    make_slab_packer,
)
from flowgen_torch.random.streams import root_key as t_root
from flowgen_torch.warpfields import generator as tg

torch.set_num_threads(1)

W, H, B = 128, 96, 2
N_TEX = 3


def _cfgs(**kw):
    return (flowgen.DataGenConfig(mode=9, batch_size=B, width=W, height=H, **kw),
            flowgen_torch.DataGenConfig(mode=9, batch_size=B, width=W, height=H,
                                        **kw))


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
    out = j_generate(j_root(seed), step, jnp.asarray(atlas), jc,
                     warp_bank=bank, warp_aux=aux)
    scenes = j_sample(j_root(seed), step * B + jnp.arange(B), jc,
                      n_warp_slots=jg.bank_size(jc))
    return {
        "seed": seed, "step": step, "atlas": atlas,
        "out": {k: np.asarray(v) for k, v in out.items()},
        "scenes": jax.tree.map(np.asarray, scenes),
        "aux": tuple(np.asarray(a) for a in aux),
    }


def _gates(a, b):
    dimg = [np.abs(a[k] - b[k]) for k in ("image0", "image1")]
    dflow = np.abs(a["flow0"] - b["flow0"])
    assert max((d >= 1).mean() for d in dimg) < 0.01
    assert max((d >= 2).mean() for d in dimg) < 1e-4
    assert np.median(dflow) < 1e-4
    assert (dflow > 0.01).mean() < 1e-3


def test_scenes_match_jax(ref):
    """The sampler with the bank's slot count: deform triggers and warp
    slots exactly, and the scan's scenes really deform."""
    _, tc = _cfgs()
    got = t_sample(t_root(ref["seed"]), ref["step"] * B + torch.arange(B), tc,
                   n_warp_slots=tg.bank_size(tc))
    want = ref["scenes"]
    for name in ("warp", "warp_slot", "valid", "tex_id"):
        np.testing.assert_array_equal(getattr(got.objects, name).numpy(),
                                      getattr(want.objects, name))
    for name in ("warp", "warp_slot", "tex_id"):
        np.testing.assert_array_equal(getattr(got.background, name).numpy(),
                                      getattr(want.background, name))
    assert int((want.objects.warp & want.objects.valid).sum()) >= 2
    assert int(want.background.warp.sum()) >= 1
    assert int(want.objects.warp_slot.max()) < tg.bank_size(tc)


def test_scene_tables_match(ref):
    """Mode-9 tables: the warp flag and slot columns, the widened frame-1
    cover of deforming objects, and the envelope check."""
    jc, tc = _cfgs()
    js = jax.tree.map(jnp.asarray, ref["scenes"])
    jt = [np.asarray(x) for x in
          jax.vmap(lambda s: jf.prepare_scene_inputs(s, jc, N_TEX))(js)]
    ts = scene_from_numpy(ref["scenes"])
    tt = [x.numpy() for x in tf.prepare_scene_inputs(ts, tc, N_TEX)]
    for name, a, b in zip(("count", "order", "omi", "omf", "tmi", "tmf",
                           "edges"), jt, tt):
        if a.dtype.kind in "iu":
            np.testing.assert_array_equal(b, a, err_msg=name)
        else:
            np.testing.assert_allclose(b, a, rtol=0, atol=1e-5, err_msg=name)
    assert tt[2][..., 7].any()      # OMI_WARP
    assert int(tf.envelope_violations(ts, tc)) == int(
        jf.envelope_violations(js, jc)) == 0


def test_render_carried_scene_and_bank_meets_gates(ref):
    _, tc = _cfgs()
    ts = scene_from_numpy(ref["scenes"])
    obj, bg, src, _ = make_slab_packer(tc, "cpu")(ref["atlas"])
    aux = aux_from_numpy(ref["aux"])
    i0, i1, f0 = tf.render_batch_fused(ts, obj, bg, src, tc, warp_aux=aux)
    out = {k: v.numpy() for k, v in _adapt_output(i0, i1, f0, None, tc).items()}
    _gates(out, ref["out"])
    # The deformation is in the render: the frames differ from the rigid
    # render of the same scenes on more than a few pixels.
    rigid = tf.render_batch_fused(
        ts._replace(objects=ts.objects._replace(warp=torch.zeros_like(ts.objects.warp)),
                    background=ts.background._replace(
                        warp=torch.zeros_like(ts.background.warp))),
        obj, bg, src, tc, warp_aux=aux)
    assert (np.abs(rigid[1].numpy() - out["image1"]) >= 1).mean() > 0.01


def test_generate_batch_meets_gates(ref):
    _, tc = _cfgs()
    out = t_generate(ref["seed"], ref["step"], ref["atlas"], tc, device="cpu")
    assert set(out) == set(ref["out"])
    _gates({k: v.numpy() for k, v in out.items()}, ref["out"])


def test_make_generate_fn_bank_epochs():
    """make_generate_fn caches each bank epoch (warp_bank_reuse_steps=2) and
    builds the next one ahead; its batches equal generate_batch's."""
    _, tc = _cfgs()
    atlas = flowgen.procedural_atlas(N_TEX, height=H, width=W)
    calls = []
    real = tg.make_bank_and_aux

    def counting(root, step, cfg, *a, **k):
        calls.append(int(step))
        return real(root, step, cfg, *a, **k)

    tg.make_bank_and_aux = counting
    try:
        fn = make_generate_fn(tc, device="cpu")
        outs = [fn(0, s, atlas) for s in range(3)]
    finally:
        tg.make_bank_and_aux = real
    # Epoch 0 at step 0, epoch 1 ahead at step 1 (its last), none at step 2.
    assert calls == [0, 2]
    for s in (0, 2):
        want = t_generate(0, s, atlas, tc, device="cpu")
        for k in want:
            torch.testing.assert_close(outs[s][k], want[k], rtol=0, atol=0)


def test_bank_epoch_cache_keys_on_root():
    """One build per (root, epoch); the next epoch is built ahead on an
    epoch's last step; another root (by value, not by object) drops the
    cache instead of returning another root's bank."""
    built = []

    def key(root):
        return tuple(root.tolist()) if torch.is_tensor(root) else root

    def build(root, step):
        built.append((key(root), step))
        return built[-1]

    cache = BankEpochCache(build, 2)
    a, a_again, b = t_root(1), t_root(1), t_root(2)
    assert key(a) != key(b)
    assert cache.get(a, 0) == (key(a), 0)
    cache.prefetch_next(a, 0)
    assert cache.get(a_again, 1) == (key(a), 0)
    cache.prefetch_next(a_again, 1)
    assert cache.get(a, 2) == (key(a), 2)
    assert cache.get(b, 2) == (key(b), 2)
    assert cache.get(7, 3) == (7, 2)
    assert cache.get(7, 2) == (7, 2)
    assert built == [(key(a), 0), (key(a), 2), (key(b), 2), (7, 2)]


def test_bank_epoch_cache_holds_one_epoch_a_parity():
    """A build may overwrite the epoch of its parity that it built before
    (the CUDA graphs' planes): the cache never returns such an epoch, after
    a seek forward, a seek back or a prediction from another epoch."""
    slots = [[None], [None]]

    def build(root, step):
        slot = slots[(step // 2) % 2]
        slot[0] = step // 2
        return slot

    cache = BankEpochCache(build, 2)
    for step, pre in ((0, 1), (6, 7), (2, 3), (4, None), (2, None), (0, 3),
                      (0, None), (5, 5), (4, None)):
        assert cache.get(1, step) == [step // 2], step
        if pre is not None:
            cache.prefetch_next(1, pre)


def test_warp_oob_nan_decode_matches_jax():
    jc, tc = _cfgs(warp_oob="nan")
    rng = np.random.default_rng(0)
    im = rng.integers(0, 256, (B, H, W, 3)).astype(np.float32)
    flow = rng.normal(0, 5, (B, H, W, 2)).astype(np.float32)
    flow[0, 3:9, 4:40] = tg.OOB_SENTINEL * 0.3
    got = _adapt_output(*(torch.from_numpy(a) for a in (im, im, flow)), None, tc)
    want = j_adapt(*(jnp.asarray(a) for a in (im, im, flow)), None, jc)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    assert np.isnan(got["flow0"].numpy()).sum() == 6 * 36 * 2
