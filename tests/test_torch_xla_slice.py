"""Mode 9 with the "xla" warp bank stream, seed to batch, against the JAX
package on the CPU at 128x96 with B=2 (big field 384^2), on both renderers:
the scene kernel's plain version (the fused path) and the windowed renderer.
The port builds its own bank from the seed; the JAX side takes the bank of
its jitted producer (as its make_generate_fn does) and runs its scene
megakernel in Pallas interpret mode. The seed and step are the first whose
two samples hold at least two deforming objects and a deforming
background.

Images and flow are held to the gates of the JAX package's own on-device
check (tools/check_pallas_tpu.py): under 1% of image values >= 1 level
apart and under 1e-4 >= 2 levels; flow median |d| < 1e-4 px and under 1e-3
of values with |d| > 0.01 px. Under warp_oob="nan" the NaN flow pixels must
coincide exactly, and the gates hold on the rest."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flowgen
import flowgen_torch
from flowgen.pipeline.generator import generate_batch as j_generate
from flowgen.random.streams import root_key as j_root
from flowgen.warpfields import generator as jg
from flowgen_torch.params.sampler import sample_scene_batch as t_sample
from flowgen_torch.pipeline.generator import generate_batch as t_generate
from flowgen_torch.random.streams import root_key as t_root
from flowgen_torch.warpfields import generator as tg

torch.set_num_threads(1)

W, H, B = 128, 96, 2
N_TEX = 3


def _cfgs(seed=0, **kw):
    kw = dict(mode=9, batch_size=B, width=W, height=H, seed=seed,
              warp_bank_impl="xla", **kw)
    return flowgen.DataGenConfig(**kw), flowgen_torch.DataGenConfig(**kw)


def _find_seed_step():
    _, tc = _cfgs()
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
def case():
    seed, step = _find_seed_step()
    return {"seed": seed, "step": step,
            "atlas": flowgen.procedural_atlas(N_TEX, height=H, width=W)}


def _jax_batch(case, **kw):
    jc, _ = _cfgs(case["seed"], **kw)
    root, step = j_root(case["seed"]), jnp.int32(case["step"])
    atlas = jnp.asarray(case["atlas"])
    if jc.render_impl == "windowed":
        bank = jax.jit(functools.partial(jg.make_warp_bank, cfg=jc))(root, step)
        out = j_generate(root, case["step"], atlas, jc, warp_bank=bank)
    else:
        bank, aux = jax.jit(functools.partial(jg.make_bank_and_aux, cfg=jc))(
            root, step)
        out = j_generate(root, case["step"], atlas, jc, warp_bank=bank,
                         warp_aux=aux)
    return {k: np.asarray(v) for k, v in out.items()}


def _gates(out, want):
    assert set(out) == set(want)
    dimg = [np.abs(out[k] - want[k]) for k in ("image0", "image1")]
    assert max((d >= 1).mean() for d in dimg) < 0.01
    assert max((d >= 2).mean() for d in dimg) < 1e-4
    nan_o, nan_w = np.isnan(out["flow0"]), np.isnan(want["flow0"])
    np.testing.assert_array_equal(nan_o, nan_w)
    d = np.abs(out["flow0"] - want["flow0"])[~nan_w]
    assert np.median(d) < 1e-4 and (d > 0.01).mean() < 1e-3


@pytest.mark.parametrize("render_impl", ["fused", "windowed"])
def test_generate_batch_meets_gates(case, render_impl):
    _, tc = _cfgs(case["seed"], render_impl=render_impl)
    out = t_generate(case["seed"], case["step"], case["atlas"], tc,
                     device="cpu")
    _gates({k: v.numpy() for k, v in out.items()},
           _jax_batch(case, render_impl=render_impl))


def test_generator_warp_oob_nan(case):
    """Generator's stream under warp_oob="nan": the step's batch meets the
    gates against the JAX package's, NaN pixels exactly where its are (at
    this size the crops reach no flagged pixel of the 384^2 fields, so
    there are none on either side)."""
    _, tc = _cfgs(case["seed"], warp_oob="nan")
    gen = flowgen_torch.Generator(tc, atlas=case["atlas"],
                                  start_step=case["step"], device="cpu")
    out = {k: v.numpy() for k, v in gen.retrieve_batch().items()}
    gen.stop()
    _gates(out, _jax_batch(case, warp_oob="nan"))
