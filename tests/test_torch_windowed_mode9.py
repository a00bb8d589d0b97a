"""The port's windowed renderer in mode 9 against the JAX package on the CPU,
at 256x196 with B=2: height 196 is not a multiple of 8, so both render
through the windowed renderer, and both window classes fit the frame. Its
big field would be 768^2, a multiple of 128 as the bank kernels need (at
300x200 it would be 900^2); the bank itself is held bit-equal to the JAX
package's by tests/test_torch_warpfields.py, so here both renderers take one
seeded, smooth numpy bank (with NaN-flagged texels, which the renderer
scrubs), carried across by ``interop.bank_from_numpy``. The seed is the
first whose two samples hold at least two deforming objects and a
deforming background.

Non-deforming objects take ``object_window`` and deforming ones the composed
branch, with ``polygon_coverage`` under ``use_pallas="always"`` (the plain
versions on the CPU); the JAX side runs its composed branch. Gates as in
tests/test_torch_windowed.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flowgen
import flowgen_torch
from flowgen.compose.render import WarpBank as JWarpBank
from flowgen.pipeline.generator import generate_batch as j_generate
from flowgen.random.streams import root_key as j_root
from flowgen_torch.interop import bank_from_numpy
from flowgen_torch.params.sampler import sample_scene_batch as t_sample
from flowgen_torch.pipeline.generator import generate_batch as t_generate
from flowgen_torch.random.streams import root_key as t_root
from flowgen_torch.warpfields import generator as tg
from test_torch_windowed import assert_gates

torch.set_num_threads(1)

W, H, B = 256, 196, 2
N_TEX = 3
OUTPUTS = {"flow0": {}, "flow1_masks": dict(compute_inverse_flow=True,
                                       emit_masks=True)}


def _cfg(pkg, seed, outputs, **kw):
    return pkg.DataGenConfig(mode=9, batch_size=B, width=W, height=H,
                             seed=seed, **OUTPUTS[outputs], **kw)


def _smooth_bank(n, seed=0):
    """(n, H, W, 2) forward and inverse fields: a few low-frequency waves
    per slot, up to ~12 px, the inverse roughly the negated forward field,
    with a few NaN texels in both."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    out = []
    for _ in range(2):
        f = np.zeros((n, H, W, 2), np.float32)
        for c in range(2):
            for _ in range(3):
                kx, ky = rng.uniform(0.005, 0.03, (2, n, 1, 1))
                ph = rng.uniform(0, 2 * np.pi, (n, 1, 1))
                amp = rng.uniform(1.0, 4.0, (n, 1, 1))
                f[..., c] += (amp * np.sin(kx * xx + ky * yy + ph)).astype(
                    np.float32)
        out.append(f)
    flow, iflow = out[0], -out[0] + 0.1 * out[1]
    for f in (flow, iflow):
        idx = rng.integers(0, [n, H, W], (40, 3))
        f[idx[:, 0], idx[:, 1], idx[:, 2]] = np.nan
    return flow, iflow.astype(np.float32)


def _find_seed(tc):
    n_slots = tg.bank_size(tc)
    for seed in range(40):
        sc = t_sample(t_root(seed), torch.arange(B), tc, n_warp_slots=n_slots)
        if (int((sc.objects.warp & sc.objects.valid).sum()) >= 2
                and int(sc.background.warp.sum()) >= 1):
            return seed
    raise AssertionError("no seed with deforming objects and background")


@pytest.fixture(scope="module")
def setup():
    seed = _find_seed(_cfg(flowgen_torch, 0, "flow0"))
    tc = _cfg(flowgen_torch, seed, "flow0")
    flow, iflow = _smooth_bank(tg.bank_size(tc))
    return {"seed": seed, "np_bank": (flow, iflow),
            "atlas": flowgen.procedural_atlas(N_TEX, height=H, width=W),
            "ref": {}}


def _jax_ref(setup, outputs):
    if outputs not in setup["ref"]:
        jc = _cfg(flowgen, setup["seed"], outputs)
        bank = JWarpBank(*(jnp.asarray(a) for a in setup["np_bank"]))
        out = j_generate(j_root(setup["seed"]), 0, jnp.asarray(setup["atlas"]),
                         jc, warp_bank=bank)
        setup["ref"][outputs] = {k: np.asarray(v) for k, v in out.items()}
    return setup["ref"][outputs]


def _port(setup, cfg):
    flow, iflow = setup["np_bank"]
    bank = bank_from_numpy(JWarpBank(flow, iflow))
    return {k: v.numpy() for k, v in t_generate(
        setup["seed"], 0, setup["atlas"], cfg, device="cpu",
        warp_bank=bank).items()}


@pytest.mark.parametrize("outputs", list(OUTPUTS))
def test_generate_batch_meets_gates(setup, outputs):
    cfg = _cfg(flowgen_torch, setup["seed"], outputs)
    assert_gates(_port(setup, cfg), _jax_ref(setup, outputs))


@pytest.mark.parametrize("outputs", list(OUTPUTS))
def test_plain_kernel_versions_meet_gates(setup, outputs):
    cfg = _cfg(flowgen_torch, setup["seed"], outputs, use_pallas="always")
    assert_gates(_port(setup, cfg), _jax_ref(setup, outputs))


def test_bank_deforms_the_render(setup):
    """The bank moves the output: the same scenes with a zero bank differ
    from those with the smooth one in both frames and the flow."""
    cfg = _cfg(flowgen_torch, setup["seed"], "flow0")
    flow, iflow = setup["np_bank"]
    zero = bank_from_numpy(JWarpBank(np.zeros_like(flow), np.zeros_like(iflow)))
    a = _port(setup, cfg)
    b = {k: v.numpy() for k, v in t_generate(
        setup["seed"], 0, setup["atlas"], cfg, device="cpu",
        warp_bank=zero).items()}
    for k in ("image1", "flow0"):
        assert (np.abs(a[k] - b[k]) > 1).mean() > 1e-3, k
