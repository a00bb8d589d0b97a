"""``register_mode`` in the port against the JAX package's: the custom
recipe of tests/test_custom_mode.py (mode 7 with translations of +-300 px,
ellipses only, no thin objects), registered in both packages under one id
and rendered from the same seed at 128x96, B=2. The sampled scenes are the
same, integer tables exactly; the batches meet the JAX package's on-device
gates (tools/check_pallas_tpu.py): under 1% of image values >= 1 level
apart and under 1e-4 >= 2 levels; flow median |d| < 1e-4 px and under 1e-3
of values with |d| > 0.01 px (the rigid flow overwrite that XLA:CPU
contracts, tests/test_torch_flow_contraction.py, keeps them from bit
equality). The mode is removed from both registries afterwards. About
40 s on one worker, almost all of it the JAX interpret-mode render."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flowgen
import flowgen_torch
from flowgen.params.sampler import sample_scene_batch as j_sample
from flowgen.random.streams import root_key as j_root
from flowgen_torch.params.sampler import sample_scene_batch as t_sample
from flowgen_torch.pipeline.generator import generate_batch as t_generate
from flowgen_torch.random.streams import root_key

torch.set_num_threads(1)

MODE = 121
W, H, B = 128, 96, 2


@pytest.fixture(scope="module")
def registered():
    assert MODE not in flowgen.MODES and MODE not in flowgen_torch.MODES
    ids = []
    try:
        for pkg in (flowgen, flowgen_torch):
            spec = dataclasses.replace(
                pkg.MODES[7], mode=MODE, obj_trans_range=(-300.0, 300.0),
                obj_types=(pkg.KIND_ELLIPSE,), use_thin=False)
            ids.append(pkg.register_mode(spec))
            with pytest.raises(ValueError):
                pkg.register_mode(spec)
        yield ids
    finally:
        flowgen.MODES.pop(MODE, None)
        flowgen_torch.MODES.pop(MODE, None)


def test_custom_mode_matches_jax(registered):
    assert registered == [MODE, MODE]
    jc = flowgen.DataGenConfig(mode=MODE, batch_size=B, width=W, height=H)
    tc = flowgen_torch.DataGenConfig(mode=MODE, batch_size=B, width=W,
                                     height=H)
    js = j_sample(j_root(0), jnp.arange(B), jc)
    ts = t_sample(root_key(0), torch.arange(B), tc)
    for part, name in (("objects", "valid"), ("objects", "tex_id"),
                       ("prims", "valid"), ("prims", "is_poly"),
                       ("prims", "n_edges")):
        np.testing.assert_array_equal(
            getattr(getattr(ts, part), name).numpy(),
            np.asarray(getattr(getattr(js, part), name)))
    # Ellipses only: no valid primitive is a polygon.
    assert not bool(ts.prims.is_poly[ts.prims.valid].any())

    atlas = flowgen.procedural_atlas(2, height=H, width=W)
    want = jax.tree.map(np.asarray, flowgen.make_generate_fn(jc)(
        j_root(0), jnp.int32(0), jnp.asarray(atlas)))
    got = {k: v.numpy() for k, v in
           t_generate(0, 0, atlas, tc, device="cpu").items()}
    assert set(got) == set(want)
    for k in ("image0", "image1"):
        d = np.abs(got[k].astype(np.float32) - want[k].astype(np.float32))
        assert (d >= 1).mean() < 0.01 and (d >= 2).mean() < 1e-4
    d = np.abs(got["flow0"] - want["flow0"])
    assert np.isfinite(got["flow0"]).all()
    assert np.median(d) < 1e-4 and (d > 0.01).mean() < 1e-3
