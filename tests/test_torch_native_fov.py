"""Mixed-resolution renders of a TextureDB through the port's scene kernel
path against the JAX package's, on the CPU.

The sources of ``tests/test_native_fov.py`` (a canonical-size, a small and
a large one) at 128x96, B=2: the port's scene tables and the kernel's plain
version, with each sample's background source at its native size (its own
crop chain and reflect period), against the JAX package's
``render_batch_fused`` with ``tex_sizes`` (its kernel in interpret mode), in
modes 5 and 13 (quadrant slabs of ``obj_tex``). Held to the gates of
``tools/check_pallas_tpu.py``: images under 1% of values >= 1 level apart
and under 1e-4 >= 2 levels, flow median |d| < 1e-4 px and under 1e-3 of
values with |d| > 0.01 px."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flowgen
import flowgen_torch
from flowgen import texture_io as jtex
from flowgen.compose.fused import render_batch_fused as j_render
from flowgen.ops.pallas_scene import prepare_bg_slabs_db as j_bg_db
from flowgen.ops.pallas_scene import prepare_obj_slabs as j_obj
from flowgen.params.sampler import sample_scene_batch as j_sample
from flowgen.random.streams import root_key as j_root
from flowgen_torch.compose.fused import render_batch_fused as t_render
from flowgen_torch.interop import scene_from_numpy, texture_db_from_numpy
from flowgen_torch.ops.scene import prepare_bg_slabs_db, prepare_obj_slabs
from flowgen_torch.pipeline.generator import make_slab_packer

torch.set_num_threads(1)

W, H = 128, 96


@pytest.fixture(scope="module")
def db():
    rng = np.random.default_rng(0)

    def tex(h, w):
        base = rng.integers(0, 255, (h // 8 + 1, w // 8 + 1, 3), np.uint8)
        return np.kron(base, np.ones((8, 8, 1), np.uint8))[:h, :w]

    return jtex.build_texture_db(
        [tex(2 * H, 2 * W), tex(150, 170), tex(400, 520)], height=H, width=W)


@pytest.mark.parametrize("mode", [5, 13])
def test_mixed_resolution_render_matches_jax(db, mode):
    """Samples 2-3 of seed 21 draw their backgrounds from the large and the
    small source, so both crop chains and both reflect periods run."""
    jc = flowgen.DataGenConfig(mode=mode, batch_size=2, width=W, height=H)
    tc = flowgen_torch.DataGenConfig(mode=mode, batch_size=2, width=W,
                                     height=H)
    quad = mode == 13
    scenes = jax.jit(lambda r, i: j_sample(r, i, jc, n_warp_slots=1))(
        j_root(21), jnp.arange(2, 4))
    assert sorted(np.asarray(scenes.background.tex_id) % 3) == [1, 2]
    want = [np.asarray(x) for x in j_render(
        scenes, j_obj(jnp.asarray(db.obj_tex), quadrant=quad),
        j_bg_db(db.sources, db.sizes), (2 * H, 2 * W), jc, interpret=True,
        tex_sizes=jnp.asarray(db.sizes))]
    tdb = texture_db_from_numpy(db)
    ts = scene_from_numpy(jax.tree.map(np.asarray, scenes))
    sizes = torch.from_numpy(tdb.sizes)
    obj = prepare_obj_slabs(torch.from_numpy(tdb.obj_tex), quadrant=quad)
    bg = prepare_bg_slabs_db(torch.from_numpy(tdb.sources), sizes)
    got = [x.numpy() for x in t_render(ts, obj, bg, (2 * H, 2 * W), tc,
                                       tex_sizes=sizes)]
    for k in range(2):
        d = np.abs(got[k] - want[k])
        assert (d >= 1).mean() < 0.01 and (d >= 2).mean() < 1e-4
    d = np.abs(got[2] - want[2])
    assert np.median(d) < 1e-4 and (d > 0.01).mean() < 1e-3
    # The generator's slab packer hands over the same slabs and sizes;
    # without the sizes the backgrounds take the canonical geometry and
    # look different.
    obj_p, bg_p, hw_p, sizes_p = make_slab_packer(tc, torch.device("cpu"))(
        tdb)
    packed = t_render(ts, obj_p, bg_p, hw_p, tc, tex_sizes=sizes_p)
    assert all(torch.equal(a, torch.from_numpy(b))
               for a, b in zip(packed, got))
    canon = t_render(ts, obj, bg, (2 * H, 2 * W), tc)
    assert np.abs(canon[0].numpy() - got[0]).mean() > 5.0
