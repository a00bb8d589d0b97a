"""Why the port's rigid flow is not the JAX package's bit for bit: XLA:CPU
contracts the scene kernel's flow overwrite in interpret mode.

``flowgen/ops/pallas_scene.py`` writes an object's flow as ``m00 * px +
m01 * py + m02 - px``; XLA:CPU evaluates it as ``fma(m00, px, m01 * py) +
m02 - px`` (and its y twin). The port's kernel (``csrc/scene.cu``, built
with ``-fmad=false``) and its plain version round every product on its own,
so its flow equals the JAX package's Mosaic form, not the interpret form.
Mode 4 (rotating objects) at 128x96, B=2: every flow value that differs
between the JAX package's interpret-mode render and the port's CPU render
is the contracted expression of the object that owns the pixel, and the
port's value there is the uncontracted one. About 55 s on one worker,
almost all of it the JAX render."""

import jax.numpy as jnp
import numpy as np
import torch

import flowgen
import flowgen_torch
from flowgen.pipeline.generator import generate_batch as j_generate
from flowgen.random.streams import root_key as j_root
from flowgen_torch import _fp
from flowgen_torch.compose import fused as tf
from flowgen_torch.ops import scene as ps
from flowgen_torch.params.sampler import sample_scene_batch
from flowgen_torch.pipeline.generator import make_slab_packer
from flowgen_torch.random.streams import root_key

torch.set_num_threads(1)

W, H, B = 128, 96, 2
SEED, STEP = 0, 0
N_TEX = 3


def _bits(a):
    return np.ascontiguousarray(a, np.float32).view(np.int32)


def test_flow_differs_only_by_the_contracted_overwrite():
    jc = flowgen.DataGenConfig(mode=4, batch_size=B, width=W, height=H)
    tc = flowgen_torch.DataGenConfig(mode=4, batch_size=B, width=W, height=H,
                                     emit_masks=True)
    atlas = flowgen.procedural_atlas(N_TEX, height=H, width=W)
    want = np.asarray(j_generate(j_root(SEED), STEP, jnp.asarray(atlas),
                                 jc)["flow0"])
    # The port's render of the same scenes, with each frame-0 pixel's owner
    # (its painter's id); generate_batch's flow0 is this flow.
    obj, bg, src, _ = make_slab_packer(tc, "cpu")(atlas)
    scenes = sample_scene_batch(root_key(SEED), STEP * B + torch.arange(B), tc)
    args, opts = tf.scene_tables(scenes, tc, obj, bg, src)
    _, flow, ids = ps.scene_render_plain(*args, **opts)
    got = flow[:, :2].permute(0, 2, 3, 1).numpy()
    owner = (ids[:, 0] - ps.FG_ID_BASE).long()

    differ = _bits(got) != _bits(want)
    assert differ.any()
    b, y, x, c = np.nonzero(differ)
    k = owner[b, y, x]
    assert bool((k >= 0).all()), "a background pixel's flow differs"
    m = args[2][b, k, 0, ps.OMF_MOTION:ps.OMF_MOTION + 6]
    row = torch.from_numpy(c).long() * 3
    a0, a1, a2 = (m.gather(1, (row + i)[:, None])[:, 0] for i in range(3))
    px = torch.from_numpy(x).float()
    py = torch.from_numpy(y).float()
    pos = torch.where(torch.from_numpy(c) == 0, px, py)
    contracted = (_fp.fma(a0, px, a1 * py) + a2) - pos
    separate = ((a0 * px + a1 * py) + a2) - pos
    np.testing.assert_array_equal(_bits(contracted.numpy()),
                                  _bits(want[differ]))
    np.testing.assert_array_equal(_bits(separate.numpy()), _bits(got[differ]))
