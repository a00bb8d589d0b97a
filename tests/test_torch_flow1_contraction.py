"""Why the port's mode-9 inverse flow is not the JAX package's bit for bit
(the ``9_inverse`` row of the EPE tables): XLA:CPU contracts the scene
kernel's frame-1 flow overwrite in interpret mode, as it does frame 0's
(tests/test_torch_flow_contraction.py).

``flowgen/ops/pallas_scene.py`` writes an object's inverse flow as ``m00 *
px + m01 * py + m02 - px`` with the frame-1 motion, for a rigid object in
``standard()`` and for a deforming one under its warped binary mask;
XLA:CPU evaluates it as ``fma(m00, px, m01 * py) + m02 - px`` (and its y
twin). The port (``csrc/scene.cu`` with ``-fmad=false``, and its plain
version) rounds each product on its own. Mode 9 with inverse flow at
128x96, B=2, seed 0, step 0 (9 deforming objects): every flow1 value that
differs between the JAX package's interpret-mode render and the port's CPU
render on the same bank and warp planes is the contracted expression of
the object that owns the pixel in frame 1, the port's value there is the
uncontracted one, and objects of both kinds have such values. No
background value and no mask (the deforming objects' warped coverage,
whose lerps XLA:CPU also contracts) differs. About 50 s on one worker,
almost all of it the JAX render."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

import flowgen
import flowgen_torch
from flowgen.pipeline.generator import generate_batch as j_generate
from flowgen.random.streams import root_key as j_root
from flowgen.warpfields import generator as jg
from flowgen_torch import _fp
from flowgen_torch.compose import fused as tf
from flowgen_torch.interop import aux_from_numpy
from flowgen_torch.ops import scene as ps
from flowgen_torch.params.sampler import sample_scene_batch
from flowgen_torch.pipeline.generator import make_slab_packer
from flowgen_torch.random.streams import root_key
from flowgen_torch.warpfields import generator as tg

torch.set_num_threads(1)

W, H, B = 128, 96, 2
SEED, STEP = 0, 0
N_TEX = 3


def _bits(a):
    return np.ascontiguousarray(a, np.float32).view(np.int32)


def test_inverse_flow_differs_only_by_the_contracted_overwrite():
    kw = dict(mode=9, batch_size=B, width=W, height=H,
              compute_inverse_flow=True)
    jc = flowgen.DataGenConfig(**kw)
    tc = flowgen_torch.DataGenConfig(**kw, emit_masks=True)
    atlas = flowgen.procedural_atlas(N_TEX, height=H, width=W)
    bank, aux = jax.jit(lambda r: jg.make_bank_and_aux(r, STEP, jc))(
        j_root(SEED))
    want = np.asarray(j_generate(j_root(SEED), STEP, jnp.asarray(atlas), jc,
                                 warp_bank=bank, warp_aux=aux)["flow1"])
    # The port's render of the same scenes on the same warp planes, with
    # each frame-1 pixel's owner; generate_batch's flow1 is this flow.
    obj, bg, src, _ = make_slab_packer(tc, "cpu")(atlas)
    scenes = sample_scene_batch(root_key(SEED), STEP * B + torch.arange(B), tc,
                                n_warp_slots=tg.bank_size(tc))
    assert int((scenes.objects.warp & scenes.objects.valid).sum()) >= 2
    args, opts = tf.scene_tables(scenes, tc, obj, bg, src,
                                 warp_aux=aux_from_numpy(
                                     tuple(np.asarray(a) for a in aux)))
    _, flow, ids = ps.scene_render_plain(*args, **opts)
    got = flow[:, 2:4].permute(0, 2, 3, 1).numpy()
    owner = (ids[:, 1] - ps.FG_ID_BASE).long()

    differ = _bits(got) != _bits(want)
    assert differ.any()
    b, y, x, c = np.nonzero(differ)
    k = owner[b, y, x]
    assert bool((k >= 0).all()), "a background pixel's flow1 differs"
    bt = torch.from_numpy(b).long()
    m = args[2][bt, k, 1, ps.OMF_MOTION:ps.OMF_MOTION + 6]
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
    # Both kinds of owner: rigid objects and deforming ones (OMI_WARP).
    deforming = args[1][bt, k, 1, ps.OMI_WARP] != 0
    assert bool(deforming.any()) and not bool(deforming.all())
