"""The port's renderer against its copy of the scalar numpy oracle
(``flowgen_torch/reference_check/oracle.py``), under the JAX package's own
gates (``tests/test_oracle.py``): the windowed ``render_sample`` at 192x160
in modes 1, 5 and 7. Mode 9, the EPE tool's row and the examples are in
``tests/test_torch_oracle_more.py``, so that two workers share the oracle's
scalar loops.

The oracle follows the reference's literal order of operations
(materialized 2Wx2H background, whole-texture warps, per-object masks,
sequential blits); flow is analytic in both and must agree tightly, images
go through different resampling chains and are compared statistically."""

import os

import numpy as np
import pytest
import torch

import flowgen_torch
from flowgen_torch.params.blueprint import map_scene
from flowgen_torch.random.streams import root_key
from flowgen_torch.reference_check import oracle

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W, H = 192, 160


def test_oracle_copy_is_byte_equal():
    """The port keeps its own copy (importing the JAX package's would import
    JAX), pinned byte for byte to the original."""
    for name in ("oracle.py", "__init__.py"):
        with open(os.path.join(ROOT, "flowgen", "reference_check", name),
                  "rb") as f:
            want = f.read()
        with open(os.path.join(ROOT, "flowgen_torch", "reference_check",
                               name), "rb") as f:
            assert f.read() == want, name


def one_scene(cfg, seed, n_slots=1):
    """Sample 0 of ``root_key(seed)``: one scene, leaves without the batch
    axis (the JAX tests' ``sample_scene(sample_key(root_key(seed), 0))``)."""
    scenes = flowgen_torch.sample_scene_batch(root_key(seed), torch.arange(1),
                                              cfg, n_warp_slots=n_slots)
    return map_scene(lambda t: t[0], scenes)


@pytest.mark.parametrize("mode", [1, 5, 7])
def test_renderer_matches_oracle(mode):
    cfg = flowgen_torch.DataGenConfig(mode=mode, batch_size=1, width=W,
                                      height=H)
    atlas_np = flowgen_torch.procedural_atlas(3, height=H, width=W)
    scene = one_scene(cfg, 7)
    out = flowgen_torch.render_sample(
        scene, flowgen_torch.prepare_atlas(torch.from_numpy(atlas_np)), cfg)
    o_img0, o_img1, o_flow = oracle.render_scene_oracle(
        oracle.scene_to_numpy(scene), atlas_np, W, H)

    dflow = np.abs(out.flow0.numpy() - o_flow).max(-1)
    assert np.median(dflow) < 1e-3
    assert (dflow > 0.1).mean() < 0.01
    img0, img1 = out.image0.numpy(), out.image1.numpy()
    assert np.median(np.abs(img0 - o_img0)) <= 2.0
    assert np.median(np.abs(img1 - o_img1)) <= 3.0
    assert (np.abs(img0 - o_img0).mean(-1) < 8).mean() > 0.8
