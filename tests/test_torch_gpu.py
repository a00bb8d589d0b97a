"""The port's CUDA scene kernel against its plain PyTorch version, on the
card. Every test is marked ``gpu`` and skips where no CUDA device exists;
whether one exists is decided inside each test. This file imports neither
JAX nor the JAX package, so it also runs on a machine without them:

    python -m pytest tests/test_torch_gpu.py -q --noconftest
"""

import pytest
import torch

import flowgen_torch
from flowgen_torch.compose import fused
from flowgen_torch.ops import scene as ps
from flowgen_torch.params.sampler import sample_scene_batch
from flowgen_torch.pipeline.generator import generate_batch, make_slab_packer
from flowgen_torch.random.streams import root_key

torch.set_num_threads(1)

pytestmark = pytest.mark.gpu


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the scene kernel has no CPU mode)")


def _tables(cfg, seed, dev):
    atlas = flowgen_torch.procedural_atlas(4, height=cfg.height, width=cfg.width)
    obj, bg, src = make_slab_packer(cfg, dev)(atlas)
    scenes = sample_scene_batch(root_key(seed, dev),
                                torch.arange(cfg.batch_size, device=dev), cfg)
    args, key, _ = fused.scene_tables(scenes, cfg, obj, bg, src)
    return args, key


@pytest.mark.parametrize("mode,width,height,batch", [
    (7, 128, 96, 2), (7, 512, 384, 1), (1, 256, 192, 2), (5, 512, 384, 1),
])
def test_scene_kernel_matches_plain(mode, width, height, batch):
    _need_card()
    cfg = flowgen_torch.DataGenConfig(mode=mode, batch_size=batch,
                                      width=width, height=height)
    args, key = _tables(cfg, 3, torch.device("cuda"))
    before = ps.scene_render.launches
    kf, kl = ps.scene_render(*args, spec_key=key)
    torch.cuda.synchronize()
    assert ps.scene_render.launches == before + 1
    pf, pl = ps.scene_render_plain(*args, spec_key=key)
    assert (kf != pf).float().mean().item() < 1e-4
    d = (kl - pl).abs()
    assert d.flatten().median().item() < 1e-4
    assert (d > 0.01).float().mean().item() < 1e-3


def test_generate_batch_cuda_matches_cpu():
    _need_card()
    cfg = flowgen_torch.DataGenConfig(mode=7, batch_size=2, width=128, height=96)
    atlas = flowgen_torch.procedural_atlas(4, height=96, width=128)
    g = generate_batch(0, 0, atlas, cfg, device="cuda")
    c = generate_batch(0, 0, atlas, cfg, device="cpu")
    for k in ("image0", "image1"):
        assert (g[k].cpu() - c[k]).abs().ge(1).float().mean().item() < 0.01
    d = (g["flow0"].cpu() - c["flow0"]).abs()
    assert d.flatten().median().item() < 1e-4
