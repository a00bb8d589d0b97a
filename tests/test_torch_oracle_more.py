"""The port against its oracle copy, continued (``tests/test_torch_oracle.py``
holds modes 1, 5 and 7): mode 9 with a crop bank under the JAX package's
gates (``tests/test_oracle.py``), one row of ``tools/torch_epe_vs_oracle.py``
on the CPU (the scene kernel's plain version), and the examples'
command lines on the CPU."""

import os
import subprocess
import sys

import numpy as np
import torch

import flowgen_torch
from flowgen_torch.params.blueprint import map_scene
from flowgen_torch.random.streams import root_key
from flowgen_torch.reference_check import oracle
from flowgen_torch.utils import flow_io
from flowgen_torch.warpfields import generator as warpgen

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))

import torch_epe_vs_oracle as epe  # noqa: E402

W, H = 192, 160


def one_scene(cfg, seed, n_slots=1):
    """Sample 0 of ``root_key(seed)``, leaves without the batch axis."""
    scenes = flowgen_torch.sample_scene_batch(root_key(seed), torch.arange(1),
                                              cfg, n_warp_slots=n_slots)
    return map_scene(lambda t: t[0], scenes)


def test_renderer_matches_oracle_mode9():
    """Nonrigid parity: the oracle warps per-component u8 masks through the
    inverse field and textures in two stages; the port's renderer warps the
    combined coverage in one stage. Flow gating uses the unwarped frame-0
    mask in both, so flow parity stays tight; images absorb the warp-order
    and double-resample deviations statistically."""
    cfg = flowgen_torch.DataGenConfig(mode=9, batch_size=1, width=W, height=H)
    atlas_np = flowgen_torch.procedural_atlas(3, height=H, width=W)
    bank = warpgen.make_warp_bank(root_key(2), 0, cfg)
    scene = one_scene(cfg, 11, warpgen.bank_size(cfg))
    assert int((scene.objects.warp & scene.objects.valid).sum()) >= 2

    out = flowgen_torch.render_sample(
        scene, flowgen_torch.prepare_atlas(torch.from_numpy(atlas_np)), cfg,
        warp_bank=bank)
    bank_np = {"flow": bank.flow.numpy(), "iflow": bank.iflow.numpy()}
    _, o_img1, o_flow = oracle.render_scene_oracle(
        oracle.scene_to_numpy(scene), atlas_np, W, H, warp_bank=bank_np)

    flow = out.flow0.numpy()
    dflow = np.abs(flow - o_flow).max(-1)
    assert np.isfinite(flow).all()
    assert np.median(dflow) < 1e-3
    assert (dflow > 0.1).mean() < 0.01
    img1 = out.image1.numpy()
    assert np.median(np.abs(img1 - o_img1)) <= 3.0
    assert (np.abs(img1 - o_img1).mean(-1) < 8).mean() > 0.7


def test_epe_row_on_the_cpu():
    """The EPE tool's row, one mode-7 scene at 256x128 through the scene
    kernel's plain version: median EPE under 1e-4 px, as the table's."""
    row = epe.epe_row("7", 1, "cpu", height=128, width=256)
    assert row["scenes"] == 1 and row["pixels"] == 128 * 256
    assert row["median_epe"] < 1e-4
    assert row["max_epe_unflipped"] < 1e-3
    assert row["flipped_frac"] <= 1e-3


def test_generate_example_writes_a_sample(tmp_path):
    r = subprocess.run(
        [sys.executable, os.path.join(ROOT, "examples", "torch_generate.py"),
         "--device", "cpu", "--n", "1", "--batch", "1", "--out",
         str(tmp_path)],
        capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert "saved 1/1" in r.stdout
    flow = flow_io.read_flo(str(tmp_path / "00000-flow.flo"))
    assert flow.shape == (384, 512, 2) and np.isfinite(flow).all()
    for i in (0, 1):
        img = flow_io.read_ppm(str(tmp_path / f"00000-{i}.ppm"))
        assert img.shape == (384, 512, 3)


def test_train_example_runs(tmp_path):
    r = subprocess.run(
        [sys.executable, os.path.join(ROOT, "examples",
                                      "torch_train_flownet.py"),
         "--device", "cpu", "--steps", "2", "--batch", "1", "--height", "64",
         "--width", "128", "--model-width", "4"],
        capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    lines = r.stdout.splitlines()
    assert lines[-1] == "done" and len(lines) == 3
    assert all(np.isfinite(float(ln.split()[3])) for ln in lines[:2])
