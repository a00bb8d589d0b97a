#!/usr/bin/env python3
"""Launch bounds of the port's scene kernel, by measurement on one NVIDIA GPU.

    python3 tools/torch_scene_launch_bounds.py [RIGID,WARP ...]

Builds flowgen_torch/csrc/scene.cu once per pair of minimum CTAs an SM
(FLOWGEN_SCENE_CTAS_RIGID for scene_kernel<false>, FLOWGEN_SCENE_CTAS_WARP
for scene_kernel<true>; one nvcc each, all started together), prints each
build's registers and spills, and times the kernel on step 0's B=64 tables
of modes 7, 13 (with inverse flow and ids) and 9 at 512x384, each build in
turn and then again in reverse order, by CUDA events queued behind a spin
(chip_smoke.py:event_ms), with the card's name and power limit. Every
launch is held to the default build's output, bit for bit. Default pairs:
3,2 4,3 5,3 6,4 4,2 4,4 4,5. It needs the repository, a CUDA card and nvcc.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from flowgen_torch.ops import _build  # noqa: E402

DEFAULT = ("3,2", "4,3", "5,3", "6,4", "4,2", "4,4", "4,5")


def start(rigid: int, warp: int):
    """Start nvcc for one pair: (pair, target path, process)."""
    out = _build.build_dir() / "launch_bounds"
    out.mkdir(parents=True, exist_ok=True)
    target = out / f"libflowgen_scene_r{rigid}_w{warp}.so"
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS,
           f"-DFLOWGEN_SCENE_CTAS_RIGID={rigid}",
           f"-DFLOWGEN_SCENE_CTAS_WARP={warp}", "-o", str(target),
           str(_build.CSRC / "scene.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return (rigid, warp), target, proc


def use(lib):
    """Make ops/scene.py launch through ``lib``."""
    _build._loaded["flowgen_scene"] = lib
    _build.load_scene_library()


def tables(dev):
    """Step 0's scene-kernel inputs (args, options) of modes 7, 13 and 9."""
    import flowgen_torch
    from flowgen_torch.compose import fused
    from flowgen_torch.pipeline.generator import make_slab_packer
    from flowgen_torch.random.streams import root_key
    from flowgen_torch.warpfields import generator as wg

    out = {}
    for mode, kw in ((7, {}), (13, dict(compute_inverse_flow=True,
                                        emit_masks=True)), (9, {})):
        cfg = flowgen_torch.DataGenConfig(mode=mode, batch_size=64, seed=0,
                                          **kw)
        slabs = make_slab_packer(cfg, dev)(
            cs.procedural_atlas(cfg.height, cfg.width))
        aux, n_slots = None, 1
        if mode == 9:
            n_slots = wg.bank_size(cfg)
            _, aux = wg.make_bank_and_aux(root_key(cfg.seed, dev), 0, cfg)
        scenes = cs.sample(cfg, cfg.seed, torch.arange(64), dev, n_slots)
        out[mode] = fused.scene_tables(scenes, cfg, *slabs, aux)
    return out


def main():
    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is false: this needs a GPU")
    from flowgen_torch.ops import scene as ps

    pairs = [tuple(int(v) for v in a.split(",")) for a in
             (sys.argv[1:] or DEFAULT)]
    card = cs.card_line()
    print(card)
    started = [start(*pr) for pr in pairs]
    libs = {}
    for pr, target, proc in started:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            cs.fail(f"nvcc failed for {pr}:\n{log}")
        libs[pr] = ctypes.CDLL(str(target))
        print(f"build rigid {pr[0]}, warp {pr[1]}: "
              + "; ".join(ln for ln in cs.ptxas_summary(log)
                          if "registers" in ln or "spill" in ln))
    dev = torch.device("cuda")
    tabs = tables(dev)
    want = {}
    use(ctypes.CDLL(str(_build.build("flowgen_scene"))))
    for mode, (args, opts) in tabs.items():
        want[mode] = ps.scene_render(*args, **opts)
    ms = {pr: {m: [] for m in tabs} for pr in pairs}
    for order in (pairs, pairs[::-1]):
        for pr in order:
            use(libs[pr])
            for mode, (args, opts) in tabs.items():
                got = ps.scene_render(*args, **opts)
                for g, w in zip(got, want[mode]):
                    if g is not None and not torch.equal(
                            g.view(torch.int32), w.view(torch.int32)):
                        cs.fail(f"build {pr} differs in mode {mode}")
                ms[pr][mode].append(
                    cs.event_ms(lambda: ps.scene_render(*args, **opts)))
    rows = []
    for pr in pairs:
        row = {"rigid_ctas": pr[0], "warp_ctas": pr[1],
               **{f"mode{m}_ms": v for m, v in ms[pr].items()}}
        rows.append(row)
        print(json.dumps(row) + f" [{card}]")
    print(json.dumps({"launch_bounds": rows, "card": card}))


if __name__ == "__main__":
    main()
