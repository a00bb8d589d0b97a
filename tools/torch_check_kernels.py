#!/usr/bin/env python3
"""On-card correctness check of the port's kernels, per rendering mode: the
port's twin of ``tools/check_pallas_tpu.py``, with its seeds, sizes and
gates (512x384, B=4, seed 3, the 4-texture procedural atlas).

Two comparisons a mode:

1. **Card against CPU** (``card_vs_cpu``): ``generate_batch`` of step 0 on
   the card, through the CUDA kernels, against the same call on the CPU,
   through their plain PyTorch versions. This is the port's content
   contract: the same ``(seed, step, cfg)`` gives the same batch on either
   device (the JAX tool holds Mosaic against the interpreter here).
   Gates: images under 1% of values >= 1 level apart and under 1e-4 >= 2
   levels; every flow (``flow0``, and ``disparity`` in the horizontal-only
   modes) median |d| < 1e-4 px and under 1e-3 of values > 0.01 px. The
   largest differences and the count of values whose bits differ are
   recorded beside them (0 expected).
2. **Fused against windowed** (``fused_vs_windowed``), both on the card:
   step 1 through the scene kernel against ``render_impl="windowed"``
   (the window kernels). The two renderers resample through different
   chains, so images compare by their median difference (<= 1 level);
   flow must be equal in the rigid modes, and in mode 9 (two displacement
   warp formulations) have a median under 1e-3 px and under 2% of values
   over 0.1 px.

The pseudo-mode ``bank`` holds the card's ``make_bank_and_aux`` (the bank
kernels) against the CPU's at the 128x96 frame's field (384^2), from the
same seed-3 keys: NaN masks mismatched on under 1e-4 of values, and the
flow gate.

``kernel_vs_plain`` (used by ``chip_smoke.py``) holds the scene kernel
against its plain version with both on the card, on the same tables.

Modes 107 and 109 are ``disparity_mode(7)`` and ``disparity_mode(9)``.
Results are written after every mode, merged into the file, in
``PALLAS_CHECK_r05.json``'s shape: ``{"results": {mode: {...}}, "ok": ...}``,
with the card's name and power limit.

Usage: python3 tools/torch_check_kernels.py [--json OUT] [mode|bank ...]
Default: modes 1-13, 107, 109 and bank.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

SEED = 3
BATCH = 4
DEFAULT_MODES = [str(m) for m in range(1, 14)] + ["107", "109", "bank"]


def config(mode: int, **kw):
    """The check's configuration of ``mode`` (a disparity variant 1xx is
    registered first)."""
    import flowgen_torch

    if mode > 100:
        flowgen_torch.disparity_mode(mode - 100)
    return flowgen_torch.DataGenConfig(mode=mode, batch_size=BATCH, seed=SEED,
                                       **kw)


def _atlas(cfg):
    import flowgen_torch

    return flowgen_torch.procedural_atlas(4, height=cfg.height, width=cfg.width)


def _bits_unequal(a, b) -> int:
    a, b = a.cpu(), b.cpu()
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return int((a != b).sum())


def output_gates(a: dict, b: dict) -> dict:
    """The JAX tool's gates between two batches (dicts of tensors): images
    (``image0``, ``image1``) and every flow (``flow0``, ``flow1``,
    ``disparity``); the largest differences and the count of values whose
    bits differ; masks and ids by their mismatched fraction (< 1e-4)."""
    imgs = [(a[k].cpu() - b[k].cpu()).abs() for k in ("image0", "image1")]
    flows = [k for k in ("flow0", "flow1", "disparity") if k in a]
    dflow = torch.cat([(a[k].cpu() - b[k].cpu()).abs().flatten()
                       for k in flows])
    res = {
        "flow_median": float(dflow.median()),
        "flow_frac_gt_0.01": float((dflow > 0.01).float().mean()),
        "flow_max": float(dflow.max()),
        "img_frac_ge_1": max(float((d >= 1).float().mean()) for d in imgs),
        "img_frac_ge_2": max(float((d >= 2).float().mean()) for d in imgs),
        "img_max": max(float(d.max()) for d in imgs),
        "flows": flows,
        "bits_unequal": sum(_bits_unequal(a[k], b[k]) for k in a),
    }
    ok = (res["flow_median"] < 1e-4 and res["flow_frac_gt_0.01"] < 1e-3
          and res["img_frac_ge_1"] < 0.01 and res["img_frac_ge_2"] < 1e-4
          and set(a) == set(b))
    for k in ("ids", "occlusion", "motion_boundary"):
        if k in a:
            res[f"{k}_mismatch"] = float((a[k].cpu() != b[k].cpu())
                                         .float().mean())
            ok = ok and res[f"{k}_mismatch"] < 1e-4
    res["ok"] = bool(ok)
    return res


def card_vs_cpu(mode: int, dev) -> dict:
    """Check 1: step 0 through the kernels on ``dev`` against the plain
    versions on the CPU."""
    from flowgen_torch.pipeline.generator import generate_batch

    cfg = config(mode)
    atlas = _atlas(cfg)
    card = generate_batch(SEED, 0, atlas, cfg, device=dev)
    cpu = generate_batch(SEED, 0, atlas, cfg, device="cpu")
    return output_gates(card, cpu)


def _kernel_outputs(out):
    from flowgen_torch.compose.fused import masks_from_ids
    from flowgen_torch.ops.resample import unpack_rgb

    frames, flow, ids = out
    d = {"image0": torch.stack(unpack_rgb(frames[:, 0]), -1),
         "image1": torch.stack(unpack_rgb(frames[:, 1]), -1),
         "flow0": flow[:, 0:2].permute(0, 2, 3, 1)}
    if flow.shape[1] == 4:
        d["flow1"] = flow[:, 2:4].permute(0, 2, 3, 1)
    if ids is not None:
        d["ids"] = ids
        d["occlusion"], d["motion_boundary"] = masks_from_ids(
            ids, flow[:, 0], flow[:, 1])
    return d


def kernel_vs_plain(mode: int, dev) -> dict:
    """The scene kernel against its plain version, both on ``dev``, on the
    tables of step 0 (with inverse flow and id images)."""
    import dataclasses

    from flowgen_torch.compose import fused
    from flowgen_torch.ops import scene as ps
    from flowgen_torch.params.sampler import sample_scene_batch
    from flowgen_torch.pipeline.generator import make_slab_packer
    from flowgen_torch.random.streams import root_key
    from flowgen_torch.warpfields import generator as warpgen

    cfg = dataclasses.replace(config(mode), compute_inverse_flow=True,
                              emit_masks=True)
    root = root_key(SEED, dev)
    aux, n_slots = None, 1
    if cfg.mode_spec.warp_p > 0.0:
        aux = warpgen.make_bank_and_aux(root, 0, cfg)[1]
        n_slots = warpgen.bank_size(cfg)
    scenes = sample_scene_batch(root, torch.arange(BATCH, device=dev), cfg,
                                n_warp_slots=n_slots)
    slabs = make_slab_packer(cfg, dev)(_atlas(cfg))
    args, opts = fused.scene_tables(scenes, cfg, *slabs, aux)
    kern = _kernel_outputs(ps.scene_render(*args, **opts))
    plain = _kernel_outputs(ps.scene_render_plain(*args, **opts))
    return output_gates(kern, plain)


def fused_vs_windowed(mode: int, dev) -> dict:
    """Check 2: step 1 through the scene kernel against the windowed
    renderer (window kernels), both on ``dev``."""
    from flowgen_torch.pipeline.generator import make_generate_fn

    cfg = config(mode)
    atlas = _atlas(cfg)
    outs = [make_generate_fn(config(mode, render_impl=impl), dev)(
                SEED, 1, atlas) for impl in ("fused", "windowed")]
    dflow = (outs[0]["flow0"] - outs[1]["flow0"]).abs().cpu()
    dimg = [(outs[0][k] - outs[1][k]).abs().cpu() for k in ("image0", "image1")]
    img_med = max(float(d.median()) for d in dimg)
    if cfg.mode_spec.warp_p > 0.0:
        flow_dev = float(dflow.median())
        okf = flow_dev < 1e-3 and float((dflow > 0.1).float().mean()) < 0.02
    else:
        flow_dev = float(dflow.max())
        okf = flow_dev == 0.0
    return {"flow_dev": flow_dev, "flow_max": float(dflow.max()),
            "img_median": img_med,
            "img_frac_ge_4_informational": max(
                float((d >= 4).float().mean()) for d in dimg),
            "ok": bool(okf and img_med <= 1.0)}


def bank_check(dev) -> dict:
    """The bank kernels: ``make_bank_and_aux`` on ``dev`` against the CPU's
    at 128x96 (384^2 fields), the bank's flow and inverse flow and the
    scene kernel's warp planes."""
    from flowgen_torch.random.streams import root_key
    from flowgen_torch.warpfields import generator as warpgen

    cfg = config(9, height=96, width=128)
    card = warpgen.make_bank_and_aux(root_key(SEED, dev), 0, cfg)
    cpu = warpgen.make_bank_and_aux(root_key(SEED, "cpu"), 0, cfg)
    pairs = [(card[0].flow, cpu[0].flow), (card[0].iflow, cpu[0].iflow),
             (card[1].obj, cpu[1].obj), (card[1].bg, cpu[1].bg)]
    nan_mm, ds, unequal = 0.0, [], 0
    for a, b in pairs:
        a = a.cpu()
        nan_mm = max(nan_mm, float((torch.isnan(a) != torch.isnan(b))
                                   .float().mean()))
        ds.append((torch.nan_to_num(a) - torch.nan_to_num(b)).abs().flatten())
        unequal += _bits_unequal(a, b)
    unequal += _bits_unequal(card[1].bg_band, cpu[1].bg_band)
    d = torch.cat(ds)
    res = {"flow_median": float(d.median()),
           "flow_frac_gt_0.01": float((d > 0.01).float().mean()),
           "flow_max": float(d.max()), "nan_mask_mismatch": nan_mm,
           "bits_unequal": unequal}
    res["ok"] = bool(nan_mm < 1e-4 and res["flow_median"] < 1e-4
                     and res["flow_frac_gt_0.01"] < 1e-3)
    return res


def check_mode(mode: int, dev) -> dict:
    res = {"card_vs_cpu": card_vs_cpu(mode, dev),
           "fused_vs_windowed": fused_vs_windowed(mode, dev)}
    res["ok"] = all(r["ok"] for r in res.values())
    return res


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]


def _write_json(path, results, card):
    merged = results
    if os.path.exists(path):
        with open(path) as f:
            merged = {**json.load(f).get("results", {}), **results}
    with open(path, "w") as f:
        json.dump({"card": card, "results": merged,
                   "ok": all(r["ok"] for r in merged.values())}, f, indent=1)


def main():
    args = sys.argv[1:]
    json_out = None
    if args and args[0] == "--json":
        json_out, args = args[1], args[2:]
    if not torch.cuda.is_available():
        sys.exit("torch.cuda.is_available() is false: this check needs a GPU")
    from flowgen_torch.ops import _build

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"torch {torch.__version__}, cuda {torch.version.cuda}; {card}",
          flush=True)
    _build.build_all()
    t_start = time.perf_counter()
    results, failures = {}, 0
    for arg in args or DEFAULT_MODES:
        t0 = time.perf_counter()
        res = bank_check(dev) if arg == "bank" else check_mode(int(arg), dev)
        res["seconds"] = round(time.perf_counter() - t0, 2)
        results[arg] = res
        failures += 0 if res["ok"] else 1
        print(f"{arg}: {json.dumps(res)}", flush=True)
        if json_out:
            _write_json(json_out, results, card)
    print(f"{len(results)} checks, {failures} failed, "
          f"{time.perf_counter() - t_start:.1f} s [{card}]")
    sys.exit(1 if failures else 0)


if __name__ == "__main__":
    main()
