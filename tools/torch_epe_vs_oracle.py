#!/usr/bin/env python3
"""Per-mode flow EPE of the port's scene kernel against the scalar numpy
oracle (``flowgen_torch/reference_check/oracle.py``) on identically seeded
scenes: the port's twin of ``tools/epe_vs_oracle.py``.

For every registered rendering mode, scenes sampled from the production key
derivation (seed 7, sample indices 0..N-1) are rendered through
``compose/fused.py:render_batch_fused`` on the card (the CUDA scene
kernel) at 512x384 from the
4-texture procedural atlas, and by the oracle's literal re-derivation of
the reference's render semantics on the host. Mode 9 takes the "xla" bank
with its warp planes (the same bank feeds both sides, so bank content
cancels out: the table measures render fidelity) and is also measured with
``compute_inverse_flow=True`` (row ``9_inverse``).

A pixel whose flows differ by more than 0.1 px is an ownership flip (at an
exact 0.5-coverage tie the binary mask resolves differently in float32 and
float64; object flows differ by whole pixels there) and is counted apart:
each row has the median EPE (max |d| over the two channels), the max over
unflipped pixels, the raw max, the flipped count and fraction, the pixel
count and the scene count.

The oracle is scalar numpy and slow (minutes a scene at 512x384), so its
scenes run in a pool of worker processes, one a CPU core, while the
renders run in this process. The table is written after every row, merged
into the file's earlier rows.

Usage: python3 tools/torch_epe_vs_oracle.py [--out FILE] [--scenes N]
           [mode ...]
Default output EPE_TABLE_TORCH.json at the repository root; default modes
1-13 and 9_inverse. ``epe_row`` runs one row with the oracle in the calling
process, on any device.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

FLIP_THRESH = 0.1  # px; ownership flips are whole-pixel, noise is ~1e-5
SEED = 7


def render_row(mode_arg: str, n_scenes: int, device, height: int = 384,
               width: int = 512):
    """Render one row's scenes on ``device``: returns ``(flows, oracle
    jobs)``, the port's flows as numpy arrays (n_scenes, H, W, 2), a list
    of one or two (forward, and inverse for a ``_inverse`` row), and one
    keyword dict of :func:`oracle_flows` a scene."""
    import flowgen_torch
    from flowgen_torch.compose.fused import render_batch_fused
    from flowgen_torch.params.blueprint import map_scene
    from flowgen_torch.params.sampler import sample_scene_batch
    from flowgen_torch.pipeline.generator import make_slab_packer
    from flowgen_torch.random.streams import root_key
    from flowgen_torch.reference_check import oracle
    from flowgen_torch.warpfields import generator as warpgen

    dev = torch.device(device)
    inverse = mode_arg.endswith("_inverse")
    cfg = flowgen_torch.DataGenConfig(
        mode=int(mode_arg.split("_")[0]), batch_size=n_scenes, seed=SEED,
        height=height, width=width, compute_inverse_flow=inverse)
    atlas = flowgen_torch.procedural_atlas(4, height=height, width=width)
    obj_slabs, bg_slabs, src_hw, _ = make_slab_packer(cfg, dev)(atlas)
    root = root_key(SEED, dev)
    warp_aux = bank_np = None
    n_slots = 1
    if cfg.mode_spec.warp_p > 0.0:
        bank, warp_aux = warpgen.make_bank_and_aux(root, 0, cfg, impl="xla")
        n_slots = warpgen.bank_size(cfg)
        bank_np = {"flow": bank.flow.cpu().numpy(),
                   "iflow": bank.iflow.cpu().numpy()}
    scenes = sample_scene_batch(root, torch.arange(n_scenes, device=dev), cfg,
                                n_warp_slots=n_slots)
    out = render_batch_fused(scenes, obj_slabs, bg_slabs, src_hw, cfg,
                             warp_aux=warp_aux)
    flows = [out[2].cpu().numpy()] + ([out[3].cpu().numpy()] if inverse
                                      else [])
    jobs = [dict(scene_np=oracle.scene_to_numpy(
                     map_scene(lambda t, s=s: t[s].cpu(), scenes)),
                 atlas_np=atlas, width=width, height=height,
                 bank=bank_np, inverse=inverse)
            for s in range(n_scenes)]
    return flows, jobs


def oracle_flows(scene_np, atlas_np, width, height, bank, inverse):
    """The oracle's flows of one scene: [flow0] or [flow0, flow1]. ``bank``
    is None, a dict of arrays, or the path of an ``.npz`` holding them."""
    from flowgen_torch.reference_check import oracle

    if isinstance(bank, str):
        with np.load(bank) as z:
            bank = {k: z[k] for k in z.files}
    o = oracle.render_scene_oracle(scene_np, atlas_np, width, height,
                                   warp_bank=bank, compute_inverse=inverse)
    return [o[2]] + ([o[3]] if inverse else [])


def _oracle_job(kw):
    return oracle_flows(**kw)


def row_stats(flows, oracle_out, n_scenes: int) -> dict:
    """The table row from the port's flows and each scene's oracle flows."""
    ds = []
    for s in range(n_scenes):
        for port, orc in zip(flows, oracle_out[s]):
            ds.append(np.abs(port[s] - orc).max(-1))
    d = np.stack(ds)
    flips = d > FLIP_THRESH
    unflipped = np.where(flips, 0.0, d)
    return {
        "median_epe": float(np.median(d)),
        "max_epe_unflipped": float(unflipped.max()),
        "max_epe": float(d.max()),
        "flipped_px": int(flips.sum()),
        "flipped_frac": float(flips.mean()),
        "pixels": int(d.size),
        "scenes": n_scenes,
    }


def epe_row(mode_arg: str, n_scenes: int, device, height: int = 384,
            width: int = 512) -> dict:
    """One row, the oracle run in this process."""
    flows, jobs = render_row(mode_arg, n_scenes, device, height, width)
    return row_stats(flows, [oracle_flows(**kw) for kw in jobs], n_scenes)


def _write(path, table, meta):
    merged = dict(table)
    if os.path.exists(path):
        with open(path) as f:
            merged = {**json.load(f).get("per_mode", {}), **table}
    with open(path, "w") as f:
        json.dump({**meta, "per_mode": merged}, f, indent=1)


def _card_meta() -> dict:
    import subprocess

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    return {"path": "fused", "device": "cuda", "card": card,
            "kernel": "flowgen_torch/csrc/scene.cu", "frame": [384, 512],
            "flip_thresh_px": FLIP_THRESH, "seed": SEED}


def main():
    import multiprocessing as mp

    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.join(ROOT, "EPE_TABLE_TORCH.json"))
    ap.add_argument("--scenes", type=int, default=2)
    ap.add_argument("modes", nargs="*")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("torch.cuda.is_available() is false: this tool needs a GPU")
    from flowgen_torch.ops import _build

    _build.build_all()
    device, jobs = "cuda", os.cpu_count()
    mode_args = args.modes or [str(m) for m in range(1, 14)] + ["9_inverse"]
    meta = _card_meta()
    table = {}
    t_start = time.perf_counter()
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp, ctx.Pool(jobs) as pool:
        pending = []
        for mode_arg in mode_args:
            t0 = time.perf_counter()
            flows, row_jobs = render_row(mode_arg, args.scenes, device)
            if row_jobs[0]["bank"] is not None:
                # One file a row: the bank is hundreds of MB, too much to
                # send with every scene.
                path = os.path.join(tmp, f"bank_{mode_arg}.npz")
                np.savez(path, **row_jobs[0]["bank"])
                for kw in row_jobs:
                    kw["bank"] = path
            pending.append((mode_arg, flows,
                            pool.map_async(_oracle_job, row_jobs)))
            print(f"mode {mode_arg}: rendered {args.scenes} scenes on "
                  f"{device} in {time.perf_counter() - t0:.1f} s", flush=True)
        for mode_arg, flows, res in pending:
            r = table[mode_arg] = row_stats(flows, res.get(), args.scenes)
            print(f"mode {mode_arg:>9}: median EPE {r['median_epe']:.2e} px, "
                  f"max(unflipped) {r['max_epe_unflipped']:.2e}, flips "
                  f"{r['flipped_px']}/{r['pixels']} ({r['flipped_frac']:.1e}),"
                  f" raw max {r['max_epe']:.3f}; "
                  f"{time.perf_counter() - t_start:.1f} s", flush=True)
            _write(args.out, table, meta)
    print(f"\n{meta['card']}; {jobs} oracle workers; "
          f"{time.perf_counter() - t_start:.1f} s")
    print("| mode | scenes | median EPE (px) | max EPE non-flipped (px) "
          "| flipped px | flipped frac |")
    print("|---|---|---|---|---|---|")
    for m, r in table.items():
        print(f"| {m} | {r['scenes']} | {r['median_epe']:.2e} | "
              f"{r['max_epe_unflipped']:.2e} | {r['flipped_px']} | "
              f"{r['flipped_frac']:.1e} |")


if __name__ == "__main__":
    main()
