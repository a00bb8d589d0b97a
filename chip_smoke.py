#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (flowgen_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero before the final line):
  1. versions, the card's name and power limit, and the build of every CUDA
     kernel source in flowgen_torch/csrc (one nvcc each, started together),
     with the ptxas register / shared-memory / spill summary;
  2. mode 7, scene kernel vs plain: scenes from seed 0 at 512x384, B=4,
     rendered by the CUDA scene kernel and by its plain PyTorch version on
     the same tables (background only first, then the full scene), held to
     the JAX package's on-device gates (tools/check_pallas_tpu.py): images
     under 1% of values >= 1 level apart and under 1e-4 >= 2 levels; flow
     median |d| < 1e-4 px and under 1e-3 of values with |d| > 0.01 px;
  3. the mode-7 main path: Generator(DataGenConfig(mode=7, batch_size=64,
     seed=0)) over the 32-texture procedural atlas, 2 warm-up and 5 timed
     steps, output checks (shapes, u8-valued images, finite flow, samples
     0-3 of step 0 against the plain render of phase 2), launch counts,
     ms/step, samples/s, peak memory, the device's busy share and a
     per-layer breakdown;
  4. mode 7, the scene kernel's timing at B=64: CUDA events, the plain
     version once, the bound from this run's inputs;
  5. mode 9, bank kernels vs plain at the main path's shapes: one doubling
     of the 8 half-lattice fields (768^2) and one of the full-size fields
     (1536^2), each through coarse_gdisp and hwarp_rows against their plain
     versions, then the whole make_bank_and_aux (the aux solve at 1536 and
     the background bands included) through the kernels against the same
     through the plain versions: max difference 0 expected; the bank gate
     is a NaN-mask mismatch under 1e-4 plus the flow gate;
  6. mode 9, scene kernel vs plain at 512x384, B=4, on samples of the main
     path's step 0 that hold a deforming object and a deforming background;
  7. the mode-9 main path: Generator(DataGenConfig(mode=9, batch_size=64,
     seed=0)), 2 warm-up and 5 timed steps across bank epochs, the same
     checks and numbers as phase 3, with a bank-producer layer;
  8. mode 9, per-kernel timing at the main path's shapes (scene kernel at
     B=64, coarse_gdisp's solve and hwarp_rows at 768^2 and 1536^2, and
     coarse_gdisp_batch as a whole beside the solve): CUDA events, the plain
     versions once, the bound, and for hwarp_rows the time of
     torch.nn.functional.grid_sample on the same planes;
  9. modes 13 and 11 (quadrant slabs, 2x2 texture sub-windows) with inverse
     flow and id images, scene kernel vs plain at 512x384, B=4 (phase 6
     does the same for mode 9's warp branch): frames, all four flow planes
     and the id images, held to the gates above (ids: under 1e-4
     mismatched; max difference 0 expected);
 10. the mode-13 main path: Generator(DataGenConfig(mode=13, batch_size=64,
     seed=0, compute_inverse_flow=True, emit_masks=True)), the same checks
     and numbers as phase 3 (flow1 and the masks included; samples 0-3 of
     step 0 against the plain render of phase 9, masks from its ids), with
     the masks on their own layer line;
 11. mode 13, the scene kernel's timing at B=64 as in phase 4; then one JSON
     line {"kernels": [...]}, and last the line {"ok": true, "device": {...}}.

It needs the repository (it imports flowgen_torch from its own directory),
a CUDA card and nvcc. It imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

import numpy as np  # noqa: E402
import torch  # noqa: E402

# Published H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth and float32
# rate outside the tensor cores.
PEAK_BYTES_S = 3.35e12
PEAK_F32_S = 67e12
# Float operations per evaluated (polygon edge, pixel) pair and per fat
# ellipse pixel, counting only the pixel-dependent terms of
# csrc/coverage.cuh (edge_contrib: 45; ellipse_chord_coverage: 190).
OPS_EDGE_PIXEL = 45
OPS_ELLIPSE_PIXEL = 190


def fail(msg: str):
    print(f"FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def card_line() -> str:
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if r.returncode != 0:
        fail(f"nvidia-smi failed: {r.stderr.strip()}")
    return r.stdout.strip().splitlines()[0]


def ptxas_summary(log: str):
    keep = [ln.strip() for ln in log.splitlines()
            if re.search(r"registers|spill|smem|Compiling entry", ln)]
    return keep


def kernel_counters():
    from flowgen_torch.ops import scene as ps
    from flowgen_torch.warpfields import compose

    return {"scene_render": ps.scene_render,
            "coarse_gdisp": compose.coarse_solve,
            "hwarp_rows": compose.hwarp_rows}


def reset_counts():
    for fn in kernel_counters().values():
        fn.launches = 0


def read_counts():
    return {k: fn.launches for k, fn in kernel_counters().items()}


def sample(cfg, seed: int, indices, device, n_slots=1):
    from flowgen_torch.params.sampler import sample_scene_batch
    from flowgen_torch.random.streams import root_key

    return sample_scene_batch(root_key(seed, device), indices.to(device), cfg,
                              n_warp_slots=n_slots)


def scene_tables(cfg, seed: int, step: int, slabs, device):
    """The scene kernel's inputs for one batch of the main path: (args,
    options) from ``fused.scene_tables``."""
    from flowgen_torch.compose import fused

    idx = step * cfg.batch_size + torch.arange(cfg.batch_size)
    return fused.scene_tables(sample(cfg, seed, idx, device), cfg, *slabs)


def layer_breakdown(cfg, slabs, device, steps: int = 3):
    """Host-clock time of each layer of one main-path step (sampler,
    precompute, scene kernel, output adapter), each ended by a device
    synchronize, averaged over ``steps`` steps. Mode 9 adds the bank
    producer: each epoch's make_bank_and_aux, per step (divided by the
    steps of an epoch); ``emit_masks`` the masks from the id images."""
    from flowgen_torch.compose import fused
    from flowgen_torch.ops import scene as ps
    from flowgen_torch.pipeline.generator import _adapt_output
    from flowgen_torch.random.streams import root_key
    from flowgen_torch.warpfields import generator as wg

    warp = cfg.mode_spec.warp_p > 0.0
    acc = {"bank_producer": 0.0} if warp else {}
    acc.update({"sampler": 0.0, "precompute": 0.0, "scene_kernel": 0.0,
                "adapt": 0.0})
    if cfg.emit_masks:
        acc["masks"] = 0.0
    root = root_key(cfg.seed, device)
    n_slots = wg.bank_size(cfg) if warp else 1
    reuse = max(cfg.warp_bank_reuse_steps, 1)

    def tick(t0):
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    aux = None
    for step in range(steps):
        torch.cuda.synchronize()
        if warp:
            t0 = time.perf_counter()
            _, aux = wg.make_bank_and_aux(root, step * reuse, cfg)
            acc["bank_producer"] += tick(t0) / reuse
        t0 = time.perf_counter()
        idx = step * cfg.batch_size + torch.arange(cfg.batch_size, device=device)
        scenes = sample(cfg, cfg.seed, idx, device, n_slots)
        acc["sampler"] += tick(t0)
        t0 = time.perf_counter()
        args, opts = fused.scene_tables(scenes, cfg, *slabs, aux)
        acc["precompute"] += tick(t0)
        t0 = time.perf_counter()
        frames, flow, ids = ps.scene_render(*args, **opts)
        acc["scene_kernel"] += tick(t0)
        masks = None
        if cfg.emit_masks:
            t0 = time.perf_counter()
            masks = fused.masks_from_ids(ids, flow[:, 0], flow[:, 1])
            acc["masks"] += tick(t0)
        t0 = time.perf_counter()
        im = [unpack(frames[:, f]) for f in (0, 1)]
        f1 = flow[:, 2:4].permute(0, 2, 3, 1) if flow.shape[1] == 4 else None
        _adapt_output(im[0], im[1], flow[:, 0:2].permute(0, 2, 3, 1), f1, cfg,
                      masks)
        acc["adapt"] += tick(t0)
    return {k: 1e3 * v / steps for k, v in acc.items()}


def device_busy(gen, steps: int = 3):
    """Device time against wall time over ``steps`` Generator steps, from
    torch.profiler: (wall ms, device-busy ms, CUDA kernels launched)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            gen.retrieve_batch()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    from torch.autograd import DeviceType

    busy_us, n_kernels = 0.0, 0
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue
        busy_us += getattr(ev, "self_device_time_total",
                           getattr(ev, "self_cuda_time_total", 0.0))
        n_kernels += ev.count
    return 1e3 * wall, busy_us / 1e3, n_kernels


def unpack(frames):
    return torch.stack(
        [((frames >> s) & 0xFF).to(torch.float32) for s in (16, 8, 0)], -1
    )


def as_batch(out):
    """Scene-kernel output (frames (B,2,H,W) packed, flow (B,2|4,H,W), ids
    (B,2,H,W) or None) as a dict of the main path's NHWC outputs (image0,
    image1, flow0, flow1 with the inverse planes), plus ``ids`` and, with
    them, the occlusion and motion-boundary masks."""
    from flowgen_torch.compose.fused import masks_from_ids

    frames, flow, ids = out
    d = {"image0": unpack(frames[:, 0]), "image1": unpack(frames[:, 1]),
         "flow0": flow[:, 0:2].permute(0, 2, 3, 1)}
    if flow.shape[1] == 4:
        d["flow1"] = flow[:, 2:4].permute(0, 2, 3, 1)
    if ids is not None:
        d["ids"] = ids
        d["occlusion"], d["motion_boundary"] = masks_from_ids(
            ids, flow[:, 0], flow[:, 1])
    return d


def gates(a, b):
    """The JAX package's on-device gates between two output dicts: images
    under 1% of values >= 1 level apart and under 1e-4 >= 2 levels; over
    every flow both hold, median |d| < 1e-4 px and under 1e-3 of values
    > 0.01 px; ids and masks both hold under 1e-4 of pixels mismatched."""
    dimg = [(a[k] - b[k]).abs() for k in ("image0", "image1")]
    img1 = max(float((d >= 1).float().mean()) for d in dimg)
    img2 = max(float((d >= 2).float().mean()) for d in dimg)
    flows = [k for k in ("flow0", "flow1") if k in a and k in b]
    dflow = torch.cat([(a[k] - b[k]).abs().flatten() for k in flows])
    res = {
        "img_frac_ge_1": img1,
        "img_frac_ge_2": img2,
        "max_img_diff": max(float(d.max()) for d in dimg),
        "flows": flows,
        "flow_median": float(dflow.median()),
        "flow_frac_gt_0.01": float((dflow > 0.01).float().mean()),
        "flow_max": float(dflow.max()),
    }
    res["max_abs_err"] = max(res["max_img_diff"], res["flow_max"])
    ok = (img1 < 0.01 and img2 < 1e-4 and res["flow_median"] < 1e-4
          and res["flow_frac_gt_0.01"] < 1e-3)
    for k in ("ids", "occlusion", "motion_boundary"):
        if k in a and k in b:
            res[f"{k}_mismatch"] = float((a[k] != b[k]).float().mean())
            ok = ok and res[f"{k}_mismatch"] < 1e-4
    res["ok"] = ok
    return res


def field_gate(a, b):
    """The JAX package's bank gate between two field tensors that may hold
    NaN: NaN-mask mismatch under 1e-4, and the flow gate where both are
    finite; plus the largest difference."""
    na, nb = torch.isnan(a), torch.isnan(b)
    both = ~na & ~nb
    d = (a[both] - b[both]).abs()
    res = {
        "nan_mask_mismatch": float((na != nb).float().mean()),
        "median": float(d.median()) if d.numel() else 0.0,
        "frac_gt_0.01": float((d > 0.01).float().mean()) if d.numel() else 0.0,
        "max_abs_err": float(d.max()) if d.numel() else 0.0,
    }
    res["ok"] = (res["nan_mask_mismatch"] < 1e-4 and res["median"] < 1e-4
                 and res["frac_gt_0.01"] < 1e-3)
    return res


def bound(args, opts):
    """Least time for the scene kernel's work on these inputs: the larger of
    a bytes time and a float-operations time.

    Bytes: both packed frames and both flow planes written once (with
    inverse flow its two planes too, with id images both of them), plus the
    slab texels the output depends on, read once. Per pixel of each frame,
    walking the work units against painter's order, a unit's texels count
    where its blend mask (the plain version's coverage, inside the unit's
    ownership rectangle) is above 0 and no later unit covers the pixel fully;
    the background's count where no unit covers it fully. A frame-0 object
    pixel reads one texel; a resampled pixel its source footprint |det|, at
    most its 4 bilinear taps. Mode 9 adds the warp planes those pixels read,
    once each: gdisp and vdisp (8 bytes) under a deforming object in frame 1
    and under a deforming background in frame 1, and the forward field's two
    planes (8 bytes) under a deforming object's binary mask in frame 0 and
    over a deforming background's frame 0 where no object overwrites the
    flow, and a deforming background's pass-1 bands (4 bytes a block). A
    deforming unit's undisplaced coverage stands in for its displaced one.
    Operations: the (polygon edge, owned pixel) pairs and
    fat-ellipse owned pixels that the coverage loops evaluate after the
    row-block culls, once per owned pixel."""
    from flowgen_torch.ops import scene as ps

    key, use_aa = opts["spec_key"], opts["use_aa"]
    (bg_meta, omi, omf, tmi, tmf, bgm, edges, _, _, wl, nu) = args[:11]
    warp = args[11] is not None
    band_bytes = 4.0 * args[13][0].numel() if warp else 0.0
    dev = edges.device
    bg_meta, omi, omf, tmi, tmf, bgm, edges_np, wl, nu = (
        a.detach().cpu().numpy()
        for a in (bg_meta, omi, omf, tmi, tmf, bgm, edges, wl, nu))
    H, W = key[-2:]
    B, K = omi.shape[:2]
    wh, ww = min(ps.WIN_H, H), min(ps.WIN_W, W)
    nb = wh // 8
    nflow = 4 if opts["inverse_flow"] else 2
    n_ids = 2 if opts["emit_masks"] else 0
    out_bytes = B * (2 + nflow + n_ids) * H * W * 4
    tex = torch.zeros((), dtype=torch.float64, device=dev)
    aux = torch.zeros((), dtype=torch.float64, device=dev)
    ops = 0.0
    for b in range(B):
        bg_warp = warp and int(bg_meta[b, 1]) != 0
        for fr, base in ((0, ps.BGM_T0), (1, ps.BGM_T1)):
            opaque = torch.zeros((H, W), dtype=torch.bool, device=dev)
            for j in reversed(range(int(nu[b, fr]))):
                u = int(wl[b, fr * K * ps.MAX_TILES + j])
                k, t = divmod(u, ps.MAX_TILES)
                tm = tmi[b, k, fr, t]
                y0w, x0w = int(tm[0]) & ~7, int(tm[1]) & ~127
                oy0, oy1 = max(int(tm[2]), y0w), min(int(tm[3]), y0w + wh)
                ox0, ox1 = max(int(tm[4]), x0w), min(int(tm[5]), x0w + ww)
                if oy1 <= oy0 or ox1 <= ox0:
                    continue
                om, of = omi[b, k, fr], omf[b, k, fr]
                aa, ins = ps._coverage_window(edges_np[b, k, fr], om, of,
                                              y0w, x0w, wh, ww, dev)
                sl = (slice(oy0 - y0w, oy1 - y0w), slice(ox0 - x0w, ox1 - x0w))
                m = (aa if use_aa else ins)[sl]
                top = opaque[oy0:oy1, ox0:ox1]
                if fr == 0:
                    foot = 1.0
                else:
                    c = tmf[b, k, 1, t]
                    foot = min(abs(float(c[0] * c[4])), 4.0)
                tex += foot * ((m > 0) & ~top).sum()
                if warp and int(om[ps.OMI_WARP]) != 0:
                    live = (m > 0) if fr == 1 else (ins[sl] >= 1)
                    aux += 8.0 * (live & ~top).sum()
                top |= m >= 1
                rows = np.arange(oy0, oy1)
                blk = (rows - y0w) >> 3
                for c in range(int(om[ps.OMI_NPRIMS])):
                    if (int(om[ps.OMI_POLY_BITS]) >> c) & 1:
                        ne = int(om[ps.OMI_NEDGES + c])
                        e = edges_np[b, k, fr, :, c * 120 : c * 120 + ne]
                        ax, ay, bx, by = e
                        rlo = np.floor(np.minimum(ay, by) - y0w).astype(np.int64) - 1
                        rhi = np.floor(np.maximum(ay, by) - y0w).astype(np.int64)
                        rb0 = np.clip(rlo, 0, wh) >> 3
                        rb1 = np.minimum((np.clip(rhi, -1, wh - 1) >> 3) + 1, nb)
                        live = np.maximum(ax, bx) >= x0w
                        hit = ((blk[None, :] >= rb0[:, None])
                               & (blk[None, :] < rb1[:, None]) & live[:, None])
                        ops += OPS_EDGE_PIXEL * float(hit.sum()) * (ox1 - ox0)
                    else:
                        ymn = of[ps.OMF_EXT + 2 * c] - ps.ELL_CULL_M - y0w
                        ymx = of[ps.OMF_EXT + 2 * c + 1] + ps.ELL_CULL_M - y0w
                        rb0 = min(max(int(np.floor(ymn)) - 1, 0), wh) >> 3
                        rb1 = min((min(max(int(np.floor(ymx)), -1), wh - 1) >> 3) + 1, nb)
                        hit = ((blk >= rb0) & (blk < rb1)).sum()
                        ops += OPS_ELLIPSE_PIXEL * float(hit) * (ox1 - ox0)
            mb = bgm[b, base : base + 6]
            foot = min(abs(float(mb[0] * mb[4] - mb[1] * mb[3])), 4.0)
            tex += foot * (~opaque).sum()
            if bg_warp:
                aux += 8.0 * (~opaque).sum() + (band_bytes if fr == 1 else 0.0)
    nbytes = out_bytes + 4.0 * float(tex) + float(aux)
    t_bytes = nbytes / PEAK_BYTES_S
    t_ops = ops / PEAK_F32_S
    return {
        "bytes": nbytes, "operations": ops,
        "bound_ms": 1e3 * max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
    }


def event_ms(fn, reps: int = 10) -> float:
    """Per-call time of ``fn`` on the card by CUDA events over ``reps``
    calls, after two warm-up calls."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def host_ms(fn):
    """Host-clock time of one call of ``fn``, ended by a synchronize."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0), out


def run_main_path(cfg, atlas, card, n_steps=5, prof_steps=3):
    """Drive ``Generator`` with every kernel count at 0 before: 2 warm-up
    and ``n_steps`` timed steps, then ``prof_steps`` profiled ones. Returns
    the first batch, the last batch and the numbers."""
    from flowgen_torch.pipeline.generator import Generator

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    gen = Generator(cfg, atlas=atlas, device="cuda")
    first = gen.retrieve_batch()
    gen.retrieve_batch()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n_steps):
        out = gen.retrieve_batch()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    wall_ms, busy_ms, n_cuda = device_busy(gen, prof_steps)
    counts = read_counts()
    dispatched = gen.step
    gen.stop()
    res = {
        "ms_per_step": 1e3 * dt / n_steps,
        "samples_per_s": cfg.batch_size * n_steps / dt,
        "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
        "launches": counts, "dispatched": dispatched,
        "busy_ms": busy_ms / prof_steps, "wall_ms": wall_ms / prof_steps,
        "cuda_kernels": n_cuda / prof_steps,
    }
    B, H, W = cfg.batch_size, cfg.height, cfg.width
    want = {"image0", "image1", "flow0"}
    if cfg.compute_inverse_flow:
        want.add("flow1")
    if cfg.emit_masks:
        want |= {"occlusion", "motion_boundary"}
    if set(out) != want:
        fail(f"output keys {sorted(out)}, want {sorted(want)}")
    for k in ("image0", "image1"):
        im = out[k]
        if tuple(im.shape) != (B, H, W, 3):
            fail(f"image shape {tuple(im.shape)}")
        if not bool(((im == im.round()) & (im >= 0) & (im <= 255)).all()):
            fail("images are not integer values in [0, 255]")
    for k in want & {"flow0", "flow1"}:
        if tuple(out[k].shape) != (B, H, W, 2):
            fail(f"{k} shape {tuple(out[k].shape)}")
        if not bool(torch.isfinite(out[k]).all()):
            fail(f"{k} has non-finite values")
    for k in want & {"occlusion", "motion_boundary"}:
        if tuple(out[k].shape) != (B, H, W) or out[k].dtype != torch.bool:
            fail(f"{k}: shape {tuple(out[k].shape)}, {out[k].dtype}")
        share = float(out[k].float().mean())
        print(f"{k} share (mode {cfg.mode}, last step): {share:.4f}")
        if not 0.0 < share < 1.0:
            fail(f"{k} is constant")
    if counts["scene_render"] != dispatched:
        fail(f"scene kernel launches {counts['scene_render']} != steps "
             f"dispatched {dispatched}")
    label = f"mode {cfg.mode}, B={B}, {W}x{H}"
    print(f"main path ({label}): {res['ms_per_step']:.2f} ms/step, "
          f"{res['samples_per_s']:.1f} samples/s over {n_steps} timed steps, "
          f"peak memory {res['peak_gib']:.2f} GiB, kernel launches "
          f"{json.dumps(counts)} for {dispatched} steps dispatched [{card}]")
    if busy_ms > 0:
        print(f"device busy ({label}, torch.profiler, {prof_steps} steps): "
              f"{res['busy_ms']:.2f} of {res['wall_ms']:.2f} ms per step, "
              f"idle share {1 - busy_ms / wall_ms:.3f}, "
              f"{res['cuda_kernels']:.0f} CUDA kernels per step [{card}]")
    else:
        print("device busy: not measured (torch.profiler recorded no "
              "device time)")
    return first, res


def phase_mode7(card, dev):
    import flowgen_torch
    from flowgen_torch.ops import scene as ps
    from flowgen_torch.pipeline.generator import make_slab_packer

    cfg4 = flowgen_torch.DataGenConfig(mode=7, batch_size=4, seed=0)
    atlas = flowgen_torch.atlas_for_config(cfg4)
    slabs = make_slab_packer(cfg4, dev)(atlas)

    # ---- 2: kernel vs plain at 512x384, B=4 ----
    args, opts = scene_tables(cfg4, 0, 0, slabs, dev)
    for label, bg_only in (("background", True), ("scene", False)):
        k_out = as_batch(ps.scene_render(*args, bg_only=bg_only, **opts))
        torch.cuda.synchronize()
        plain4 = as_batch(ps.scene_render_plain(*args, bg_only=bg_only,
                                                **opts))
        cmp = gates(k_out, plain4)
        print(f"mode 7 kernel vs plain ({label}, B=4, 512x384): "
              + json.dumps(cmp, sort_keys=True))
        if not cmp["ok"]:
            fail(f"mode 7 kernel vs plain gates failed ({label})")

    # ---- 3: the main path ----
    cfg = flowgen_torch.DataGenConfig(mode=7, batch_size=64, seed=0)
    first, res = run_main_path(cfg, atlas, card)
    # Step 0 holds samples 0..3 of phase 2: content depends only on (seed,
    # global sample index).
    g = gates({k: v[:4] for k, v in first.items()}, plain4)
    print("mode 7 main path step 0 vs plain (samples 0-3): "
          + json.dumps(g, sort_keys=True))
    if not g["ok"]:
        fail("mode 7 main path output disagrees with the plain render")
    del first
    if any(res["launches"][k] for k in ("coarse_gdisp", "hwarp_rows")):
        fail("the mode-7 path launched bank kernels")
    layers = layer_breakdown(cfg, slabs, dev)
    print("mode 7 layers (ms per step, host clock, synchronized): "
          + json.dumps({k: round(v, 3) for k, v in layers.items()})
          + f" [{card}]")

    # ---- 4: scene kernel timing at B=64 ----
    args, opts = scene_tables(cfg, 0, 0, slabs, dev)
    k_ms = event_ms(lambda: ps.scene_render(*args, **opts))
    k_out = ps.scene_render(*args, **opts)
    p_ms, p_out = host_ms(lambda: ps.scene_render_plain(*args, **opts))
    g = gates(as_batch(k_out), as_batch(p_out))
    bd = bound(args, opts)
    print(f"mode 7 scene kernel (B=64): {k_ms:.3f} ms per launch (CUDA events, "
          f"10 launches); plain version {p_ms:.1f} ms; bound "
          f"{bd['bound_ms']:.4f} ms by {bd['bound_by']} "
          f"({bd['bytes']:.4e} bytes, {bd['operations']:.4e} float ops) "
          f"[{card}]")
    print("mode 7 kernel vs plain (scene, B=64): " + json.dumps(g, sort_keys=True))
    if not g["ok"]:
        fail("mode 7 kernel vs plain gates failed at B=64")
    return {"launches": res["launches"]["scene_render"], "ms": k_ms,
            "plain_ms": p_ms, "bound_ms": bd["bound_ms"],
            "bound_by": bd["bound_by"],
            "max_abs_err": max(cmp["max_abs_err"], g["max_abs_err"])}


def one_doubling(f):
    """The lookup half of one composition doubling of (M, 2, S, S) fields:
    the column-inverse solve, then the two-pass warp of both channels."""
    from flowgen_torch.warpfields import compose

    gd = compose.coarse_gdisp_batch(f.permute(0, 2, 3, 1))
    return gd, compose.displace_planes_batch(f, gd, f[:, 1])


def phase_bank(cfg, dev):
    """Phase 5. Returns the fields the timing phase reuses and the kernel
    bank and aux of epoch 0."""
    from flowgen_torch.random.streams import Stream, fold_in, root_key, stream_key
    from flowgen_torch.warpfields import compose, fields
    from flowgen_torch.warpfields import generator as wg

    root = root_key(cfg.seed, dev)
    big = wg.big_field_size(cfg.width, cfg.height)
    grids, flags = [], []
    for i in range(cfg.warp_fields_per_batch):
        g = fields.sample_displacer_grid(
            stream_key(fold_in(root, 0), Stream.WARP_FIELD, i), big)
        grids += [g, g]
        flags += [False, True]
    grid, inv = fields.stack_grids(grids, flags)
    f_h = fields.elementary_field(grid, big // 2, inv, stride=2.0) * 0.5
    # The 16th half-lattice doubling and the full-size doubling, on the
    # kernel path's own states.
    f15 = torch.nan_to_num(compose.self_compose_batch(f_h, 15))
    f16 = compose.self_compose_batch(f15, 1)
    full = 2.0 * fields._upsample2(torch.nan_to_num(f16))
    worst = 0.0
    for label, f in (("768^2, 8 fields", f15), ("1536^2, 8 fields", full)):
        gk, lk = one_doubling(f)
        with compose.plain_versions():
            gp, lp = one_doubling(f)
        torch.cuda.synchronize()
        dg = float((gk - gp).abs().max())
        dl = float((lk - lp).abs().max())
        worst = max(worst, dg, dl)
        print(f"bank kernels vs plain, one doubling at {label}: coarse_gdisp "
              f"max |d| {dg}, hwarp_rows (both passes) max |d| {dl}; "
              f"|field| max {float(f.abs().max()):.3f} px")
        if not (dg == 0.0 and dl == 0.0):
            fail(f"bank kernels differ from their plain versions ({label})")
    bk, ak = wg.make_bank_and_aux(root, 0, cfg)
    with compose.plain_versions():
        bp, ap = wg.make_bank_and_aux(root, 0, cfg)
    torch.cuda.synchronize()
    res = {}
    for name, a, b in (("flow", bk.flow, bp.flow), ("iflow", bk.iflow, bp.iflow),
                       ("obj_aux", ak.obj, ap.obj), ("bg_aux", ak.bg, ap.bg)):
        res[name] = field_gate(a, b)
        worst = max(worst, res[name]["max_abs_err"])
    band_equal = bool(torch.equal(ak.bg_band, ap.bg_band))
    print(f"make_bank_and_aux kernels vs plain ({cfg.width}x{cfg.height}, "
          f"{cfg.warp_fields_per_batch} big fields, {wg.bank_size(cfg)} crops): "
          + json.dumps(res, sort_keys=True) + f"; bg_band equal: {band_equal}")
    if not all(r["ok"] for r in res.values()) or not band_equal:
        fail("the bank through the kernels fails the bank gate")
    nan_frac = float(torch.isnan(bk.flow[..., 0]).float().mean())
    print(f"bank: NaN-flagged share {nan_frac:.2e}, |iflow| max "
          f"{float(torch.nan_to_num(bk.iflow).abs().max()):.2f} px, bg |gdisp| "
          f"max {float(ak.bg[:, 0].abs().max()):.2f} px")
    return {"f768": f15, "f1536": full, "aux": ak, "max_abs_err": worst}


def phase_mode9_scene(cfg, atlas, aux, card, dev):
    """Phase 6: the scene kernel vs its plain version at B=4 on samples of
    the main path's step 0 that hold a deforming object and background, as
    the main path renders them and again with inverse flow and id images.
    Returns the first sample, the plain render, the worst comparison and
    the slabs."""
    import dataclasses

    from flowgen_torch.compose import fused
    from flowgen_torch.ops import scene as ps
    from flowgen_torch.pipeline.generator import make_slab_packer
    from flowgen_torch.warpfields import generator as wg

    cfg4 = dataclasses.replace(cfg, batch_size=4)
    n_slots = wg.bank_size(cfg)
    slabs = make_slab_packer(cfg4, dev)(atlas)
    for s in range(cfg.batch_size // 4):
        scenes = sample(cfg4, cfg.seed, 4 * s + torch.arange(4), dev, n_slots)
        n_obj = int((scenes.objects.warp & scenes.objects.valid).sum())
        n_bg = int(scenes.background.warp.sum())
        if n_obj >= 1 and n_bg >= 1:
            break
    else:
        fail("no 4 samples of step 0 hold a deforming object and background")
    args, opts = fused.scene_tables(scenes, cfg4, *slabs, aux)
    worst = 0.0
    for label, extra in (("", {}), (", inverse flow and ids", dict(
            inverse_flow=True, emit_masks=True))):
        o = {**opts, **extra}
        k_out = as_batch(ps.scene_render(*args, **o))
        torch.cuda.synchronize()
        p_out = as_batch(ps.scene_render_plain(*args, **o))
        cmp = gates(k_out, p_out)
        print(f"mode 9 kernel vs plain{label} (samples {4 * s}-{4 * s + 3}, "
              f"{cfg.width}x{cfg.height}, "
              f"{n_obj} deforming objects, {n_bg} deforming backgrounds): "
              + json.dumps(cmp, sort_keys=True))
        if not cmp["ok"]:
            fail(f"mode 9 kernel vs plain gates failed{label}")
        worst = max(worst, cmp["max_abs_err"])
        if not extra:
            plain = p_out
    return 4 * s, plain, worst, slabs


def grid_sample_ms(planes, disp):
    """Time of torch.nn.functional.grid_sample (bilinear, border padding,
    align_corners=True) computing the same clamped row lerp as hwarp_rows on
    the same planes; also its largest difference from the kernel's result."""
    M, C, R, Sp = planes.shape
    xs = torch.arange(Sp, dtype=torch.float32, device=planes.device)
    ys = torch.arange(R, dtype=torch.float32, device=planes.device)
    gx = (xs + disp) * (2.0 / (Sp - 1)) - 1.0
    gy = (ys[:, None] * (2.0 / (R - 1)) - 1.0).expand(M, R, Sp)
    grid = torch.stack([gx, gy], dim=-1)
    call = lambda: torch.nn.functional.grid_sample(
        planes, grid, mode="bilinear", padding_mode="border", align_corners=True)
    return event_ms(call), call()


def phase_bank_timing(fields_by_size, card):
    """Phase 8, bank kernels at 768^2 and 1536^2 (8 fields): the bare
    coarse solve (the kernel's launch on its prepared planes) and, beside
    it, coarse_gdisp_batch as a whole (subsample, transpose and pad, solve,
    two x2 upsamples); hwarp_rows and grid_sample on the same planes."""
    from flowgen_torch.warpfields import compose

    rows = {}
    for size, f in fields_by_size:
        M, C, S, _ = f.shape
        D = f.permute(0, 2, 3, 1)
        dyT, dxT, Lv = compose.coarse_solve_inputs(D)
        solve = lambda: compose.coarse_solve(dyT, dxT, Lv)
        c_ms = event_ms(solve)
        ck = solve()
        with compose.plain_versions():
            cp_ms, cp = host_ms(solve)
        cw_ms = event_ms(lambda: compose.coarse_gdisp_batch(D))
        with compose.plain_versions():
            cwp_ms, _ = host_ms(lambda: compose.coarse_gdisp_batch(D))
        # The solve reads its two planes and writes one, all (N, R, Lp); the
        # whole function reads the coarse subsample (two channels) and writes
        # the full-size plane.
        c_bytes = 3 * dyT.numel() * 4
        cw_bytes = M * Lv * Lv * C * 4 + M * S * S * 4
        gd = compose.coarse_gdisp_batch(D)
        disp = gd.contiguous()
        planes = f.contiguous()
        h_ms = event_ms(lambda: compose.hwarp_rows(planes, disp))
        with compose.plain_versions():
            hp_ms, hp = host_ms(lambda: compose.hwarp_rows(planes, disp))
        hk = compose.hwarp_rows(planes, disp)
        lib_ms, gs = grid_sample_ms(planes, disp)
        # Every plane element read once and written once; the C channels of
        # a field share one displacement row, read once.
        h_bytes = M * S * S * (4 * C + 4 + 4 * C)
        rows[size] = {
            "coarse": {"ms": c_ms, "plain_ms": cp_ms,
                       "bound_ms": 1e3 * c_bytes / PEAK_BYTES_S,
                       "max_abs_err": float((ck - cp).abs().max()),
                       "wrapper_ms": cw_ms, "wrapper_plain_ms": cwp_ms,
                       "wrapper_bound_ms": 1e3 * cw_bytes / PEAK_BYTES_S},
            "hwarp": {"ms": h_ms, "plain_ms": hp_ms, "library_ms": lib_ms,
                      "bound_ms": 1e3 * h_bytes / PEAK_BYTES_S,
                      "max_abs_err": float((hk - hp).abs().max()),
                      "grid_sample_max_diff": float((gs - hk).abs().max())},
        }
        rc, rh = rows[size]["coarse"], rows[size]["hwarp"]
        print(f"bank kernels at {S}^2 x {M} fields: coarse solve {c_ms:.4f} ms "
              f"(plain {cp_ms:.1f} ms, bound {rc['bound_ms']:.4f} ms by bytes, "
              f"max |d| {rc['max_abs_err']}); coarse_gdisp_batch whole "
              f"{cw_ms:.4f} ms (plain {cwp_ms:.1f} ms, bound "
              f"{rc['wrapper_bound_ms']:.4f} ms); hwarp_rows on {M * C * S} x "
              f"{S} rows {h_ms:.4f} ms (plain {hp_ms:.1f} ms, grid_sample "
              f"{lib_ms:.4f} ms, bound {rh['bound_ms']:.4f} ms by bytes, "
              f"grid_sample max |d| {rh['grid_sample_max_diff']:.2e}) [{card}]")
        if rc["max_abs_err"] != 0.0 or rh["max_abs_err"] != 0.0:
            fail(f"bank kernels differ from their plain versions at {S}^2")
    return rows


def phase_quadrant(card, dev):
    """Phase 9: modes 13 and 11 with inverse flow and id images, the scene
    kernel vs its plain version at 512x384, B=4 (samples 0-3 of seed 0).
    Returns mode 13's plain render, the worst comparison and its slabs
    (the packer's triple, which the B=64 main path shares)."""
    import flowgen_torch
    from flowgen_torch.ops import scene as ps
    from flowgen_torch.pipeline.generator import make_slab_packer

    worst, keep = 0.0, None
    for mode in (13, 11):
        cfg4 = flowgen_torch.DataGenConfig(
            mode=mode, batch_size=4, seed=0, compute_inverse_flow=True,
            emit_masks=True)
        slabs = make_slab_packer(cfg4, dev)(flowgen_torch.atlas_for_config(cfg4))
        args, opts = scene_tables(cfg4, 0, 0, slabs, dev)
        n_rot = int((args[1][:, :, 1, ps.OMI_TEX] >= slabs[0].shape[0] // 2
                     ).sum())
        k_out = as_batch(ps.scene_render(*args, **opts))
        torch.cuda.synchronize()
        p_out = as_batch(ps.scene_render_plain(*args, **opts))
        cmp = gates(k_out, p_out)
        print(f"mode {mode} kernel vs plain (B=4, 512x384, tsplit "
              f"{opts['spec_key'][6]}, slabs {tuple(slabs[0].shape)}, {n_rot} "
              f"objects on rot90 slabs, inverse flow and ids): "
              + json.dumps(cmp, sort_keys=True))
        if not cmp["ok"]:
            fail(f"mode {mode} kernel vs plain gates failed")
        worst = max(worst, cmp["max_abs_err"])
        if mode == 13:
            keep = (p_out, slabs)
    return keep[0], worst, keep[1]


def phase_mode13(card, dev):
    """Phases 9-11. Returns the scene kernel's mode-13 numbers."""
    import flowgen_torch
    from flowgen_torch.ops import scene as ps

    plain4, worst, slabs = phase_quadrant(card, dev)
    cfg = flowgen_torch.DataGenConfig(mode=13, batch_size=64, seed=0,
                                      compute_inverse_flow=True,
                                      emit_masks=True)
    atlas = flowgen_torch.atlas_for_config(cfg)

    # ---- 10: the main path ----
    first, res = run_main_path(cfg, atlas, card)
    g = gates({k: v[:4] for k, v in first.items()}, plain4)
    print("mode 13 main path step 0 vs plain (samples 0-3): "
          + json.dumps(g, sort_keys=True))
    if not g["ok"]:
        fail("mode 13 main path output disagrees with the plain render")
    del first
    if any(res["launches"][k] for k in ("coarse_gdisp", "hwarp_rows")):
        fail("the mode-13 path launched bank kernels")
    layers = layer_breakdown(cfg, slabs, dev)
    print("mode 13 layers (ms per step, host clock, synchronized): "
          + json.dumps({k: round(v, 3) for k, v in layers.items()})
          + f" [{card}]")

    # ---- 11: scene kernel timing at B=64 ----
    args, opts = scene_tables(cfg, 0, 0, slabs, dev)
    k_ms = event_ms(lambda: ps.scene_render(*args, **opts))
    k_out = ps.scene_render(*args, **opts)
    p_ms, p_out = host_ms(lambda: ps.scene_render_plain(*args, **opts))
    g64 = gates(as_batch(k_out), as_batch(p_out))
    bd = bound(args, opts)
    print(f"mode 13 scene kernel (B=64, inverse flow and ids): {k_ms:.3f} ms "
          f"per launch (CUDA events, 10 launches); plain version {p_ms:.1f} "
          f"ms; bound {bd['bound_ms']:.4f} ms by {bd['bound_by']} "
          f"({bd['bytes']:.4e} bytes, {bd['operations']:.4e} float ops) "
          f"[{card}]")
    print("mode 13 kernel vs plain (scene, B=64): "
          + json.dumps(g64, sort_keys=True))
    if not g64["ok"]:
        fail("mode 13 kernel vs plain gates failed at B=64")
    return {"launches": res["launches"]["scene_render"], "ms": k_ms,
            "plain_ms": p_ms, "bound_ms": bd["bound_ms"],
            "bound_by": bd["bound_by"],
            "max_abs_err": max(worst, g["max_abs_err"], g64["max_abs_err"])}


def main():
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a GPU")
    import flowgen_torch
    from flowgen_torch.compose import fused
    from flowgen_torch.ops import _build
    from flowgen_torch.ops import scene as ps
    from flowgen_torch.warpfields import generator as wg

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    name = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__}")
    print(f"cuda {torch.version.cuda}")
    print(card)

    # ---- 1: build, one nvcc per source, all at once ----
    t0 = time.time()
    _build.build_all()
    print(f"build: {time.time() - t0:.1f} s for {len(_build.LIBRARIES)} "
          f"libraries [{card}]")
    for lib, info in _build.BUILD_INFO.items():
        print(f"  {lib}: nvcc {info['seconds']:.1f} s")
        for ln in ptxas_summary(info["log"]):
            print(f"    {ln}")

    # ---- 2-4: mode 7 ----
    m7 = phase_mode7(card, dev)

    # ---- 5: bank kernels vs plain ----
    cfg = flowgen_torch.DataGenConfig(mode=9, batch_size=64, seed=0)
    atlas = flowgen_torch.atlas_for_config(cfg)
    bank = phase_bank(cfg, dev)

    # ---- 6: mode-9 scene kernel vs plain ----
    s0, plain9, worst9, slabs = phase_mode9_scene(cfg, atlas, bank["aux"],
                                                  card, dev)

    # ---- 7: the mode-9 main path ----
    first, res = run_main_path(cfg, atlas, card, prof_steps=4)
    g = gates({k: v[s0 : s0 + 4] for k, v in first.items()}, plain9)
    print(f"mode 9 main path step 0 vs plain (samples {s0}-{s0 + 3}): "
          + json.dumps(g, sort_keys=True))
    if not g["ok"]:
        fail("mode 9 main path output disagrees with the plain render")
    del first
    counts = res["launches"]
    built = counts["coarse_gdisp"] // 18
    if not all(counts.values()) or counts["coarse_gdisp"] != 18 * built or (
            counts["hwarp_rows"] != 34 * built):
        fail(f"the mode-9 path's kernel launches are off: {counts}")
    print(f"mode 9 bank epochs built: {built} (18 coarse_gdisp and 34 "
          f"hwarp_rows launches each) for {res['dispatched']} steps "
          f"dispatched, {cfg.warp_bank_reuse_steps} steps an epoch")
    layers = layer_breakdown(cfg, slabs, dev)
    print("mode 9 layers (ms per step, host clock, synchronized): "
          + json.dumps({k: round(v, 3) for k, v in layers.items()})
          + f" [{card}]")

    # ---- 8: per-kernel timing at the main path's shapes ----
    idx = torch.arange(cfg.batch_size)
    scenes = sample(cfg, cfg.seed, idx, dev, wg.bank_size(cfg))
    args, opts = fused.scene_tables(scenes, cfg, *slabs, bank["aux"])
    k_ms = event_ms(lambda: ps.scene_render(*args, **opts))
    k_out = ps.scene_render(*args, **opts)
    p_ms, p_out = host_ms(lambda: ps.scene_render_plain(*args, **opts))
    g64 = gates(as_batch(k_out), as_batch(p_out))
    bd = bound(args, opts)
    print(f"mode 9 scene kernel (B=64): {k_ms:.3f} ms per launch (CUDA events, "
          f"10 launches); plain version {p_ms:.1f} ms; bound "
          f"{bd['bound_ms']:.4f} ms by {bd['bound_by']} "
          f"({bd['bytes']:.4e} bytes, {bd['operations']:.4e} float ops) "
          f"[{card}]")
    print("mode 9 kernel vs plain (scene, B=64): " + json.dumps(g64, sort_keys=True))
    if not g64["ok"]:
        fail("mode 9 kernel vs plain gates failed at B=64")
    m9 = {"launches": counts["scene_render"], "ms": k_ms, "plain_ms": p_ms,
          "bound_ms": bd["bound_ms"], "bound_by": bd["bound_by"],
          "max_abs_err": max(worst9, g["max_abs_err"], g64["max_abs_err"])}
    bt = phase_bank_timing((("768", bank["f768"]), ("1536", bank["f1536"])), card)
    h768, h1536 = bt["768"]["hwarp"], bt["1536"]["hwarp"]
    c768, c1536 = bt["768"]["coarse"], bt["1536"]["coarse"]
    bank_err = bank["max_abs_err"]
    del bank, slabs, args, k_out, p_out

    # ---- 9-11: modes 13 and 11, the mode-13 main path ----
    m13 = phase_mode13(card, dev)

    rows = [
        {
            "name": "scene_render", "route": "cuda",
            "source": "flowgen_torch/csrc/scene.cu",
            "replaces": "flowgen/ops/pallas_scene.py:1510",
            "launches": m13["launches"],
            "max_abs_err": max(m7["max_abs_err"], m9["max_abs_err"],
                               m13["max_abs_err"]),
            "ms": m13["ms"], "plain_ms": m13["plain_ms"],
            "bound_ms": m13["bound_ms"], "bound_by": m13["bound_by"],
            "library_ms": None,
            "path": "mode 13 with inverse flow and masks, B=64",
            "mode9": m9, "mode7": m7,
        },
        {
            "name": "coarse_gdisp", "route": "cuda",
            "source": "flowgen_torch/csrc/fields.cu",
            "replaces": "flowgen/warpfields/pallas_fields.py:98",
            "launches": counts["coarse_gdisp"],
            "max_abs_err": max(bank_err, c768["max_abs_err"],
                               c1536["max_abs_err"]),
            "ms": c768["ms"], "plain_ms": c768["plain_ms"],
            "bound_ms": c768["bound_ms"], "bound_by": "bytes",
            "library_ms": None,
            "shape": "the solve on 8 fields of 768^2 (16 of the 18 launches "
                     "of an epoch); wrapper_* time coarse_gdisp_batch whole",
            "at_1536": c1536,
        },
        {
            "name": "hwarp_rows", "route": "cuda",
            "source": "flowgen_torch/csrc/fields.cu",
            "replaces": "flowgen/warpfields/pallas_fields.py:174",
            "launches": counts["hwarp_rows"],
            "max_abs_err": max(bank_err, h768["max_abs_err"],
                               h1536["max_abs_err"]),
            "ms": h768["ms"], "plain_ms": h768["plain_ms"],
            "bound_ms": h768["bound_ms"], "bound_by": "bytes",
            "library_ms": h768["library_ms"],
            "shape": "12288 x 768 rows (32 of the 34 launches of an epoch)",
            "at_1536": h1536,
        },
    ]
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
