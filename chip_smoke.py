#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (flowgen_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero before the final line):
  1. versions, the card's name and power limit, and the build of every CUDA
     kernel from flowgen_torch/csrc (nvcc), with the ptxas register /
     shared-memory / spill summary;
  2. kernel vs plain: mode-7 scenes from seed 0 at 512x384, B=4, rendered by
     the CUDA scene kernel and by its plain PyTorch version on the same
     tables (background only first, then the full scene), held to the JAX
     package's on-device gates (tools/check_pallas_tpu.py): images under 1%
     of values >= 1 level apart and under 1e-4 >= 2 levels; flow median
     |d| < 1e-4 px and under 1e-3 of values with |d| > 0.01 px;
  3. the main path: Generator(DataGenConfig(mode=7, batch_size=64, seed=0))
     over the 32-texture procedural atlas, 2 warm-up and 5 timed steps,
     output checks (shapes, u8-valued images, finite flow, and samples 0-3
     of step 0 against the plain render of phase 2), launch counts,
     ms/step, samples/s, peak memory, the device's busy share and a
     per-layer breakdown;
  4. per-kernel timing at the main path's shapes (B=64): the kernel by CUDA
     events, its plain version once, and the bound from this run's inputs;
     then one JSON line {"kernels": [...]}, and last the line
     {"ok": true, "device": {...}}.

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


def scene_tables(cfg, seed: int, step: int, slabs, device):
    """The scene kernel's inputs for one batch of the port's main path:
    (args, spec_key, use_aa) from ``fused.scene_tables``."""
    from flowgen_torch.compose import fused
    from flowgen_torch.params.sampler import sample_scene_batch
    from flowgen_torch.random.streams import root_key

    idx = step * cfg.batch_size + torch.arange(cfg.batch_size, device=device)
    scenes = sample_scene_batch(root_key(seed, device), idx, cfg)
    return fused.scene_tables(scenes, cfg, *slabs)


def layer_breakdown(cfg, slabs, device, steps: int = 3):
    """Host-clock time of each layer of one main-path step (sampler,
    precompute, scene kernel, output adapter), each ended by a device
    synchronize, averaged over ``steps`` steps."""
    from flowgen_torch.compose import fused
    from flowgen_torch.ops import scene as ps
    from flowgen_torch.params.sampler import sample_scene_batch
    from flowgen_torch.pipeline.generator import _adapt_output
    from flowgen_torch.random.streams import root_key

    acc = {"sampler": 0.0, "precompute": 0.0, "scene_kernel": 0.0, "adapt": 0.0}
    root = root_key(cfg.seed, device)

    def tick(t0):
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    for step in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        idx = step * cfg.batch_size + torch.arange(cfg.batch_size, device=device)
        scenes = sample_scene_batch(root, idx, cfg)
        acc["sampler"] += tick(t0)
        t0 = time.perf_counter()
        args, key, use_aa = fused.scene_tables(scenes, cfg, *slabs)
        acc["precompute"] += tick(t0)
        t0 = time.perf_counter()
        frames, flow = ps.scene_render(*args, spec_key=key, use_aa=use_aa)
        acc["scene_kernel"] += tick(t0)
        t0 = time.perf_counter()
        im = [unpack(frames[:, f]) for f in (0, 1)]
        _adapt_output(im[0], im[1], flow.permute(0, 2, 3, 1), None, cfg)
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


def as_batch(frames, flow):
    """Scene-kernel output (frames (B,2,H,W) packed, flow (B,2,H,W)) as the
    main path's (image0, image1, flow0) in NHWC."""
    return unpack(frames[:, 0]), unpack(frames[:, 1]), flow.permute(0, 2, 3, 1)


def gates(a, b):
    """The JAX package's on-device gates between two (image0, image1, flow0)
    triples."""
    dimg = [(a[i] - b[i]).abs() for i in (0, 1)]
    img1 = max(float((d >= 1).float().mean()) for d in dimg)
    img2 = max(float((d >= 2).float().mean()) for d in dimg)
    dflow = (a[2] - b[2]).abs()
    res = {
        "img_frac_ge_1": img1,
        "img_frac_ge_2": img2,
        "max_img_diff": max(float(d.max()) for d in dimg),
        "flow_median": float(dflow.flatten().median()),
        "flow_frac_gt_0.01": float((dflow > 0.01).float().mean()),
        "flow_max": float(dflow.max()),
    }
    res["max_abs_err"] = max(res["max_img_diff"], res["flow_max"])
    res["ok"] = (img1 < 0.01 and img2 < 1e-4 and res["flow_median"] < 1e-4
                 and res["flow_frac_gt_0.01"] < 1e-3)
    return res


def bound(args, key, use_aa):
    """Least time for the scene kernel's work on these inputs: the larger of
    a bytes time and a float-operations time.

    Bytes: both packed frames and both flow planes written once, plus the
    slab texels the output depends on, read once. Per pixel of each frame,
    walking the work units against painter's order, a unit's texels count
    where its blend mask (the plain version's coverage, inside the unit's
    ownership rectangle) is above 0 and no later unit covers the pixel fully;
    the background's count where no unit covers it fully. A frame-0 object
    pixel reads one texel; a resampled pixel its source footprint |det|, at
    most its 4 bilinear taps. Operations: the (polygon edge, owned pixel)
    pairs and fat-ellipse owned pixels that the coverage loops evaluate
    after the row-block culls."""
    from flowgen_torch.ops import scene as ps

    (_, omi, omf, tmi, tmf, bgm, edges, _, _, wl, nu) = args
    dev = edges.device
    omi, omf, tmi, tmf, bgm, edges_np, wl, nu = (
        a.detach().cpu().numpy()
        for a in (omi, omf, tmi, tmf, bgm, edges, wl, nu))
    H, W = key[-2:]
    B, K = omi.shape[:2]
    wh, ww = min(ps.WIN_H, H), min(ps.WIN_W, W)
    nb = wh // 8
    out_bytes = B * 2 * H * W * 4 + B * 2 * H * W * 4
    tex = torch.zeros((), dtype=torch.float64, device=dev)
    ops = 0.0
    for b in range(B):
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
                m = (aa if use_aa else ins)[oy0 - y0w : oy1 - y0w,
                                            ox0 - x0w : ox1 - x0w]
                top = opaque[oy0:oy1, ox0:ox1]
                if fr == 0:
                    foot = 1.0
                else:
                    c = tmf[b, k, 1, t]
                    foot = min(abs(float(c[0] * c[4])), 4.0)
                tex += foot * ((m > 0) & ~top).sum()
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
    nbytes = out_bytes + 4.0 * float(tex)
    t_bytes = nbytes / PEAK_BYTES_S
    t_ops = ops / PEAK_F32_S
    return {
        "bytes": nbytes, "operations": ops,
        "bound_ms": 1e3 * max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
    }


def main():
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a GPU")
    import flowgen_torch
    from flowgen_torch.ops import _build
    from flowgen_torch.ops import scene as ps
    from flowgen_torch.pipeline.generator import Generator, make_slab_packer

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    name = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__}")
    print(f"cuda {torch.version.cuda}")
    print(card)

    # ---- 1: build ----
    t0 = time.time()
    for lib in _build.LIBRARIES:
        _build.build(lib)
    print(f"build: {time.time() - t0:.1f} s for {len(_build.LIBRARIES)} "
          f"librar{'y' if len(_build.LIBRARIES) == 1 else 'ies'} [{card}]")
    for lib, info in _build.BUILD_INFO.items():
        print(f"  {lib}: nvcc {info['seconds']:.1f} s")
        for ln in ptxas_summary(info["log"]):
            print(f"    {ln}")

    cfg4 = flowgen_torch.DataGenConfig(mode=7, batch_size=4, seed=0)
    atlas = flowgen_torch.atlas_for_config(cfg4)
    slabs = make_slab_packer(cfg4, dev)(atlas)

    # ---- 2: kernel vs plain at 512x384, B=4 ----
    args, key, use_aa = scene_tables(cfg4, 0, 0, slabs, dev)
    for label, bg_only in (("background", True), ("scene", False)):
        k_out = as_batch(*ps.scene_render(*args, spec_key=key, use_aa=use_aa,
                                          bg_only=bg_only))
        torch.cuda.synchronize()
        plain4 = as_batch(*ps.scene_render_plain(*args, spec_key=key,
                                                 use_aa=use_aa, bg_only=bg_only))
        torch.cuda.synchronize()
        cmp = gates(k_out, plain4)
        print(f"kernel vs plain ({label}, B=4, 512x384): "
              + json.dumps(cmp, sort_keys=True))
        if not cmp["ok"]:
            fail(f"kernel vs plain gates failed ({label})")

    # ---- 3: the main path ----
    cfg = flowgen_torch.DataGenConfig(mode=7, batch_size=64, seed=0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ps.scene_render.launches = 0
    gen = Generator(cfg, atlas=atlas, device="cuda")
    first = gen.retrieve_batch()
    gen.retrieve_batch()
    torch.cuda.synchronize()
    # Step 0 holds samples 0..3 of the kernel-vs-plain phase: content depends
    # only on (seed, global sample index).
    g = gates(tuple(first[k][:4] for k in ("image0", "image1", "flow0")), plain4)
    print("main path step 0 vs plain (samples 0-3): "
          + json.dumps(g, sort_keys=True))
    if not g["ok"]:
        fail("main path output disagrees with the plain render")
    del first
    n_steps = 5
    t0 = time.perf_counter()
    for _ in range(n_steps):
        out = gen.retrieve_batch()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    prof_steps = 3
    wall_ms, busy_ms, n_cuda = device_busy(gen, prof_steps)
    launches = ps.scene_render.launches
    dispatched = gen.step
    gen.stop()
    peak = torch.cuda.max_memory_allocated()
    im0, im1, fl = out["image0"], out["image1"], out["flow0"]
    if tuple(im0.shape) != (64, 384, 512, 3) or tuple(im1.shape) != (
            64, 384, 512, 3):
        fail(f"image shapes {tuple(im0.shape)} {tuple(im1.shape)}")
    if tuple(fl.shape) != (64, 384, 512, 2):
        fail(f"flow shape {tuple(fl.shape)}")
    for im in (im0, im1):
        if not bool(((im == im.round()) & (im >= 0) & (im <= 255)).all()):
            fail("images are not integer values in [0, 255]")
    if not bool(torch.isfinite(fl).all()):
        fail("flow has non-finite values")
    if launches != dispatched or launches == 0:
        fail(f"scene kernel launches {launches} != steps dispatched "
             f"{dispatched}")
    ms = 1e3 * dt / n_steps
    print(f"main path (mode 7, B=64, 512x384): {ms:.2f} ms/step, "
          f"{64 * n_steps / dt:.1f} samples/s over {n_steps} timed steps, "
          f"peak memory {peak / 2**30:.2f} GiB, scene kernel launches "
          f"{launches} for {dispatched} steps dispatched [{card}]")
    if busy_ms > 0:
        print(f"device busy (torch.profiler, {prof_steps} steps): "
              f"{busy_ms / prof_steps:.2f} of {wall_ms / prof_steps:.2f} ms "
              f"per step, idle share {1 - busy_ms / wall_ms:.3f}, "
              f"{n_cuda / prof_steps:.0f} CUDA kernels per step [{card}]")
    else:
        print("device busy: not measured (torch.profiler recorded no "
              "device time)")
    layers = layer_breakdown(cfg, slabs, dev)
    print("layers (ms per step, host clock, synchronized): "
          + json.dumps({k: round(v, 3) for k, v in layers.items()})
          + f" [{card}]")

    # ---- 4: per-kernel timing at the main path's shapes ----
    args, key, use_aa = scene_tables(cfg, 0, 0, slabs, dev)
    before = ps.scene_render.launches
    for _ in range(2):
        k_out = ps.scene_render(*args, spec_key=key, use_aa=use_aa)
    torch.cuda.synchronize()
    reps = 10
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
        enable_timing=True)
    e0.record()
    for _ in range(reps):
        k_out = ps.scene_render(*args, spec_key=key, use_aa=use_aa)
    e1.record()
    torch.cuda.synchronize()
    k_ms = e0.elapsed_time(e1) / reps
    ps.scene_render.launches = before   # timing launches are not counted
    t0 = time.perf_counter()
    p_out = ps.scene_render_plain(*args, spec_key=key, use_aa=use_aa)
    torch.cuda.synchronize()
    p_ms = 1e3 * (time.perf_counter() - t0)
    g = gates(as_batch(*k_out), as_batch(*p_out))
    bd = bound(args, key, use_aa)
    print(f"scene kernel (B=64): {k_ms:.3f} ms per launch (CUDA events, "
          f"{reps} launches); plain version {p_ms:.1f} ms; bound "
          f"{bd['bound_ms']:.4f} ms by {bd['bound_by']} "
          f"({bd['bytes']:.4e} bytes, {bd['operations']:.4e} float ops) "
          f"[{card}]")
    print("kernel vs plain (scene, B=64): " + json.dumps(g, sort_keys=True))
    if not g["ok"]:
        fail("kernel vs plain gates failed at B=64")
    row = {
        "name": "scene_render",
        "route": "cuda",
        "source": "flowgen_torch/csrc/scene.cu",
        "replaces": "flowgen/ops/pallas_scene.py:1510",
        "tpu_kernel": "flowgen/ops/pallas_scene.py:scene_render_pallas",
        "launches": launches,
        "max_abs_err": max(cmp["max_abs_err"], g["max_abs_err"]),
        "max_img_diff": max(cmp["max_img_diff"], g["max_img_diff"]),
        "flow_median": max(cmp["flow_median"], g["flow_median"]),
        "ms": k_ms,
        "plain_ms": p_ms,
        "bound_ms": bd["bound_ms"],
        "bound_by": bd["bound_by"],
        "library_ms": None,
        "ok": bool(cmp["ok"] and g["ok"]),
    }
    print(json.dumps({"kernels": [row]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
