#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (flowgen_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero before the final line):
  1. versions, the card's name and power limit, and the build of every CUDA
     kernel source in flowgen_torch/csrc (one nvcc each) and of the native
     texture loader (g++), all started together, with the ptxas register /
     shared-memory / spill summary;
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
  4. mode 7, the scene kernel's timing at B=64 on step 0's tables: CUDA
     events, the background pass alone (bg_only) beside the full launch
     (the difference is the object loop), the plain version once, the
     bound from this run's inputs; the launch with inverse flow and id
     images held against the plain version bit for bit, and the main
     path's launch against it;
  5. mode 9, bank kernels vs plain at the main path's shapes: one doubling
     of the 8 half-lattice fields (768^2) and one of the full-size fields
     (1536^2), each through coarse_gdisp_batch and hwarp_rows against their
     plain versions, then the whole make_bank_and_aux (the aux solve at 1536
     and the background bands included) through the kernels against the
     same through the plain versions: max difference 0 expected; the bank
     gate is a NaN-mask mismatch under 1e-4 plus the flow gate;
  6. mode 9, scene kernel vs plain at 512x384, B=4, on samples of the main
     path's step 0 that hold a deforming object and a deforming background;
  7. the mode-9 main path: Generator(DataGenConfig(mode=9, batch_size=64,
     seed=0)), 2 warm-up and 5 timed steps across bank epochs, the same
     checks and numbers as phase 3, with a bank-producer layer;
  8. mode 9, per-kernel timing at the main path's shapes (scene kernel at
     B=64 as in phase 4; coarse_gdisp_batch whole, its two kernels, on 8
     fields of 768^2, 1536^2 and 3072^2, the last Sintel mode 9's full-size
     doubling, each against its plain version bit for bit; hwarp_rows at
     768^2 and 1536^2): CUDA events back to back and with a cold L2, the
     plain versions once, the bound, and for hwarp_rows the time of
     torch.nn.functional.grid_sample on the same planes; then every
     hwarp_rows launch (34) and every coarse_gdisp_batch call (18) of one
     bank epoch, each against its plain version and timed alone with a
     cold L2, summed; and torch.profiler's count of CUDA kernels in one
     coarse_gdisp_batch call (2 expected) and in the epoch, taken in a
     fresh process of this script (chip_smoke.py --coarse-kernel-counts);
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
 11. mode 13, the scene kernel's timing and bit-for-bit check at B=64 as
     in phase 4;
 12. the windowed renderer at MPI-Sintel's 1024x436 (frames not a multiple
     of (8, 128)): the mode-9 crop bank (3072^2 big fields) through the
     bank kernels against their plain versions; renders of B=4 through the
     window kernels (object_window, polygon_coverage) against their plain
     versions, in mode 7, mode 7 with flow1 and masks, and mode 9 on
     samples with a deforming object and background (the gates above, max
     difference 0 expected); at 512x384, per-object windows against
     full-frame windows and the windowed forward flow against the scene
     kernel's, bit for bit;
 13. the windowed mode-7 main path: Generator(DataGenConfig(mode=7,
     height=436, width=1024, batch_size=64, seed=0)), the checks and numbers
     of phase 3 (samples 0-3 of step 0 against the plain render of phase
     12), launches per step, and layers (sampler, background pass, object
     loop, adapt);
 14. the same for mode 9 (3 timed steps), with a bank-producer layer;
 15. step 0 of the windowed mode-7 and mode-9 paths (B=64) with every
     object_window launch held against its plain version on the planes as
     it found them (bit for bit, the sign of a zero aside), each timed
     alone with a cold L2 and summed with its bound (bytes counted from
     the launch's coverage) (and the largest launch of each window class also back to
     back); polygon_coverage's largest launch of the mode-9 step, and all
     its launches of that step held against the plain version bit for
     bit, timed and summed the same way; the
     standalone affine_resample on a 192x256 window of a 512x384 texture's
     slab and on whole 384x512 and 436x1024 frames from the 2H x 2W
     sources (as the background pass resamples them): CUDA events, the
     plain versions once, the bound, and beside it an empty kernel's launch
     timed the same way (the floor); the window again with band widths of
     1 and 2 tiles (x_tiles_scan, y_tiles_scan), bit for bit;
 16. photometric augmentation in mode 7 at 512x384, B=64: the CUDA kernels
     (csrc/photometric.cu: the table pass and the value pass) against
     their plain version on step 0's rendered frames and on frames off the
     whole levels, bit for bit; their time by CUDA events, the plain
     version's and the bound (bytes against the hash's int32 operations),
     their registers (ptxas) and the value loop's SASS count a value
     (cuobjdump) with the integer ALU's and the issue slots' times; the
     pipelined
     main path through Generator with the stage (its step 0 held against
     the kernel's output) and without it, in the same call;
 17. a TextureDB of 64 texture files written from seed 0 in three size
     classes (768x1024, 300x400 small, 1536x2048 large), read from a list
     file through atlas_for_config (native field of view) and, for the
     canonical atlas, through the native loader (built with g++ in phase
     1); in modes 7 and 13 (flow1 and masks) at 512x384, B=64, the scene
     kernel against its plain version on step 0's tables bit for bit and
     timed (as phase 4), and the main path through Generator with its
     throughput and peak memory; the windowed renderer at 1024x436, B=4,
     mode 7, from the database's canonical array, through the window
     kernels against their plain versions, bit for bit (the sign of a zero
     aside);
 18. mode 9 with the "xla" bank stream (quad-gather doublings and the
     gather solve, plain PyTorch): the bank and warp planes of one epoch at
     128x96 on the card against the same function on the CPU (bank gate);
     at 512x384 the scene kernel on the stream's warp planes against its
     plain version on samples 0-3 of step 0 (inverse flow and ids), bit for
     bit; the main path through Generator (B=64, 2 warm-up and 5 timed
     steps) beside phase 7's, with no composition kernel launched (the
     elementary field takes its kernel in both streams); the bank
     producer's ms per epoch at 1536^2 in both streams;
 19. the windowed renderer at 1024x436, B=4, mode 9 with the "xla" stream
     (3072^2 fields), through the window kernels against their plain
     versions, bit for bit (the sign of a zero aside);
 20. the public API: the DataLoader over torch_iterable_dataset and
     FlowStepDataSource against Generator's steps, make_mixed_generate_fn
     over modes 7 and 9 against the numpy draw and its ingredients' own
     batches, one step of examples/train.prototxt (all bit for bit); then
     FlowNetS (width 32) trained for 10 fused generate-and-train steps on
     mode 7 with photometric augmentation at B=64 (convolutions in TF32,
     PyTorch's default), every loss finite and every parameter moved, its
     generate and train step times, samples/s and peak memory; and its
     forward pass on the card with TF32 off against the CPU's (|d| <= 1e-4
     + 1e-4 |want|);
 21. generation over a torch.distributed DeviceMesh: at world size 1 (one
     nccl rank, a "cuda" mesh ("data",)) make_sharded_generate_fn in modes
     7 and 9 at B=64 over steps 0-2 (across a bank epoch) and windowed
     mode 9 at B=16, each rank's to_local() against make_generate_fn's
     batch bit for bit, every kernel count set to 0 before each sharded
     step and read after (the sharded path's launches, in the kernels
     line as "sharded_launches"); Generator(cfg, mesh=mesh) in mode 7 at
     B=64, ms/step and samples/s beside phase 3's; two spawned ranks in a
     gloo group sharing the card (a "cuda" mesh of two ranks on cuda:0),
     modes 7 and 9 at B=16 over steps 0-2, each shard against its rows of
     the single-process batch bit for bit, and distribute_atlas of two
     16-texture halves against the 32-texture atlas; FlowNetS (width 32)
     on a ("data", "model") = (1, 1) mesh (shard_model), one sharded
     generate-and-train step on mode 7 with photometric augmentation
     against the unsharded step, loss and gradients bit for bit with TF32
     off and deterministic algorithms, the unsharded step run twice beside
     it;
 22. the modes no other phase holds on the card, through
     tools/torch_check_kernels.py at 512x384, B=4: modes 1-6, 8, 10, 12
     and disparity_mode(7), disparity_mode(9), the scene kernel against its
     plain version, both on the card, with inverse flow and ids (the JAX
     tool's gates are the bar; the values with other bits are printed, 0
     expected), and the fused renderer against the windowed one (flow
     equal in the rigid modes, image medians within 1 level);
 23. coarse_gdisp_batch at every lattice stride (1, 2, 4, 8) and step count
     (0, 4, 8, 20) on the bank's 8 fields of 768^2 and 3072^2, each against
     its plain version bit for bit, timed by CUDA events with its bytes
     bound and share (the coarse_gdisp row's "strides"); the keyed "pallas"
     big field at 384^2 on the card against the CPU, bit for bit; the
     row's "launches" there are the kernel launches of the mode-9 main
     path's calls (phase 7) at any stride or step count but the bank's
     (4, 8), each call's recorded as it ran;
 24. bench_torch.py's cells in this process (bench_torch._bench_mode:
     make_generate_fn, each step ended by one value read to the host and a
     synchronize, after the cell's gc.collect, empty_cache and peak reset):
     mode 7 at B=64 over 8 steps and mode 9 over 6 steps with the
     pipelined rate, their legacy-form JSON lines (bench_torch.py MODE
     BATCH), mode 9's per-step ms and the peaks, every kernel count at 0
     before each cell and read after (the scene kernel once a step; the
     bank kernels 36 and 34 an epoch built); then mode 13 with flow1 and
     masks (phase 10's cell) the same way, its peak beside phase 10's;
 25. the elementary field's kernel (csrc/fields.cu:elementary_field_kernel)
     at the chairs cells' bank epoch (2 big fields of 1536^2 and their
     inverses: 4 directions, 63 displacers, the 768^2 half lattice) and at
     Sintel's (2 of 3072^2: 270 displacers, 1536^2): against its plain
     version bit for bit (the sign of a zero included), its time by CUDA
     events alone and as the whole call with the constants' derivation,
     the plain version once, the fp32-issue bound, its registers and the
     SASS of its displacer loop a (pixel, displacer) pair;
then one JSON line {"kernels": [...]} with eight rows, and last the line
{"ok": true, "device": {...}}.

It needs the repository (it imports flowgen_torch from its own directory),
a CUDA card and nvcc. It imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import functools
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
# Written before each cold-L2 timing: four times the H100's 50 MB L2.
L2_FLUSH_BYTES = 200 * 2**20


@functools.lru_cache(maxsize=None)
def procedural_atlas(height: int, width: int):
    """The configuration's procedural atlas (``atlas_for_config``), built
    once per frame size: phases of one size share it."""
    import flowgen_torch

    return flowgen_torch.atlas_for_config(
        flowgen_torch.DataGenConfig(height=height, width=width))


_T0 = time.perf_counter()


def stamp(label: str):
    print(f"[{time.perf_counter() - _T0:.1f} s] {label}", flush=True)


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


def ptxas_registers(log: str):
    """{entry function: registers a thread} from nvcc's -Xptxas -v log."""
    regs, entry = {}, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            entry = m.group(1)
        m = re.search(r"Used (\d+) registers", ln)
        if m and entry:
            regs[entry] = int(m.group(1))
            entry = None
    return regs


def occupancy(regs: int, threads: int, smem: int = 0):
    """Blocks and warps an H100 SM holds of a kernel with ``regs``
    registers a thread (allocated per warp in units of 256), ``threads`` a
    block and ``smem`` bytes of shared memory a block: 65,536 registers, 64
    warps, 32 blocks and 228 KB of shared memory an SM."""
    warps = -(-threads // 32)
    per_warp = -(-regs * 32 // 256) * 256
    blocks = min(32, 64 // warps, 65536 // (per_warp * warps))
    if smem:
        blocks = min(blocks, (228 * 1024) // (smem + 1024))
    return {"registers": regs, "blocks_per_sm": blocks,
            "warps_per_sm": blocks * warps,
            "occupancy": blocks * warps / 64.0}


# SASS opcode families (the part before the first dot): the integer ALU's,
# the integer multiply-adds that issue to the FMA pipe, and float64.
SASS_INT = {"IADD3", "IADD", "IADD32I", "LOP3", "LOP", "LOP32I", "SHF", "SHL",
            "SHR", "LEA", "PRMT", "ISETP", "IMNMX", "IABS", "SEL", "FLO",
            "POPC", "BREV", "BMSK", "SGXT", "ISCADD", "BFE", "BFI", "VIADD",
            "VIMNMX"}
SASS_IMAD = {"IMAD", "IMUL", "IMAD32I"}


def sass_text(lib_path: str) -> str:
    """``cuobjdump -sass`` of a built library."""
    from flowgen_torch.ops import _build

    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    r = subprocess.run([tool, "-sass", lib_path], capture_output=True,
                       text=True, timeout=120)
    if r.returncode != 0:
        fail(f"cuobjdump failed: {r.stderr.strip()}")
    return r.stdout


def sass_functions(lib_path: str):
    """{mangled kernel name: [(address, opcode, branch target or None)]}
    from ``cuobjdump -sass`` of a built library."""
    funcs, cur, labels, pending = {}, None, {}, []
    for ln in sass_text(lib_path).splitlines():
        m = re.match(r"\s*Function : (\S+)", ln)
        if m:
            cur = funcs.setdefault(m.group(1), [])
            labels = {}
            continue
        m = re.match(r"\s*(\.L_x_\d+):", ln)
        if m and cur is not None:
            pending.append(m.group(1))
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?"
                     r"([A-Z][A-Z0-9_.]*)([^;]*);", ln)
        if not m or cur is None:
            continue
        addr = int(m.group(1), 16)
        for lab in pending:
            labels[lab] = addr
        pending = []
        target = None
        if m.group(2).split(".")[0] in ("BRA", "BRX"):
            t = re.search(r"\(?(\.L_x_\d+)\)?|0x([0-9a-f]+)", m.group(3))
            if t:
                target = t.group(1) or int(t.group(2), 16)
        cur.append([addr, m.group(2), target, labels])
    out = {}
    for name, ins in funcs.items():
        out[name] = [(a, op, lab[t] if isinstance(t, str) else t)
                     for a, op, t, lab in ins]
    return out


def sass_loop_counts(ins, values: int, drop_f64: bool = True):
    """Per-value instruction counts of a kernel's outermost loop: the
    instructions between the target of its widest backward branch and the
    branch, divided by the ``values`` one iteration of a thread handles.
    With ``drop_f64``, less a rare arm that holds float64 work (such as the
    photometric kernel's direct expression): the region that the innermost
    forward branch over all the loop's float64 instructions skips, else the
    basic blocks that hold them. What a warp issues a value when every
    branch in the kept blocks is taken by some lane."""
    def f64(op):
        return op[0] == "D" or ".F64" in op

    back = [(a, t) for a, op, t in ins if t is not None and t <= a]
    if not back:
        fail("no loop in the kernel's SASS")
    end, start = max(back, key=lambda p: p[0] - p[1])
    body = [(a, op, t) for a, op, t in ins if start <= a <= end]
    n_loop = len(body)
    wide = [a for a, op, _ in body if f64(op)]
    if drop_f64 and wide:
        over = [(t - a, a, t) for a, op, t in body
                if t is not None and a < min(wide) and t > max(wide)]
        if over:
            _, skip_a, skip_t = min(over)
            body = [(a, op, t) for a, op, t in body
                    if not skip_a < a < skip_t]
    leaders = {start} | {t for _, _, t in ins if t is not None}
    blocks, cur = [], []
    for a, op, t in body:
        if a in leaders and cur:
            blocks.append(cur)
            cur = []
        cur.append(op)
        if op.split(".")[0] in ("BRA", "BRX", "EXIT", "RET"):
            blocks.append(cur)
            cur = []
    if cur:
        blocks.append(cur)

    kept = [op for b in blocks
            if not (drop_f64 and any(f64(op) for op in b)) for op in b]
    fam = {}
    for op in kept:
        fam[op.split(".")[0]] = fam.get(op.split(".")[0], 0) + 1
    n_int = sum(v for k, v in fam.items() if k in SASS_INT)
    n_imad = sum(v for k, v in fam.items() if k in SASS_IMAD)
    return {"values_per_iteration": values,
            "loop_instructions": n_loop,
            "rare_arm_instructions": n_loop - len(kept),
            "per_value": {
                "all": len(kept) / values, "int_alu": n_int / values,
                "imad": n_imad / values,
                "families": {k: v / values for k, v in sorted(
                    fam.items(), key=lambda kv: -kv[1])}}}


def kernel_counters():
    from flowgen_torch.ops import photometric, resample, window
    from flowgen_torch.ops import scene as ps
    from flowgen_torch.warpfields import compose, fields

    return {"scene_render": ps.scene_render,
            "coarse_gdisp": compose.coarse_gdisp_batch,
            "hwarp_rows": compose.hwarp_rows,
            "elementary_field": fields.elementary_field,
            "object_window": window.object_window,
            "polygon_coverage": window.polygon_coverage,
            "affine_resample": resample.affine_resample,
            "photometric": photometric.augment_batch}


FUSED_KERNELS = ("scene_render", "coarse_gdisp", "hwarp_rows",
                 "elementary_field")
WINDOW_KERNELS = ("object_window", "polygon_coverage")


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
        # The program's spans show on the device too, as annotations.
        if ev.device_type != DeviceType.CUDA or ev.is_user_annotation:
            continue
        busy_us += getattr(ev, "self_device_time_total",
                           getattr(ev, "self_cuda_time_total", 0.0))
        n_kernels += ev.count
    return 1e3 * wall, busy_us / 1e3, n_kernels


def cuda_kernels(fn) -> int:
    """CUDA kernels (device activities) torch.profiler counts in one call
    of ``fn``, ended by a synchronize."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(ev.count for ev in prof.key_averages()
               if ev.device_type == DeviceType.CUDA
               and not ev.is_user_annotation)


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


@functools.lru_cache(maxsize=None)
def spin_cycles_per_ms() -> float:
    """Clock cycles a torch.cuda._sleep spin on the card lasts a ms."""
    n = 20_000_000
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda._sleep(n)
    e0.record()
    torch.cuda._sleep(n)
    e1.record()
    torch.cuda.synchronize()
    return n / e0.elapsed_time(e1)


def event_ms(fn, reps: int = 10, cold: bool = False) -> float:
    """Per-call device time of ``fn`` by CUDA events over ``reps`` calls,
    after two warm-up calls. Each reading's calls are queued behind a spin
    on the card (torch.cuda._sleep) that lasts longer than their host
    work, so the events hold device time only; a reading whose host work
    outlasted its spin is taken again with a longer one. Back to back, one
    reading holds the ``reps`` calls; ``cold`` writes a buffer larger than
    the 50 MB L2 before each call and times each call alone, as a caller
    that finds its operands out of L2 sees it."""
    for _ in range(2):
        fn()
    t0 = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    calls, readings = (1, reps) if cold else (reps, 1)
    spin_ms = 1.0 + 2e3 * host_s * calls
    # Freed on return, so it never counts in a later peak-memory reading.
    flush = (torch.empty(L2_FLUSH_BYTES // 4, device="cuda") if cold
             else None)
    total, taken = 0.0, 0
    for _ in range(4 * readings + 4):
        if flush is not None:
            flush.zero_()
        torch.cuda._sleep(int(spin_ms * spin_cycles_per_ms()))
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0 = time.perf_counter()
        e0.record()
        for _ in range(calls):
            fn()
        e1.record()
        enqueue_ms = 1e3 * (time.perf_counter() - t0)
        torch.cuda.synchronize()
        if enqueue_ms >= spin_ms:
            spin_ms = 2.0 * enqueue_ms
            continue
        total += e0.elapsed_time(e1)
        taken += 1
        if taken == readings:
            return total / (readings * calls)
    fail("event_ms: the host's work kept outlasting the spin ahead of it")


def host_ms(fn):
    """Host-clock time of one call of ``fn``, ended by a synchronize."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0), out


def run_main_path(cfg, atlas, card, n_steps=5, prof_steps=3, label=""):
    """Drive ``Generator`` with every kernel count at 0 before: 2 warm-up
    and ``n_steps`` timed steps, then ``prof_steps`` profiled ones. Returns
    the first batch and the numbers. ``label`` names the run's texture
    bank or stage in the lines it prints."""
    from flowgen_torch.pipeline.generator import Generator, use_fused_path

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated() / 2**30
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
        "launches_per_step": {k: v / dispatched for k, v in counts.items()},
        "ms_per_step": 1e3 * dt / n_steps,
        "samples_per_s": cfg.batch_size * n_steps / dt,
        "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
        "held_gib": held,
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
        if not bool((torch.isfinite(im) & (im >= 0) & (im <= 255)).all()):
            fail("image values outside [0, 255]")
        if not cfg.photometric_augment and not bool((im == im.round()).all()):
            fail("images are not integer values")
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
    if counts["affine_resample"]:
        fail("a main path launched the standalone affine_resample")
    if counts["photometric"] != (dispatched if cfg.photometric_augment
                                 else 0):
        fail(f"photometric launches {counts['photometric']} for "
             f"{dispatched} steps dispatched")
    if use_fused_path(cfg, "cuda"):
        if counts["scene_render"] != dispatched:
            fail(f"scene kernel launches {counts['scene_render']} != steps "
                 f"dispatched {dispatched}")
        if any(counts[k] for k in WINDOW_KERNELS):
            fail(f"the fused path launched window kernels: {counts}")
    elif counts["scene_render"] or not counts["object_window"]:
        fail(f"the windowed path's kernel launches are off: {counts}")
    label = f"mode {cfg.mode}, B={B}, {W}x{H}{label}"
    print(f"main path ({label}): {res['ms_per_step']:.2f} ms/step, "
          f"{res['samples_per_s']:.1f} samples/s over {n_steps} timed steps, "
          f"peak memory {res['peak_gib']:.2f} GiB ({held:.2f} held at the "
          f"start), kernel launches "
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


def phase_scene_timing(label, args, opts, card):
    """Phases 4, 8, 11 and 17: the scene kernel on step 0's B=64 tables.
    The main path's launch by CUDA events, and the background pass alone
    (``bg_only``) beside it: the difference is the object loop. Then the
    launch with inverse flow and id images against the plain version, bit
    for bit (frames, all four flow planes, ids; the sign of a zero aside),
    and the main path's launch against it (its frames and forward flow).
    Returns the kernel's numbers with the plain version's time (of the
    launch with inverse flow and ids) and the bound of the main path's."""
    from flowgen_torch.ops import scene as ps

    k_ms = event_ms(lambda: ps.scene_render(*args, **opts))
    bg_ms = event_ms(lambda: ps.scene_render(*args, **{**opts, "bg_only": True}))
    kf, kl, _ = ps.scene_render(*args, **opts)
    full = {**opts, "inverse_flow": True, "emit_masks": True}
    k_full = ps.scene_render(*args, **full)
    p_ms, p_full = host_ms(lambda: ps.scene_render_plain(*args, **full))
    bits = (int((k_full[0] != p_full[0]).sum())
            + bits_differ(k_full[1], p_full[1])
            + int((k_full[2] != p_full[2]).sum())
            + int((kf != k_full[0]).sum())
            + bits_differ(kl, k_full[1][:, :kl.shape[1]]))
    err = max(float((k_full[1] - p_full[1]).abs().max()),
              float((unpack(k_full[0]) - unpack(p_full[0])).abs().max()))
    bd = bound(args, opts)
    print(f"{label} scene kernel (B=64): {k_ms:.4f} ms per launch (CUDA "
          f"events, 10 launches), of which the background pass (bg_only) "
          f"{bg_ms:.4f} ms and the object loop {k_ms - bg_ms:.4f} ms; plain "
          f"version {p_ms:.1f} ms (with inverse flow and ids); bound "
          f"{bd['bound_ms']:.4f} ms by {bd['bound_by']} ({bd['bytes']:.4e} "
          f"bytes, {bd['operations']:.4e} float ops) [{card}]")
    print(f"{label} kernel vs plain (B=64, inverse flow and ids): max |d| "
          f"{err}, {bits} values with other bits (frames, 4 flow planes, "
          f"ids, and the main path's launch against it)")
    if bits or err != 0.0:
        fail(f"{label} scene kernel differs from its plain version at B=64")
    return {"ms": k_ms, "bg_only_ms": bg_ms, "plain_ms": p_ms,
            "bound_ms": bd["bound_ms"], "bound_by": bd["bound_by"],
            "max_abs_err": err}


def phase_mode7(card, dev):
    import flowgen_torch
    from flowgen_torch.ops import scene as ps
    from flowgen_torch.pipeline.generator import make_slab_packer

    cfg4 = flowgen_torch.DataGenConfig(mode=7, batch_size=4, seed=0)
    atlas = procedural_atlas(cfg4.height, cfg4.width)
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
    t = phase_scene_timing("mode 7", args, opts, card)
    return {"launches": res["launches"]["scene_render"], **t,
            "max_abs_err": max(cmp["max_abs_err"], g["max_abs_err"],
                               t["max_abs_err"]),
            "ms_per_step": res["ms_per_step"],
            "samples_per_s": res["samples_per_s"]}


def one_doubling(f):
    """The lookup half of one composition doubling of (M, 2, S, S) fields:
    the column-inverse solve, then the two-pass warp of both channels."""
    from flowgen_torch.warpfields import compose

    gd = compose.coarse_gdisp_batch(f.permute(0, 2, 3, 1))
    return gd, compose.displace_planes_batch(f, gd, f[:, 1])


def bank_doubling_inputs(cfg, dev):
    """The big fields of bank epoch 0 as the 16th half-lattice doubling and
    the full-size doubling find them, on the kernel path's own states:
    (M, 2, S/2, S/2) and (M, 2, S, S) planes."""
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
    f15 = torch.nan_to_num(compose.self_compose_batch(f_h, 15))
    f16 = compose.self_compose_batch(f15, 1)
    return f15, 2.0 * fields._upsample2(torch.nan_to_num(f16))


def phase_bank(cfg, dev):
    """Phase 5. Returns the fields the timing phase reuses and the kernel
    bank and aux of epoch 0."""
    from flowgen_torch.random.streams import root_key
    from flowgen_torch.warpfields import compose
    from flowgen_torch.warpfields import generator as wg

    root = root_key(cfg.seed, dev)
    f15, full = bank_doubling_inputs(cfg, dev)
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


def grid_sample_call(planes, disp):
    """torch.nn.functional.grid_sample (bilinear, border padding,
    align_corners=True) computing the same clamped row lerp as hwarp_rows on
    the same planes."""
    M, C, R, Sp = planes.shape
    xs = torch.arange(Sp, dtype=torch.float32, device=planes.device)
    ys = torch.arange(R, dtype=torch.float32, device=planes.device)
    gx = (xs + disp) * (2.0 / (Sp - 1)) - 1.0
    gy = (ys[:, None] * (2.0 / (R - 1)) - 1.0).expand(M, R, Sp)
    grid = torch.stack([gx, gy], dim=-1)
    return lambda: torch.nn.functional.grid_sample(
        planes, grid, mode="bilinear", padding_mode="border", align_corners=True)


def hwarp_bytes(planes, disp):
    """Every plane element read once and written once; the C channels of a
    field share one displacement row, read once."""
    return 4.0 * (2 * planes.numel() + disp.numel())


def epoch_hwarp(cfg, dev, card):
    """Every hwarp_rows launch of one bank epoch of the mode-9 path
    (make_bank_and_aux at the configuration's size), each against its plain
    version on the same inputs (max difference 0 expected) and each timed
    alone with a cold L2 beside grid_sample on the same planes; the summed
    ms and bound."""
    from flowgen_torch.random.streams import root_key
    from flowgen_torch.warpfields import compose
    from flowgen_torch.warpfields import generator as wg

    calls, restore = record_launches(compose, "hwarp_rows")
    try:
        wg.make_bank_and_aux(root_key(cfg.seed, dev), 0, cfg)
    finally:
        restore()
    res = {"launches": len(calls), "ms": 0.0, "library_ms": 0.0,
           "bound_ms": 0.0, "max_abs_err": 0.0, "shapes": {}}
    for (planes, disp), _ in calls:
        k = compose.hwarp_rows(planes, disp)
        with compose.plain_versions():
            p = compose.hwarp_rows(planes, disp)
        res["max_abs_err"] = max(res["max_abs_err"],
                                 float((k - p).abs().max()))
        del k, p
        res["ms"] += event_ms(lambda: compose.hwarp_rows(planes, disp),
                              reps=3, cold=True)
        res["library_ms"] += event_ms(grid_sample_call(planes, disp), reps=3,
                                      cold=True)
        res["bound_ms"] += 1e3 * hwarp_bytes(planes, disp) / PEAK_BYTES_S
        shape = "x".join(map(str, planes.shape))
        res["shapes"][shape] = res["shapes"].get(shape, 0) + 1
    print(f"hwarp_rows over one bank epoch ({cfg.width}x{cfg.height}, "
          f"launches by shape {json.dumps(res['shapes'])}): "
          f"{res['launches']} launches, each against its plain version (max "
          f"|d| {res['max_abs_err']}); {res['ms']:.4f} ms summed (CUDA events, "
          f"each launch alone with a cold L2, mean of 3), grid_sample "
          f"{res['library_ms']:.4f} ms summed, bound {res['bound_ms']:.4f} ms "
          f"summed by bytes [{card}]")
    if res["max_abs_err"] != 0.0 or res["launches"] != 34:
        fail("hwarp_rows over a bank epoch: launches or values are off")
    return res


def coarse_bytes(D, stride: int = 4):
    """coarse_gdisp_batch's bytes bound: the coarse subsample of both
    channels (every ``stride``-th row and column) read once, the full-size
    plane written once."""
    N, Hd, Wd, _ = D.shape
    return 4.0 * (2 * N * (Hd // stride) * (Wd // stride) + N * Hd * Wd)


def bits_unequal(a, b) -> int:
    """Values of two float32 tensors whose bits differ (NaN and the sign of
    a zero included)."""
    return int((a.contiguous().view(torch.int32)
                != b.contiguous().view(torch.int32)).sum())


def coarse_whole(D):
    """coarse_gdisp_batch on D as a whole (its two kernels): CUDA events
    back to back and with a cold L2, the plain version once (host clock),
    the bytes bound, and the difference from the plain version."""
    from flowgen_torch.warpfields import compose

    whole = lambda: compose.coarse_gdisp_batch(D)
    res = {"ms": event_ms(whole), "ms_cold": event_ms(whole, reps=3, cold=True)}
    gd = whole()
    with compose.plain_versions():
        res["plain_ms"], cp = host_ms(whole)
    res.update(bound_ms=1e3 * coarse_bytes(D) / PEAK_BYTES_S,
               max_abs_err=float((gd - cp).abs().max()),
               bits_differ=bits_unequal(gd, cp))
    return res


def phase_bank_timing(fields_by_size, card):
    """Phase 8, bank kernels on 8 fields: coarse_gdisp_batch as a whole
    (its two kernels) at 768^2, 1536^2 and 3072^2, back to back and with a
    cold L2, against its plain version bit for bit; hwarp_rows and
    grid_sample on the same planes at 768^2 and 1536^2."""
    from flowgen_torch.warpfields import compose

    rows = {}
    for size, f in fields_by_size:
        M, C, S, _ = f.shape
        D = f.permute(0, 2, 3, 1)
        rc = rows.setdefault(size, {})["coarse"] = coarse_whole(D)
        print(f"coarse_gdisp_batch on {M} fields of {S}^2: {rc['ms']:.4f} ms "
              f"back to back, {rc['ms_cold']:.4f} ms with a cold L2 (CUDA "
              f"events; plain {rc['plain_ms']:.1f} ms; bound "
              f"{rc['bound_ms']:.4f} ms by bytes); max |d| vs plain "
              f"{rc['max_abs_err']}, {rc['bits_differ']} values with other "
              f"bits [{card}]")
        if rc["max_abs_err"] != 0.0 or rc["bits_differ"]:
            fail(f"coarse_gdisp_batch differs from its plain version at {S}^2")
        if S > 1536:
            continue
        gd = compose.coarse_gdisp_batch(D)
        disp = gd.contiguous()
        planes = f.contiguous()
        call = lambda: compose.hwarp_rows(planes, disp)
        h_ms, h_cold = event_ms(call), event_ms(call, cold=True)
        with compose.plain_versions():
            hp_ms, hp = host_ms(call)
        hk = call()
        gs = grid_sample_call(planes, disp)
        lib_ms, lib_cold = event_ms(gs), event_ms(gs, cold=True)
        rh = rows[size]["hwarp"] = {
            "ms": h_ms, "ms_cold": h_cold, "plain_ms": hp_ms,
            "library_ms": lib_ms, "library_ms_cold": lib_cold,
            "bound_ms": 1e3 * hwarp_bytes(planes, disp) / PEAK_BYTES_S,
            "max_abs_err": float((hk - hp).abs().max()),
            "grid_sample_max_diff": float((gs() - hk).abs().max())}
        print(f"hwarp_rows on {M * C * S} x {S} rows: {h_ms:.4f} ms, "
              f"{h_cold:.4f} ms with a cold L2 (plain {hp_ms:.1f} ms, "
              f"grid_sample {lib_ms:.4f} ms, {lib_cold:.4f} ms cold, bound "
              f"{rh['bound_ms']:.4f} ms by bytes, grid_sample max |d| "
              f"{rh['grid_sample_max_diff']:.2e}); max |d| vs plain "
              f"{rh['max_abs_err']} [{card}]")
        if rh["max_abs_err"] != 0.0:
            fail(f"hwarp_rows differs from its plain version at {S}^2")
    return rows


def epoch_coarse(cfg, dev):
    """Every coarse_gdisp_batch call of one bank epoch of the mode-9 path
    (make_bank_and_aux at the configuration's size), each against its plain
    version bit for bit and timed alone with a cold L2, summed with its
    bound."""
    from flowgen_torch.random.streams import root_key
    from flowgen_torch.warpfields import compose
    from flowgen_torch.warpfields import generator as wg

    calls, restore = record_launches(compose, "coarse_gdisp_batch")
    try:
        wg.make_bank_and_aux(root_key(cfg.seed, dev), 0, cfg)
    finally:
        restore()
    res = {"calls": len(calls), "ms": 0.0, "bound_ms": 0.0,
           "max_abs_err": 0.0, "bits_differ": 0, "shapes": {}}
    for args, kw in calls:
        D = args[0]
        call = functools.partial(compose.coarse_gdisp_batch, *args, **kw)
        k = call()
        with compose.plain_versions():
            p = call()
        res["max_abs_err"] = max(res["max_abs_err"], float((k - p).abs().max()))
        res["bits_differ"] += bits_unequal(k, p)
        del k, p
        res["ms"] += event_ms(call, reps=3, cold=True)
        res["bound_ms"] += 1e3 * coarse_bytes(D) / PEAK_BYTES_S
        shape = "x".join(map(str, D.shape))
        res["shapes"][shape] = res["shapes"].get(shape, 0) + 1
    return res


def coarse_kernel_counts(cfg, dev):
    """torch.profiler's count of CUDA kernels in one coarse_gdisp_batch call
    (the first of a bank epoch) and in one whole bank epoch
    (make_bank_and_aux at the configuration's size). The profiler counts
    the ctypes kernels reliably only in a process's first sessions, so
    main() runs this in a process of its own (--coarse-kernel-counts)."""
    from flowgen_torch.random.streams import root_key
    from flowgen_torch.warpfields import compose
    from flowgen_torch.warpfields import generator as wg

    root = root_key(cfg.seed, dev)
    calls, restore = record_launches(compose, "coarse_gdisp_batch")
    try:
        wg.make_bank_and_aux(root, 0, cfg)     # and the warm-up
    finally:
        restore()
    D0 = calls[0][0][0]
    del calls
    return {"per_call": cuda_kernels(lambda: compose.coarse_gdisp_batch(D0)),
            "epoch": cuda_kernels(lambda: wg.make_bank_and_aux(root, 0, cfg))}


def phase_coarse_epoch(cfg, dev, card):
    """Phase 8, end: epoch_coarse, and coarse_kernel_counts from a fresh
    process of this script."""
    res = epoch_coarse(cfg, dev)
    r = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--coarse-kernel-counts"],
        capture_output=True, text=True, timeout=600, cwd=HERE)
    if r.returncode != 0:
        fail(f"the kernel count's process failed:\n{r.stdout[-2000:]}"
             f"{r.stderr[-4000:]}")
    counts = json.loads(r.stdout.strip().splitlines()[-1])
    res["cuda_kernels_per_call"] = counts["per_call"]
    res["cuda_kernels_epoch"] = counts["epoch"]
    print(f"coarse_gdisp_batch over one bank epoch ({cfg.width}x{cfg.height}, "
          f"calls by shape {json.dumps(res['shapes'])}): {res['calls']} calls, "
          f"each against its plain version (max |d| {res['max_abs_err']}, "
          f"{res['bits_differ']} values with other bits); {res['ms']:.4f} ms "
          f"summed (CUDA events, each call alone with a cold L2, mean of 3), "
          f"bound {res['bound_ms']:.4f} ms summed by bytes; CUDA kernels "
          f"(torch.profiler, in a fresh process): {counts['per_call']} in a "
          f"call, {counts['epoch']} in the epoch [{card}]")
    if res["max_abs_err"] != 0.0 or res["bits_differ"] or res["calls"] != 18:
        fail("coarse_gdisp_batch over a bank epoch: calls or values are off")
    if counts["per_call"] != 2:
        fail(f"coarse_gdisp_batch ran {counts['per_call']} CUDA kernels in a "
             "call, not its 2 (torch.profiler)")
    return res


# Operations a (pixel, displacer) pair of csrc/fields.cu:elementary_field_kernel
# by the displacer's motion kind (translation, rotation, zoom): the support's
# rotated Gaussian argument (13) and its det_exp (26, three of them integer),
# the weighted sums (4), and the motion (0, 10, 4). None fuses (-fmad=false).
OPS_FIELD_PAIR = (43, 53, 47)
# Float32 add or multiply instructions an H100 issues a second: 128 lanes an
# SM at 1.98 GHz (half the FMA-counted 67 TFLOP/s).
PEAK_F32_ISSUE_S = 132 * 128 * 1.98e9


def elementary_field_inputs(big: int, n_fields: int, dev):
    """The displacer grids of ``n_fields`` big fields of ``big``^2, each
    with its flow and inverse flow, stacked as a bank epoch stacks them."""
    from flowgen_torch.random.streams import Stream, root_key, stream_key
    from flowgen_torch.warpfields import fields

    grids, flags = [], []
    for i in range(n_fields):
        g = fields.sample_displacer_grid(
            stream_key(root_key(0, dev), Stream.WARP_FIELD, i), big)
        grids += [g, g]
        flags += [False, True]
    return fields.stack_grids(grids, flags)


def elementary_field_bound(grid, size: int):
    """Least time of one call at the fp32 issue rate: OPS_FIELD_PAIR of each
    displacer's kind over every lattice pixel."""
    ops = sum(OPS_FIELD_PAIR[int(k)] * n for k, n in zip(
        *torch.unique(grid.kind.cpu(), return_counts=True))) * size * size
    return {"operations": float(ops),
            "bound_ms": 1e3 * float(ops) / PEAK_F32_ISSUE_S}


def elementary_field_sass(pixels: int):
    """Registers of elementary_field_kernel (ptxas) and its displacer loop in
    the SASS, a (pixel, displacer) pair: the backward branch holding the
    most FMUL, the narrowest such, over the ``pixels`` pixels of a thread.
    The three motion arms are all counted; a block takes one."""
    from flowgen_torch.ops import _build

    info = _build.BUILD_INFO["flowgen_fields"]
    regs = {n: r for n, r in ptxas_registers(info["log"]).items()
            if "elementary_field_kernel" in n}
    funcs = {n: ins for n, ins in sass_functions(info["path"]).items()
             if "elementary_field_kernel" in n}
    if len(funcs) != 1 or len(regs) != 1:
        fail(f"elementary_field_kernel is not once in the library: "
             f"{list(funcs)}, {list(regs)}")
    ins = next(iter(funcs.values()))

    def body(t, a):
        return [op for b, op, _ in ins if t <= b <= a]

    loops = [(t, a) for a, op, t in ins
             if op.split(".")[0] == "BRA" and t is not None and t <= a]
    t, a = max(loops, key=lambda ta: (
        sum(op.startswith("FMUL") for op in body(*ta)), ta[0] - ta[1]))
    ops = body(t, a)
    fam = {}
    for op in ops:
        k = op.split(".")[0]
        fam[k] = fam.get(k, 0) + 1
    return {"registers": next(iter(regs.values())),
            "loop_instructions": len(ops), "per_pair": len(ops) / pixels,
            "families": {k: v / pixels for k, v in sorted(
                fam.items(), key=lambda kv: -kv[1])}}


def phase_elementary_field(card, dev):
    """Phase 25: elementary_field_kernel at the bank's shape (2 big fields
    of 1536^2 with their inverses: M = 4 directions on the 768^2 half
    lattice, 63 displacers, the chairs cells' epoch) and Sintel's (2 of
    3072^2: 1536^2, 270 displacers): the kernel against its plain version
    bit for bit, its time by CUDA events (alone, on packed constants, and
    the whole call with the constants' derivation), the plain version once
    by host clock, the fp32-issue bound, registers and the SASS of its
    displacer loop. Returns the kernel's row."""
    from flowgen_torch.warpfields import fields

    facts = elementary_field_sass(4)
    shapes = {}
    for label, big in (("bank", 1536), ("sintel", 3072)):
        grid, inv = elementary_field_inputs(big, 2, dev)
        S = big // 2
        consts = fields._packed_constants(grid, inv)
        n0 = fields.elementary_field.launches
        got = fields.elementary_field(grid, S, inv, stride=2.0)
        torch.cuda.synchronize()
        if fields.elementary_field.launches != n0 + 1:
            fail("elementary_field did not launch its kernel once")
        p_ms, want = host_ms(
            lambda: fields.elementary_field_plain(grid, S, inv, stride=2.0))
        bits = bits_unequal(got, want)
        err = float((got - want).abs().max())
        del want
        k_ms = event_ms(lambda: fields.elementary_field_cuda(consts, S, 2.0))
        # Two calls a reading: the constants' ~150 small launches a call
        # would fill the launch queue behind the spin at ten.
        w_ms = event_ms(lambda: fields.elementary_field(grid, S, inv, 2.0),
                        reps=2)
        bd = elementary_field_bound(grid, S)
        M, N = grid.kind.shape
        shapes[label] = {"M": M, "N": N, "size": S, "ms": k_ms,
                         "call_ms": w_ms, "plain_ms": p_ms,
                         "bits_differ": bits, "max_abs_err": err, **bd}
        print(f"elementary_field_kernel ({label}: M={M} directions, {N} "
              f"displacers, {S}^2 lattice at stride 2): {k_ms:.4f} ms a "
              f"launch (CUDA events, 10 launches), the whole call with its "
              f"constants {w_ms:.4f} ms; plain version {p_ms:.1f} ms (host "
              f"clock, once); bound {bd['bound_ms']:.4f} ms by fp32 issue "
              f"({bd['operations']:.4e} operations), {bd['bound_ms'] / k_ms:.1%}"
              f" of it; vs plain: max |d| {err}, {bits} values with other "
              f"bits [{card}]")
        if bits:
            fail(f"elementary_field_kernel differs from its plain version "
                 f"({label})")
        if k_ms < bd["bound_ms"]:
            fail(f"elementary_field_kernel ({k_ms:.4f} ms) beats its bound "
                 f"({bd['bound_ms']:.4f} ms): OPS_FIELD_PAIR is wrong")
        del grid, inv, consts, got
    print(f"elementary_field_kernel: {facts['registers']} registers; its "
          f"displacer loop {facts['loop_instructions']} SASS instructions "
          f"for 4 pixels, {facts['per_pair']:.2f} a (pixel, displacer) pair "
          f"with all three motion arms, by family "
          + json.dumps({k: round(v, 2) for k, v in facts["families"].items()}))
    b = shapes["bank"]
    return {
        "name": "elementary_field", "route": "cuda",
        "source": "flowgen_torch/csrc/fields.cu",
        "replaces": None, "max_abs_err": max(s["max_abs_err"]
                                             for s in shapes.values()),
        "ms": b["ms"], "plain_ms": b["plain_ms"], "bound_ms": b["bound_ms"],
        "bound_by": "operations (fp32 issue)", "library_ms": None,
        "library": "no single PyTorch call computes it",
        "shape": "M=4 directions (2 big fields of 1536^2 and their "
                 "inverses), 63 displacers, 768^2 at stride 2",
        "replaces_note": "XLA in the JAX package (no pallas_call): the "
                         "fori_loop of warpfields/fields.py:elementary_field",
        "sintel": shapes["sintel"], "sass": facts,
    }


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
        slabs = make_slab_packer(cfg4, dev)(procedural_atlas(cfg4.height,
                                                             cfg4.width))
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

    plain4, worst, slabs = phase_quadrant(card, dev)
    cfg = flowgen_torch.DataGenConfig(mode=13, batch_size=64, seed=0,
                                      compute_inverse_flow=True,
                                      emit_masks=True)
    atlas = procedural_atlas(cfg.height, cfg.width)

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
    t = phase_scene_timing("mode 13", args, opts, card)
    return {"launches": res["launches"]["scene_render"], **t,
            "max_abs_err": max(worst, g["max_abs_err"], t["max_abs_err"]),
            "peak_gib": res["peak_gib"], "held_gib": res["held_gib"]}


# ---------------------------------------------------------------------------
# The windowed renderer (phases 12-15)
# ---------------------------------------------------------------------------

SINTEL_HW = (436, 1024)   # MPI-Sintel's frame (height, width)
# Bytes a sample point moves through polygon_coverage: its two coordinates
# read (4 each), its coverage (4) and its uint8 mask (1) written.
POLYGON_POINT_BYTES = 13


def sintel_cfg(**kw):
    import flowgen_torch

    H, W = SINTEL_HW
    return flowgen_torch.DataGenConfig(**{"batch_size": 64, "height": H,
                                          "width": W, "seed": 0, **kw})


def as_windowed(out, cfg):
    """The windowed renderer's (image0, image1, flow0[, flow1][, ids]) as a
    dict of the main path's outputs, ids and masks included."""
    from flowgen_torch.compose.fused import masks_from_ids

    out = list(out)
    d = {"image0": out[0], "image1": out[1], "flow0": out[2]}
    if cfg.compute_inverse_flow:
        d["flow1"] = out[3]
    if cfg.emit_masks:
        d["ids"] = out[-1]
        d["occlusion"], d["motion_boundary"] = masks_from_ids(
            out[-1], out[2][..., 0], out[2][..., 1])
    return d


def windowed_samples(cfg, dev, n=4):
    """Scenes of ``n`` consecutive samples of the main path's step 0; in
    mode 9 the first four that hold a deforming object and a deforming
    background. Returns (first index, scenes)."""
    from flowgen_torch.warpfields import generator as wg

    warp = cfg.mode_spec.warp_p > 0.0
    n_slots = wg.bank_size(cfg) if warp else 1
    for s in range(0, cfg.batch_size, n):
        scenes = sample(cfg, cfg.seed, s + torch.arange(n), dev, n_slots)
        if not warp or (
                int((scenes.objects.warp & scenes.objects.valid).sum()) >= 1
                and int(scenes.background.warp.sum()) >= 1):
            return s, scenes
    fail("no samples of step 0 hold a deforming object and background")


def phase_sintel_bank(cfg, dev):
    """Phase 12a: the crop bank of the mode-9 Sintel configuration (3072^2
    big fields) through the bank kernels against the same through their
    plain versions. Returns the kernels' bank and the largest difference."""
    from flowgen_torch.random.streams import root_key
    from flowgen_torch.warpfields import compose
    from flowgen_torch.warpfields import generator as wg

    root = root_key(cfg.seed, dev)
    ms_k, bk = host_ms(lambda: wg.make_warp_bank(root, 0, cfg))
    with compose.plain_versions():
        ms_p, bp = host_ms(lambda: wg.make_warp_bank(root, 0, cfg))
    res = {name: field_gate(a, b) for name, a, b in (
        ("flow", bk.flow, bp.flow), ("iflow", bk.iflow, bp.iflow))}
    worst = max(r["max_abs_err"] for r in res.values())
    big = wg.big_field_size(cfg.width, cfg.height)
    print(f"make_warp_bank kernels vs plain ({cfg.width}x{cfg.height}, "
          f"{cfg.warp_fields_per_batch} big fields of {big}^2, "
          f"{wg.bank_size(cfg)} crops): " + json.dumps(res, sort_keys=True)
          + f"; kernels {ms_k:.1f} ms, plain versions {ms_p:.1f} ms (host "
          "clock, synchronized)")
    if not all(r["ok"] for r in res.values()):
        fail("the Sintel-size bank through the kernels fails the bank gate")
    del bp
    return bk, worst


def phase_windowed_vs_plain(atlas_q, bank9, dev):
    """Phase 12b: the windowed renderer at 1024x436, B=4, through the
    window kernels against the same through their plain versions (mode 7;
    mode 7 with flow1 and masks; mode 9 on samples with a deforming object
    and background). Returns the plain renders and the worst difference."""
    import dataclasses

    from flowgen_torch.compose.render import render_batch
    from flowgen_torch.ops import window

    plains, worst = {}, 0.0
    for label, kw in (("mode 7", dict(mode=7)),
                      ("mode 7 with flow1 and masks",
                       dict(mode=7, compute_inverse_flow=True,
                            emit_masks=True)),
                      ("mode 9", dict(mode=9))):
        cfg = sintel_cfg(**kw)
        cfg4 = dataclasses.replace(cfg, batch_size=4)
        bank = bank9 if cfg.mode == 9 else None
        s0, scenes = windowed_samples(cfg, dev)
        before = {k: fn.launches for k, fn in kernel_counters().items()}
        k_out = as_windowed(render_batch(scenes, atlas_q, cfg4, bank), cfg4)
        torch.cuda.synchronize()
        launched = {k: fn.launches - before[k]
                    for k, fn in kernel_counters().items()}
        with window.plain_versions():
            p_out = as_windowed(render_batch(scenes, atlas_q, cfg4, bank), cfg4)
        cmp = gates(k_out, p_out)
        print(f"windowed {label} kernels vs plain (samples {s0}-{s0 + 3}, "
              f"{cfg.width}x{cfg.height}, launches {json.dumps(launched)}): "
              + json.dumps(cmp, sort_keys=True))
        if not cmp["ok"]:
            fail(f"windowed {label}: kernels vs plain gates failed")
        if not launched["object_window"] and not launched["polygon_coverage"]:
            fail(f"windowed {label}: no window kernel launched")
        worst = max(worst, cmp["max_abs_err"])
        plains[label] = (s0, p_out)
    return plains, worst


def phase_windowed_invariants(dev):
    """Phase 12c, at 512x384, B=4, mode 7 with inverse flow: per-object
    windows against full-frame windows (bit for bit), and the forward flow
    of the windowed renderer against the scene kernel's (bit for bit)."""
    import dataclasses

    import flowgen_torch
    from flowgen_torch.pipeline.generator import generate_batch

    atlas = flowgen_torch.procedural_atlas(4, height=384, width=512)
    cfg = flowgen_torch.DataGenConfig(mode=7, batch_size=4, seed=0,
                                      render_impl="windowed",
                                      compute_inverse_flow=True)
    win = generate_batch(0, 0, atlas, cfg, device="cuda")
    full = generate_batch(0, 0, atlas, dataclasses.replace(cfg, windowed=False),
                          device="cuda")
    fused = generate_batch(0, 0, atlas,
                           dataclasses.replace(cfg, render_impl="fused"),
                           device="cuda")
    diff = {k: float((win[k] - full[k]).abs().max()) for k in win}
    d0 = float((win["flow0"] - fused["flow0"]).abs().max())
    print("windowed vs full-frame windows (mode 7, 512x384, B=4, max |d| per "
          f"output): {json.dumps(diff)}; windowed vs fused flow0 max |d| {d0}")
    if any(diff.values()) or d0 != 0.0:
        fail("windowed evaluation is not invariant")


def layer_breakdown_windowed(cfg, atlas_q, dev, steps: int = 3):
    """Host-clock time of each layer of one windowed main-path step, each
    ended by a device synchronize, averaged over ``steps`` steps: bank
    producer (mode 9: each epoch's make_warp_bank, per step), sampler,
    background pass, object loop (render_batch less a background_pass of
    the same scenes), masks and output adapter."""
    from flowgen_torch.compose.fused import masks_from_ids
    from flowgen_torch.compose.render import background_pass, render_batch
    from flowgen_torch.pipeline.generator import _adapt_output
    from flowgen_torch.random.streams import root_key
    from flowgen_torch.warpfields import generator as wg

    warp = cfg.mode_spec.warp_p > 0.0
    acc = {"bank_producer": 0.0} if warp else {}
    acc.update({"sampler": 0.0, "background_pass": 0.0, "object_loop": 0.0})
    if cfg.emit_masks:
        acc["masks"] = 0.0
    acc["adapt"] = 0.0
    root = root_key(cfg.seed, dev)
    n_slots = wg.bank_size(cfg) if warp else 1
    reuse = max(cfg.warp_bank_reuse_steps, 1)

    def tick(t0):
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    bank = None
    for step in range(steps):
        torch.cuda.synchronize()
        if warp:
            t0 = time.perf_counter()
            bank = wg.make_warp_bank(root, step * reuse, cfg)
            acc["bank_producer"] += tick(t0) / reuse
        t0 = time.perf_counter()
        idx = step * cfg.batch_size + torch.arange(cfg.batch_size, device=dev)
        scenes = sample(cfg, cfg.seed, idx, dev, n_slots)
        acc["sampler"] += tick(t0)
        t0 = time.perf_counter()
        background_pass(scenes, atlas_q, cfg, bank)
        t_bg = tick(t0)
        acc["background_pass"] += t_bg
        t0 = time.perf_counter()
        out = list(render_batch(scenes, atlas_q, cfg, bank))
        acc["object_loop"] += tick(t0) - t_bg
        masks = None
        if cfg.emit_masks:
            t0 = time.perf_counter()
            masks = masks_from_ids(out.pop(), out[2][..., 0], out[2][..., 1])
            acc["masks"] += tick(t0)
        t0 = time.perf_counter()
        _adapt_output(out[0], out[1], out[2],
                      out[3] if cfg.compute_inverse_flow else None, cfg, masks)
        acc["adapt"] += tick(t0)
    return {k: 1e3 * v / steps for k, v in acc.items()}


def phase_windowed_main(cfg, atlas, atlas_q, plain, card, dev, n_steps=5,
                        prof_steps=3):
    """Phases 13 and 14: the windowed main path at 1024x436, B=64, its
    checks against the plain render of phase 12 and its layers."""
    first, res = run_main_path(cfg, atlas, card, n_steps, prof_steps)
    s0, p_out = plain
    keys = [k for k in first if k in p_out]
    g = gates({k: first[k][s0 : s0 + 4] for k in keys}, p_out)
    print(f"windowed mode {cfg.mode} main path step 0 vs plain (samples "
          f"{s0}-{s0 + 3}): " + json.dumps(g, sort_keys=True))
    if not g["ok"]:
        fail(f"windowed mode {cfg.mode} main path disagrees with the plain "
             "render")
    del first
    print(f"windowed mode {cfg.mode} launches per step: "
          + json.dumps({k: round(v, 3) for k, v in
                        res["launches_per_step"].items()})
          + "; one device-to-host read of the window plan per step")
    layers = layer_breakdown_windowed(cfg, atlas_q, dev)
    print(f"windowed mode {cfg.mode} layers (ms per step, host clock, "
          "synchronized): " + json.dumps({k: round(v, 3) for k, v in
                                          layers.items()}) + f" [{card}]")
    return res


def record_launches(module, name, keep=None):
    """Wrap ``module.name`` so that each call records its arguments, or
    ``keep(args, kw, launches)`` with the launches the call counted (and no
    tensor) where ``keep`` is given; returns (the record list, a function
    that restores the wrapper)."""
    orig = getattr(module, name)
    calls = []

    def rec(*args, **kw):
        if keep is None:
            calls.append((args, kw))
            return orig(*args, **kw)
        c0 = rec.launches
        out = orig(*args, **kw)
        calls.append(keep(args, kw, rec.launches - c0))
        return out

    # The wrapper counts on the name it is under (an older tree's may not).
    rec.launches = getattr(orig, "launches", 0)
    setattr(module, name, rec)

    def restore():
        orig.launches = rec.launches
        setattr(module, name, orig)

    return calls, restore


def _edge_pairs(ax, ay, bx, by, ylo, xlo):
    """Per edge (arrays (e,)), the (cell row, cell column) pairs of a grid
    of cell lower-left corners ``ylo`` (rows) x ``xlo`` (columns) whose
    term can be non-zero: the cell row meets the edge's y-span and the cell
    is not right of the edge. Returns the pair count per edge."""
    ymin, ymax = np.minimum(ay, by), np.maximum(ay, by)
    # A horizontal edge's term is 0 everywhere.
    rows = ((ylo[None, :] < ymax[:, None])
            & (ylo[None, :] + 1 > ymin[:, None])
            & (ymax > ymin)[:, None]).sum(1)
    cols = (xlo[None, :] < np.maximum(ax, bx)[:, None]).sum(1)
    return rows.astype(np.float64) * cols


def _ellipse_box(inv, rx, ry):
    """Screen centre, half extents and axis ratio of the ellipse whose
    inverse transform (2x3) and radii the window tables hold (float64)."""
    I = np.asarray(inv, np.float64).reshape(2, 3)
    L = np.linalg.inv(I[:, :2])
    centre = -L @ I[:, 2]
    lin = L * np.array([rx, ry])
    half = np.sqrt((lin ** 2).sum(1))
    sv = np.linalg.svd(np.diag([1.0 / rx, 1.0 / ry]) @ I[:, :2],
                       compute_uv=False)
    return centre, half, sv[0] / sv[1]


# Below this blend weight a pixel's frame keeps its value whatever its
# texel: |t - f| m < 255 / 512 < 0.5 for frames and texels in [0, 255].
BLEND_RESIDUE = 2.0 ** -9


def object_window_reach_bytes(args, kw):
    """Bytes one object_window launch's windows must move, counted from
    their coverage (the plain version's, window._window_coverage, on the
    launch's tables; it does not depend on the planes): a pixel whose blend
    weight m is at least BLEND_RESIDUE reads its texel (12 bytes: frame 0's
    three channels lie in a 12-byte quad record that the memory moves
    whole, frame 1's bilinear tap reads one record) and writes its frame
    (12), and reads the frame as well where m < 1 (12; at m = 1 the blend
    is the texel); with emit_flow a pixel inside the binary mask writes its
    flow (8; the old flow is multiplied by 0). Every other pixel keeps its
    values (the frames hold whole values in [0, 255]) and moves nothing.
    Returns the bytes and the pixels with 0 < m < BLEND_RESIDUE (a rounding
    residue of the exact-area sums, which the kernel reads and writes)."""
    from flowgen_torch.ops import window

    edges, meta, fmeta, win = args[:4]
    sizes = win[:, window.WIN_H:window.WIN_W + 1].cpu()
    nbytes = residue = 0.0
    for wh, ww in sorted({tuple(map(int, sz)) for sz in sizes}):
        sel = ((sizes[:, 0] == wh) & (sizes[:, 1] == ww)).nonzero()[:, 0]
        sel = sel.to(win.device)
        e, m, f = (t.index_select(0, sel) for t in (edges, meta, fmeta))
        px, py = window.window_grids(m[:, 2], m[:, 1], wh, ww)
        acc_aa, acc_in = window._window_coverage(e, m, f, px, py)
        inside = acc_in != 0
        blend = acc_aa if kw["use_aa"] else inside.to(torch.float32)
        hit = blend >= BLEND_RESIDUE
        nbytes += 24.0 * float(hit.sum()) + 12.0 * float((hit & (blend < 1))
                                                         .sum())
        if kw["emit_flow"]:
            nbytes += 8.0 * float(inside.sum())
        residue += float(((blend != 0) & ~hit).sum())
        del acc_aa, acc_in, inside, blend, hit
    return nbytes, residue


def object_window_work(args, kw):
    """Bytes and float operations that one object_window launch's windows
    need, whatever evaluates them, and the residue pixels of
    object_window_reach_bytes: the bytes of object_window_reach_bytes;
    45 operations per (edge, pixel) pair whose cell row meets the edge's
    y-span and whose cell is not right of the edge (every other term is
    exactly 0); 190 per ellipse pixel within its extent +- ELL_CULL_M in
    rows and columns (a needle, more than ELL_CULL_ANISO times longer than
    wide, over its whole window)."""
    from flowgen_torch.ops.scene import ELL_CULL_M
    from flowgen_torch.ops.window import ELL_CULL_ANISO

    edges, meta, fmeta, win = (t.cpu().numpy() for t in args[:4])
    C = (meta.shape[1] - 3) // 3
    E = edges.shape[-1] // C
    ops = 0.0
    for i in range(len(meta)):
        n_prims, x0, y0 = (int(v) for v in meta[i, :3])
        wh, ww = int(win[i, 1]), int(win[i, 2])
        ylo = np.arange(wh, dtype=np.float64) + y0
        xlo = np.arange(ww, dtype=np.float64) + x0
        for c in range(min(n_prims, C)):
            if meta[i, 3 + C + c]:
                ne = int(meta[i, 3 + 2 * C + c])
                ax, ay, bx, by = (edges[i, k, c * E:c * E + ne].astype(
                    np.float64) for k in range(4))
                ops += OPS_EDGE_PIXEL * _edge_pairs(ax, ay, bx, by, ylo,
                                                    xlo).sum()
                continue
            f = fmeta[i, 6 + 8 * c:14 + 8 * c].astype(np.float64)
            centre, half, ratio = _ellipse_box(f[:6], f[6], f[7])
            plo, phi = centre - half, centre + half
            if ratio <= ELL_CULL_ANISO:
                m = ELL_CULL_M
                rows = ((ylo < phi[1] + m) & (ylo + 1 > plo[1] - m)).sum()
                cols = ((xlo < phi[0] + m) & (xlo + 1 > plo[0] - m)).sum()
                ops += OPS_ELLIPSE_PIXEL * float(rows) * float(cols)
            else:
                ops += OPS_ELLIPSE_PIXEL * float(wh) * ww
    nbytes, residue = object_window_reach_bytes(args, kw)
    return nbytes, float(ops), residue


def polygon_coverage_work(pts, n_edges, px, py):
    """Bytes and float operations one polygon_coverage launch needs: 13
    bytes a sample point; 45 operations per (edge, point) pair whose cell
    row meets the edge's y-span and whose cell is not right of the edge.
    The renderer's sample grids are regular (one x per column, one y per
    row), so the pairs are counted per row and per column."""
    from flowgen_torch.ops.window import _closed_edges

    n_edges = n_edges.reshape(-1).cpu()
    e = _closed_edges(pts.float().cpu(), n_edges).double().numpy()
    pxc, pyc = px.double().cpu().numpy(), py.double().cpu().numpy()
    if not ((pxc == pxc[:, :1, :]).all() and (pyc == pyc[:, :, :1]).all()):
        fail("polygon_coverage sample grids are not regular")
    ops = 0.0
    for i in range(e.shape[0]):
        ne = int(n_edges[i])
        ops += OPS_EDGE_PIXEL * _edge_pairs(
            *(e[i, k, :ne] for k in range(4)), pyc[i, :, 0] - 0.5,
            pxc[i, 0, :] - 0.5).sum()
    return POLYGON_POINT_BYTES * float(px.numel()), float(ops)


def bits_differ(a, b) -> int:
    """Elements of float32 tensors ``a`` and ``b`` whose bits differ, the
    sign of a zero aside (x + 0.0 turns -0 into +0)."""
    return int(((a + 0.0).view(torch.int32)
                != (b + 0.0).view(torch.int32)).sum())


def bound_of(nbytes, ops):
    t_b, t_o = nbytes / PEAK_BYTES_S, ops / PEAK_F32_S
    return {"bound_ms": 1e3 * max(t_b, t_o),
            "bound_by": "bytes" if t_b >= t_o else "operations",
            "bytes": nbytes, "operations": ops}


def step_object_window(cfg, atlas_q, bank, card, dev):
    """Step 0 of a windowed path (B=64, seed 0) rendered with every
    object_window launch held against its plain version on the planes as
    the launch found them (bit for bit, the sign of a zero aside), then
    timed alone
    with a cold L2 on copies of the step's final planes, with its bound.
    Prints the step's launch count, summed ms and summed bound; returns
    them, the largest launch of each window class (timed as well with 10
    back-to-back launches) and the step's polygon_coverage launches."""
    from flowgen_torch.compose.render import render_batch
    from flowgen_torch.ops import window
    from flowgen_torch.warpfields import generator as wg

    n_slots = wg.bank_size(cfg) if bank is not None else 1
    scenes = sample(cfg, 0, torch.arange(cfg.batch_size), dev, n_slots)
    kernel = window.object_window
    calls = []

    def checked(*args, **kw):
        frames, flow = args[4], args[5]
        fp = frames.clone()
        flp = flow.clone() if kw["emit_flow"] else flow
        with window.plain_versions():
            p_ms, _ = host_ms(lambda: kernel(*args[:4], fp, flp, args[6],
                                             **kw))
        kernel(*args, **kw)
        err = float((frames - fp).abs().max())
        bits = bits_differ(frames, fp)
        if kw["emit_flow"]:
            err = max(err, float((flow - flp).abs().max()))
            bits += bits_differ(flow, flp)
        calls.append((args, kw, err, bits, p_ms))

    checked.launches = kernel.launches   # the wrapper counts on this name
    window.object_window = checked
    pc_calls, pc_restore = record_launches(window, "polygon_coverage")
    try:
        out = render_batch(scenes, atlas_q, cfg, bank)
    finally:
        pc_restore()
        kernel.launches = checked.launches
        window.object_window = kernel
    torch.cuda.synchronize()
    flow1 = out[3] if cfg.compute_inverse_flow else None
    planes = {0: (out[0].clone(), out[2].clone()),
              1: (out[1].clone(), None if flow1 is None else flow1.clone())}
    del out
    step = {"launches": len(calls), "ms": 0.0, "bound_ms": 0.0,
            "max_abs_err": 0.0, "bits_differ": 0, "plain_ms": 0.0,
            "residue_px": 0.0}
    largest = {}
    for args, kw, err, bits, p_ms in calls:
        f, fl = planes[1 if kw["sampled"] else 0]
        call = functools.partial(kernel, *args[:4], f, fl, args[6], **kw)
        ms = event_ms(call, reps=3, cold=True)
        nbytes, ops, residue = object_window_work(args, kw)
        bd = bound_of(nbytes, ops)
        step["ms"] += ms
        step["residue_px"] += residue
        step["bound_ms"] += bd["bound_ms"]
        step["plain_ms"] += p_ms
        step["max_abs_err"] = max(step["max_abs_err"], err)
        step["bits_differ"] += bits
        cls = f"{kw['max_hw'][0]}x{kw['max_hw'][1]}"
        n = args[3].shape[0]
        if cls not in largest or n > largest[cls]["windows"]:
            largest[cls] = {"windows": n, "frame": int(kw["sampled"]),
                            "ms_cold": ms, "plain_ms": p_ms,
                            "max_abs_err": err, "residue_px": residue,
                            "call": call, **bd}
    for cls, row in sorted(largest.items()):
        row["ms"] = event_ms(row.pop("call"))
        print(f"object_window, the largest launch of class {cls} in step 0 "
              f"(mode {cfg.mode}): {row['windows']} windows (frame "
              f"{row['frame']}): {row['ms']:.4f} ms per launch (CUDA events, "
              f"10 launches back to back), {row['ms_cold']:.4f} ms with a "
              f"cold L2; plain version {row['plain_ms']:.1f} ms; bound "
              f"{row['bound_ms']:.4f} ms by {row['bound_by']} "
              f"({row['bytes']:.4e} bytes, {row['operations']:.4e} float "
              f"ops; {row['residue_px']:.0f} pixels with a blend residue "
              f"under 2^-9 not counted); max |d| vs plain "
              f"{row['max_abs_err']} [{card}]")
    step["share_of_bound"] = step["bound_ms"] / step["ms"]
    print(f"object_window over step 0 of windowed mode {cfg.mode} "
          f"({cfg.width}x{cfg.height}, B={cfg.batch_size}): "
          f"{step['launches']} launches, each against its plain version "
          f"(max |d| {step['max_abs_err']}, {step['bits_differ']} values "
          f"with other bits, the sign of a zero aside); {step['ms']:.4f} ms "
          f"summed "
          f"(CUDA events, each launch alone with a cold L2, mean of 3), bound "
          f"{step['bound_ms']:.4f} ms summed ({step['share_of_bound']:.3f} of "
          f"it; {step['residue_px']:.0f} pixels with a blend residue under "
          f"2^-9 not counted); plain versions {step['plain_ms']:.1f} ms [{card}]")
    if step["max_abs_err"] != 0.0 or step["bits_differ"]:
        fail(f"object_window differs from its plain version in a mode-"
             f"{cfg.mode} step")
    if step["share_of_bound"] > 1.0:
        fail("object_window reads above its bound: the count is wrong")
    return step, largest, pc_calls


def time_polygon_coverage(calls, card):
    """The recorded polygon_coverage launch with the most sample points:
    CUDA events over 10 launches, the plain version once, the bound."""
    from flowgen_torch.ops import window

    args, _ = max(calls, key=lambda c: c[0][2].numel())
    pts, n_edges, px, py = args
    call = lambda: window.polygon_coverage(pts, n_edges, px, py)
    ms = event_ms(call)
    ka, ki = call()
    p_ms, (pa, pi) = host_ms(lambda: window.polygon_coverage_plain(
        pts, n_edges, px, py))
    err = max(float((ka - pa).abs().max()), float((ki != pi).float().max()))
    bd = bound_of(*polygon_coverage_work(pts, n_edges, px, py))
    print(f"polygon_coverage, {px.shape[0]} outlines over {tuple(px.shape[1:])}"
          f" windows: {ms:.4f} ms per launch (CUDA events, 10 launches); plain "
          f"version {p_ms:.1f} ms; bound {bd['bound_ms']:.4f} ms by "
          f"{bd['bound_by']} ({bd['bytes']:.4e} bytes, {bd['operations']:.4e} "
          f"float ops); max |d| vs plain {err} [{card}]")
    if err != 0.0:
        fail("polygon_coverage differs from its plain version")
    return {"ms": ms, "plain_ms": p_ms, "max_abs_err": err,
            "outlines": px.shape[0], **bd}


def phase_window_timing(atlas_q, bank9, card, dev):
    """Phase 15: the window kernels at the main paths' shapes, over step 0
    of the windowed mode-7 and mode-9 paths (object_window: every launch;
    polygon_coverage: the mode-9 step's largest launch)."""
    ow7, largest7, _ = step_object_window(sintel_cfg(mode=7), atlas_q, None,
                                          card, dev)
    ow9, _, pc_calls = step_object_window(sintel_cfg(mode=9), atlas_q, bank9,
                                          card, dev)
    if not pc_calls:
        fail("the mode-9 render launched no polygon_coverage")
    pc = time_polygon_coverage(pc_calls, card)
    from flowgen_torch.ops import window

    step = {"launches": len(pc_calls), "ms": 0.0, "bound_ms": 0.0,
            "max_abs_err": 0.0, "bits_differ": 0}
    for args, _ in pc_calls:
        ka, ki = window.polygon_coverage(*args)
        pa, pi = window.polygon_coverage_plain(*args)
        step["max_abs_err"] = max(step["max_abs_err"],
                                  float((ka - pa).abs().max()))
        step["bits_differ"] += bits_differ(ka, pa) + int((ki != pi).sum())
        step["ms"] += event_ms(functools.partial(window.polygon_coverage,
                                                 *args), reps=3, cold=True)
        step["bound_ms"] += bound_of(*polygon_coverage_work(*args))["bound_ms"]
    print(f"polygon_coverage over step 0 of windowed mode 9: "
          f"{step['launches']} launches, each against its plain version (max "
          f"|d| {step['max_abs_err']}, {step['bits_differ']} values with "
          f"other bits, the sign of a zero aside); {step['ms']:.4f} ms summed "
          f"(CUDA events, each launch alone with a cold L2, mean of 3), bound "
          f"{step['bound_ms']:.4f} ms summed [{card}]")
    if step["max_abs_err"] != 0.0 or step["bits_differ"]:
        fail("polygon_coverage differs from its plain version in a mode-9 "
             "step")
    pc["step_mode9"] = step
    return {"mode7": ow7, "mode9": ow9, "largest": largest7}, pc


def resample_cases():
    """Phase 15b's shapes: (label, image (h, w), slab margin, window (wh,
    ww), output origin, scale, rotation, translation or None, envelope
    (rotation, inverse scale) that sizes P). The 192x256 window of a
    512x384 texture timed since the kernel's port, then whole frames as
    the scene kernel's background pass resamples them: a 384x512 output
    from the 2H x 2W source of the 512x384 configuration and a 436x1024
    output from MPI-Sintel's 872x2048, in slabs with SLAB_MARGIN reflected
    texels a side, P from mode 7's background envelope, at a rotation and
    scale inside it, the window's centre on the source's (translation
    None)."""
    import flowgen_torch
    from flowgen_torch.ops import scene as ps

    env = ps.bg_envelope(flowgen_torch.MODES[7])
    M = ps.SLAB_MARGIN
    return (("192x256 window of a 512x384 texture", (384, 512), 64,
             (192, 256), (16, 8), 1.15, 0.3, (120.0, 20.0), (0.7, 1.35)),
            ("384x512 frame from the 768x1024 source", (768, 1024), M,
             (384, 512), (0, 0), 1.1, 0.15, None, env),
            ("436x1024 frame from Sintel's 872x2048 source", (872, 2048), M,
             (436, 1024), (0, 0), 1.1, 0.15, None, env))


def resample_inputs(case, dev):
    """One of :func:`resample_cases` as arguments of ``affine_resample``:
    (slab on ``dev``, transform, x0, y0, wh, ww, P)."""
    import math

    import flowgen_torch
    from flowgen_torch.ops import resample as res

    _, (h, w), margin, (wh, ww), (x0, y0), sc, th, tr, (rot, inv) = case
    img = torch.from_numpy(flowgen_torch.procedural_atlas(
        1, height=h // 2, width=w // 2, seed=1)[0])
    slab = res.pack_padded_slab(img, margin, margin).to(dev)
    P = res.max_row_span(wh, ww, rot + 1e-6, inv)
    a, b = sc * math.cos(th), sc * math.sin(th)
    if tr is None:
        cx, cy = x0 + 0.5 * ww, y0 + 0.5 * wh
        tr = (margin + 0.5 * w - (a * cx - b * cy),
              margin + 0.5 * h - (b * cx + a * cy))
    t = torch.tensor([[a, -b, tr[0]], [b, a, tr[1]]])
    return slab, t, x0, y0, wh, ww, P


def resample_timing(card, dev):
    """The standalone affine resampler at each of :func:`resample_cases`
    with its default bands, against its plain version, timed beside an
    empty kernel's launch (the floor under any launch's time) and its bytes
    bound: the window written once (12 bytes a pixel) and the slab texels
    its footprint covers read once (4 bytes each). Beside the device time
    (CUDA events), the whole call by host clock, its host work included:
    100 calls back to back, then a synchronize."""
    import ctypes

    from flowgen_torch.ops import _build
    from flowgen_torch.ops import resample as res

    lib = _build.load_fields_library()
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    floor_ms = event_ms(lambda: lib.flowgen_noop(stream))
    out = []
    for case in resample_cases():
        label = case[0]
        slab, t, x0, y0, wh, ww, P = resample_inputs(case, dev)
        call = lambda: res.affine_resample(slab, t, x0, y0, wh=wh, ww=ww, P=P)
        ms = event_ms(call)
        call_ms = host_ms(lambda: [call() for _ in range(100)])[0] / 100
        k = call()
        p_ms, p = host_ms(lambda: res.affine_resample_plain(
            slab, t, x0, y0, wh=wh, ww=ww, P=P))
        err = float((k - p).abs().max())
        bits = bits_differ(k, p)
        det = abs(float(t[0, 0] * t[1, 1] - t[0, 1] * t[1, 0]))
        bd = bound_of(wh * ww * (12 + 4 * det), 0.0)
        print(f"affine_resample, {label}, slab {tuple(slab.shape)}, P={P}: "
              f"{ms:.4f} ms per launch (CUDA events, 10 launches); the whole "
              f"call {call_ms:.4f} ms (host clock, 100 calls); an empty "
              f"kernel's launch {floor_ms:.4f} ms; plain version "
              f"{p_ms:.1f} ms; bound {bd['bound_ms']:.5f} ms by bytes "
              f"({bd['bytes']:.4e} bytes), {bd['bound_ms'] / ms:.1%} of it; "
              f"max |d| vs plain {err}, {bits} values with other bits "
              f"[{card}]")
        if bits or err != 0.0:
            fail(f"affine_resample differs from its plain version ({label})")
        out.append({"shape": label, "ms": ms, "call_ms": call_ms,
                    "plain_ms": p_ms,
                    "max_abs_err": err, "launch_floor_ms": floor_ms, **bd})
    return out


def phase_affine_resample(card, dev):
    """Phase 15b: :func:`resample_timing`, then band widths narrower than
    the default 4 tiles (x_tiles_scan, y_tiles_scan), where a tap outside
    its block's band reads 0 in the kernel and its plain version, bit for
    bit."""
    from flowgen_torch.ops import resample as res

    out = resample_timing(card, dev)
    slab, t, x0, y0, wh, ww, P = resample_inputs(resample_cases()[0], dev)
    for xs, ys in ((1, 1), (2, 1), (1, 2)):
        kw = dict(wh=wh, ww=ww, P=P, x_tiles_scan=xs, y_tiles_scan=ys)
        k = res.affine_resample(slab, t, x0, y0, **kw)
        p = res.affine_resample_plain(slab, t, x0, y0, **kw)
        err, bits = float((k - p).abs().max()), bits_differ(k, p)
        print(f"affine_resample, {resample_cases()[0][0]}, bands of {xs} and "
              f"{ys} tiles: {int((p == 0).sum())} values read 0 in the plain "
              f"version; max |d| vs plain {err}, {bits} values with other "
              f"bits")
        if bits or err != 0.0:
            fail(f"affine_resample with bands ({xs}, {ys}) differs from its "
                 "plain version")
        out[0]["max_abs_err"] = max(out[0]["max_abs_err"], err)
    return out


def phase_windowed(card, dev):
    """Phases 12-15. Returns the rows of the window kernels and the
    resampler."""
    import flowgen_torch
    from flowgen_torch.pipeline.generator import make_atlas_packer

    cfg7, cfg9 = sintel_cfg(mode=7), sintel_cfg(mode=9)
    t0 = time.perf_counter()
    atlas = procedural_atlas(cfg7.height, cfg7.width)  # 32 textures, 872x2048
    atlas_q = make_atlas_packer(dev)(atlas)
    print(f"procedural atlas {atlas.shape}: {time.perf_counter() - t0:.1f} s "
          "(numpy, host)")

    # ---- 12: bank at 3072^2, windowed kernels vs plain, invariants ----
    bank9, bank_err = phase_sintel_bank(cfg9, dev)
    plains, worst = phase_windowed_vs_plain(atlas_q, bank9, dev)
    phase_windowed_invariants(dev)

    stamp("phase 12 (windowed vs plain) done")

    # ---- 13-14: the windowed main paths ----
    r7 = phase_windowed_main(cfg7, atlas, atlas_q, plains["mode 7"], card, dev)
    r9 = phase_windowed_main(cfg9, atlas, atlas_q, plains["mode 9"], card, dev,
                             n_steps=3, prof_steps=2)
    stamp("phases 13-14 (windowed main paths) done")
    if not r9["launches"]["polygon_coverage"]:
        fail("the windowed mode-9 path launched no polygon_coverage")

    # ---- 15: kernel timing at the main paths' shapes ----
    ow, pc = phase_window_timing(atlas_q, bank9, card, dev)
    ar_cases = phase_affine_resample(card, dev)
    ar = ar_cases[-1]
    small = ow["largest"]["192x256"]
    full = ow["largest"][f"{SINTEL_HW[0]}x{SINTEL_HW[1]}"]
    no_lib = ("no single PyTorch call computes it")
    return [
        {
            "name": "object_window", "route": "cuda",
            "source": "flowgen_torch/csrc/window.cu",
            "replaces": "flowgen/ops/pallas_raster.py:335",
            "launches": r7["launches"]["object_window"],
            "max_abs_err": max(worst, ow["mode7"]["max_abs_err"],
                               ow["mode9"]["max_abs_err"]),
            "ms": small["ms"], "plain_ms": small["plain_ms"],
            "bound_ms": small["bound_ms"], "bound_by": small["bound_by"],
            "library_ms": None, "library": no_lib,
            "path": "windowed mode 7, 1024x436, B=64",
            "shape": f"{small['windows']} windows of 192x256",
            "full_frame": full, "step_mode7": ow["mode7"],
            "step_mode9": ow["mode9"],
            "mode9_launches": r9["launches"]["object_window"],
        },
        {
            "name": "polygon_coverage", "route": "cuda",
            "source": "flowgen_torch/csrc/window.cu",
            "replaces": "flowgen/ops/pallas_raster.py:391",
            "launches": r9["launches"]["polygon_coverage"],
            "max_abs_err": max(worst, pc["max_abs_err"],
                               pc["step_mode9"]["max_abs_err"]),
            "ms": pc["ms"], "plain_ms": pc["plain_ms"],
            "bound_ms": pc["bound_ms"], "bound_by": pc["bound_by"],
            "library_ms": None, "library": no_lib,
            "path": "windowed mode 9, 1024x436, B=64",
            "shape": f"{pc['outlines']} outlines, the largest launch of a "
                     "mode-9 step",
        },
        {
            "name": "affine_resample", "route": "cuda",
            "source": "flowgen_torch/csrc/resample.cu",
            "replaces": "flowgen/ops/pallas_resample.py:369",
            "launches": 0,
            "max_abs_err": max(c["max_abs_err"] for c in ar_cases),
            "ms": ar["ms"], "plain_ms": ar["plain_ms"],
            "bound_ms": ar["bound_ms"], "bound_by": ar["bound_by"],
            "library_ms": None, "library": no_lib,
            "path": "0 launches on any path (standalone, as in the JAX "
                    "package)",
            "shape": ar["shape"], "launch_floor_ms": ar["launch_floor_ms"],
            "cases": ar_cases,
        },
    ], bank_err


# int32 operations per value of the photometric kernel's hash:
# threefry2x32's 20 rounds of add, rotate and xor, its 5 key injections of
# 2 adds, the counter's add and the output words' xor, then the shift and
# the or that make the uniform's mantissa (csrc/photometric.cu).
OPS_PHOTOMETRIC_VALUE = 74
# H100 SXM int32 rate outside the tensor cores: 132 SMs x 64 INT32 lanes x
# 1.98 GHz (the clock of the data sheet's 67 TFLOP/s float32 = 132 x 128
# lanes x 2 x 1.98 GHz).
PEAK_INT32_S = 132 * 64 * 1.98e9
# Issue slots: 4 warp schedulers an SM, one warp instruction (32 lanes) a
# clock each.
PEAK_ISSUE_LANES_S = 132 * 4 * 32 * 1.98e9


def photometric_bound(n_values: int):
    """Least time for the photometric pass over ``n_values`` float32
    values: each read once and written once (8 bytes), and the hash's int32
    operations at the card's int32 rate."""
    nbytes = 8.0 * n_values
    ops = float(OPS_PHOTOMETRIC_VALUE) * n_values
    t_b, t_o = nbytes / PEAK_BYTES_S, ops / PEAK_INT32_S
    return {"bound_ms": 1e3 * max(t_b, t_o),
            "bound_by": "bytes" if t_b >= t_o else "operations",
            "bytes": nbytes, "operations": ops,
            "bytes_ms": 1e3 * t_b, "ops_ms": 1e3 * t_o}


def photometric_build_facts():
    """Registers and occupancy of the photometric kernels (nvcc's -Xptxas
    -v) and the SASS count of the value pass's loop a value (12 values an
    iteration of a thread), with the time its integer ALU instructions and
    its issue slots alone would take a value."""
    from flowgen_torch.ops import _build

    info = _build.BUILD_INFO["flowgen_photometric"]
    regs = ptxas_registers(info["log"])
    facts = {"kernels": {}}
    for name, r in regs.items():
        short = ("table pass" if "table" in name else "value pass, float4"
                 if "ILb1E" in name else "value pass, scalar")
        facts["kernels"][short] = occupancy(r, 256, 3136)
    funcs = sass_functions(info["path"])
    vec = [n for n in funcs if "photometric_kernelILb1E" in n]
    if len(vec) != 1:
        fail(f"the value pass's float4 kernel is not in the SASS: {list(funcs)}")
    c = sass_loop_counts(funcs[vec[0]], 12)
    pv = c["per_value"]
    c["int_alu_ms_a_value_at_int32_rate"] = pv["int_alu"] / PEAK_INT32_S * 1e3
    c["issue_ms_a_value"] = pv["all"] / PEAK_ISSUE_LANES_S * 1e3
    facts["sass"] = c
    return facts


def phase_photometric(card, dev):
    """Phase 16: photometric augmentation in mode 7, 512x384, B=64. The
    kernels against their plain version on step 0's rendered frames and on
    frames off the whole levels, bit for bit; their time by CUDA events
    beside the plain version's and the bound, their registers and the SASS
    count a value;
    then the pipelined main path through Generator with the stage and the
    same run without it, back to back. Returns the kernel's row."""
    import dataclasses

    import flowgen_torch
    from flowgen_torch.ops import photometric
    from flowgen_torch.ops import scene as ps
    from flowgen_torch.pipeline.generator import make_slab_packer
    from flowgen_torch.random.streams import root_key

    cfg = flowgen_torch.DataGenConfig(mode=7, batch_size=64, seed=0)
    atlas = procedural_atlas(cfg.height, cfg.width)
    slabs = make_slab_packer(cfg, dev)(atlas)
    args, opts = scene_tables(cfg, 0, 0, slabs, dev)
    frames = as_batch(ps.scene_render(*args, **opts))
    i0, i1 = frames["image0"].contiguous(), frames["image1"].contiguous()
    del frames, args, slabs
    root = root_key(cfg.seed, dev)
    idx = torch.arange(cfg.batch_size, device=dev)
    k0, k1 = photometric.augment_batch(root, idx, i0, i1)
    torch.cuda.synchronize()
    p_ms, (p0, p1) = host_ms(
        lambda: photometric.augment_batch_plain(root, idx, i0, i1))
    bits = bits_differ(k0, p0) + bits_differ(k1, p1)
    err = max(float((k0 - p0).abs().max()), float((k1 - p1).abs().max()))
    del p0, p1
    k_ms = event_ms(lambda: photometric.augment_batch(root, idx, i0, i1))
    n_values = 2 * i0.numel()
    bd = photometric_bound(n_values)
    facts = photometric_build_facts()
    sass = facts["sass"]
    pv = sass["per_value"]
    issue_ms = sass["issue_ms_a_value"] * n_values
    alu_ms = sass["int_alu_ms_a_value_at_int32_rate"] * n_values
    print(f"photometric kernels (mode 7, B=64, 512x384; the table pass and "
          f"the value pass, 2 CUDA kernels a call): {k_ms:.4f} ms per call "
          f"(CUDA events, 10 calls); plain version {p_ms:.1f} ms; bound "
          f"{bd['bound_ms']:.4f} ms by {bd['bound_by']} (bytes "
          f"{bd['bytes']:.4e}: {bd['bytes_ms']:.4f} ms; int32 operations "
          f"{bd['operations']:.4e}: {bd['ops_ms']:.4f} ms), "
          f"{bd['bound_ms'] / k_ms:.1%} of it [{card}]")
    print("photometric registers and occupancy (ptxas): " + json.dumps(
        facts["kernels"], sort_keys=True))
    print(f"photometric value pass SASS, a value (loop of "
          f"{sass['loop_instructions']} instructions for 12 values, "
          f"{sass['rare_arm_instructions']} of them in the float64 arm): "
          f"{pv['all']:.2f} instructions, {pv['int_alu']:.2f} on the "
          f"integer ALU, {pv['imad']:.2f} IMAD on the FMA pipe; by family "
          + json.dumps({k: round(v, 2) for k, v in pv["families"].items()})
          + f"; the integer ALU's count at the int32 rate {alu_ms:.4f} ms, "
          f"every instruction at the issue rate {issue_ms:.4f} ms")
    print(f"photometric kernel vs plain (B=64): max |d| {err}, {bits} "
          "values with other bits")
    if bits or err != 0.0:
        fail("the photometric kernel differs from its plain version")
    # Values off the whole levels take the kernel's direct arm: every 7th a
    # quarter up, every 11th one ulp down, every 13th -0.
    mixed = i0.clone().view(-1)
    mixed[::7] += 0.25
    mixed[::11] = torch.nextafter(mixed[::11], torch.tensor(-1.0, device=dev))
    mixed[::13] = -0.0
    mixed = mixed.view_as(i0)
    m0, m1 = photometric.augment_batch(root, idx, mixed, i1)
    q0, q1 = photometric.augment_batch_plain(root, idx, mixed, i1)
    mbits = (int((m0.view(torch.int32) != q0.view(torch.int32)).sum())
             + int((m1.view(torch.int32) != q1.view(torch.int32)).sum()))
    print(f"photometric kernel vs plain on frames off the whole levels "
          f"(B=64): {mbits} values with other bits")
    if mbits:
        fail("the photometric kernel's direct arm differs from the plain "
             "version")
    del mixed, m0, m1, q0, q1

    _, off = run_main_path(cfg, atlas, card, label=", no photometric")
    cfg_p = dataclasses.replace(cfg, photometric_augment=True)
    first, on = run_main_path(cfg_p, atlas, card, label=", photometric")
    step0 = (bits_differ(first["image0"], k0)
             + bits_differ(first["image1"], k1))
    print(f"photometric main path step 0 vs the kernel's output above: "
          f"{step0} values with other bits")
    if step0:
        fail("the photometric main path disagrees with the kernel's output")
    print(f"photometric pipelined (mode 7, B=64): {on['ms_per_step']:.2f} "
          f"ms/step, {on['samples_per_s']:.1f} samples/s with the stage; "
          f"{off['ms_per_step']:.2f} ms/step, {off['samples_per_s']:.1f} "
          f"samples/s without it, same call [{card}]")
    # The row keeps the 74-operation hash bound, so shares compare across
    # PRs. A kernel faster than it means the count is wrong: fix the count
    # from the function's own arithmetic.
    if k_ms < bd["bound_ms"]:
        fail(f"photometric kernels ({k_ms:.4f} ms) beat their bound "
             f"({bd['bound_ms']:.4f} ms): OPS_PHOTOMETRIC_VALUE is wrong")
    return {
        "name": "photometric", "route": "cuda",
        "source": "flowgen_torch/csrc/photometric.cu",
        "replaces": "flowgen/ops/photometric.py:82",
        "launches": on["launches"]["photometric"], "max_abs_err": err,
        "ms": k_ms, "plain_ms": p_ms, "bound_ms": bd["bound_ms"],
        "bound_by": bd["bound_by"], "library_ms": None,
        "cuda_kernels_per_call": 2, "registers": facts["kernels"],
        "sass_per_value": pv, "issue_bound_ms": issue_ms,
        "int_alu_bound_ms": alu_ms,
        "library": "no single PyTorch call computes it",
        "path": "mode 7 with photometric_augment, B=64",
        "shape": "64 pairs of 384x512x3 float32 frames",
        "replaces_note": "XLA in the JAX package (no pallas_call): the "
                         "fused elementwise loop of augment_batch",
        "pipelined": {"with": on["ms_per_step"], "without": off["ms_per_step"]},
    }


# The TextureDB phase's sources: (class, height, width). Canonical is 2H x
# 2W of 512x384; small takes the whole-image fallback (under 384x512);
# large has a tighter field of view than the canonical resize.
TEXDB_CLASSES = (("canonical", 768, 1024), ("small", 300, 400),
                 ("large", 1536, 2048))


def write_texture_files(n: int = 64, seed: int = 0):
    """``n`` texture files made from ``seed`` (blocks of random colours,
    cells of 4-32 px), cycling through the three size classes, written as
    binary PPM under build/smoke_textures with a list file. Returns the
    list file's path."""
    rng = np.random.default_rng(seed)
    out = os.path.join(HERE, "build", "smoke_textures")
    os.makedirs(out, exist_ok=True)
    paths = []
    for t in range(n):
        name, h, w = TEXDB_CLASSES[t % 3]
        cell = int(rng.integers(4, 33))
        base = rng.integers(0, 256, (h // cell + 1, w // cell + 1, 3),
                            dtype=np.uint8)
        img = np.repeat(np.repeat(base, cell, 0), cell, 1)[:h, :w]
        path = os.path.join(out, f"tex{t:02d}_{name}.ppm")
        with open(path, "wb") as f:
            f.write(b"P6\n%d %d\n255\n" % (w, h))
            f.write(np.ascontiguousarray(img).tobytes())
        paths.append(path)
    list_file = os.path.join(out, "textures.txt")
    with open(list_file, "w") as f:
        f.write("\n".join(paths) + "\n")
    return list_file


def phase_texture_db(card, dev):
    """Phase 17: a TextureDB of 64 sources in three size classes, loaded
    from a list file through the port's loader path (``atlas_for_config``:
    PIL decode, ``build_texture_db``), and the canonical atlas of the same
    files through the native loader. In modes 7 and 13 (with flow1 and
    masks) at 512x384, B=64: the scene kernel against its plain version on
    step 0's tables bit for bit (as phase 4), and the main path through
    Generator with its throughput and peak memory; then the windowed
    renderer at 1024x436, B=4, mode 7, through the window kernels against
    their plain versions, bit for bit (the sign of a zero aside, as phase
    15). Returns the scene kernel's worst difference and the window
    kernels'."""
    import dataclasses

    import flowgen_torch
    from flowgen_torch.compose.render import render_batch
    from flowgen_torch.ops import scene as ps
    from flowgen_torch.ops import window
    from flowgen_torch.pipeline.generator import (make_atlas_packer,
                                                  make_slab_packer)
    from flowgen_torch.texture_io import build_texture_db, load_texture_db

    t0 = time.perf_counter()
    list_file = write_texture_files()
    t1 = time.perf_counter()
    cfg7 = flowgen_torch.DataGenConfig(mode=7, batch_size=64, seed=0,
                                       texture_dbases=(list_file,))
    db = flowgen_torch.atlas_for_config(cfg7)
    t2 = time.perf_counter()
    if not isinstance(db, flowgen_torch.TextureDB):
        fail("atlas_for_config did not give a TextureDB")
    canon = load_texture_db([list_file], height=cfg7.height,
                            width=cfg7.width, native_fov=False)
    t3 = time.perf_counter()
    classes = [t % 3 for t in range(db.sizes.shape[0])]
    same = [i for i, c in enumerate(classes) if c == 0]
    if not np.array_equal(canon[same], db.canonical[same]):
        fail("the native loader's canonical atlas differs from PIL's on "
             "sources of the canonical size")
    diff = np.abs(canon.astype(np.int16) - db.canonical.astype(np.int16))
    print(f"TextureDB: {db.sizes.shape[0]} sources "
          f"({', '.join(f'{n} {h}x{w}' for n, h, w in TEXDB_CLASSES)}) "
          f"written in {t1 - t0:.1f} s, loaded with native field of view "
          f"in {t2 - t1:.1f} s; the native loader's canonical atlas in "
          f"{t3 - t2:.1f} s, byte-equal to the PIL resize on the "
          f"canonical-size sources, mean |d| {float(diff.mean()):.3f} levels "
          "over all (two resamplers)")
    del canon, diff

    worst = 0.0
    runs = {}
    for mode, extra in ((7, {}), (13, dict(compute_inverse_flow=True,
                                           emit_masks=True))):
        cfg = dataclasses.replace(cfg7, mode=mode, **extra)
        slabs = make_slab_packer(cfg, dev)(db)
        print(f"TextureDB mode {mode} slabs: objects "
              f"{tuple(slabs[0].shape)}, backgrounds {tuple(slabs[1].shape)}")
        args, opts = scene_tables(cfg, 0, 0, slabs, dev)
        t = phase_scene_timing(f"TextureDB mode {mode}", args, opts, card)
        ref = as_batch(ps.scene_render(*args, **opts))
        first, res = run_main_path(cfg, db, card, label=", TextureDB")
        g = gates({k: first[k][:4] for k in first},
                  {k: v[:4] for k, v in ref.items()})
        print(f"TextureDB mode {mode} main path step 0 vs the kernel on "
              "step 0's tables (samples 0-3): " + json.dumps(g, sort_keys=True))
        if not g["ok"] or g["max_abs_err"] != 0.0:
            fail(f"TextureDB mode {mode}: the main path disagrees with the "
                 "kernel's render")
        worst = max(worst, t["max_abs_err"])
        runs[mode] = {"scene_ms": t["ms"], "ms_per_step": res["ms_per_step"],
                      "samples_per_s": res["samples_per_s"],
                      "peak_gib": res["peak_gib"]}
        del slabs, args, ref, first

    cfg_s = dataclasses.replace(sintel_cfg(mode=7), texture_dbases=(list_file,))
    cfg_s4 = dataclasses.replace(cfg_s, batch_size=4)
    natives = [db.sources[t, :h, :w] for t, (h, w) in enumerate(db.sizes)]
    db_s = build_texture_db(natives, height=cfg_s.height, width=cfg_s.width)
    atlas_q = make_atlas_packer(dev)(db_s)
    s0, scenes = windowed_samples(cfg_s, dev)
    before = read_counts()
    k_out = as_windowed(render_batch(scenes, atlas_q, cfg_s4, None), cfg_s4)
    torch.cuda.synchronize()
    launched = {k: v - before[k] for k, v in read_counts().items()}
    with window.plain_versions():
        p_out = as_windowed(render_batch(scenes, atlas_q, cfg_s4, None),
                            cfg_s4)
    cmp = gates(k_out, p_out)
    cmp["values_with_other_bits"] = {k: bits_differ(k_out[k], p_out[k])
                                     for k in k_out}
    print(f"TextureDB windowed mode 7 kernels vs plain (samples {s0}-"
          f"{s0 + 3}, {cfg_s.width}x{cfg_s.height}, launches "
          f"{json.dumps(launched)}): " + json.dumps(cmp, sort_keys=True))
    if any(cmp["values_with_other_bits"].values()) or not launched[
            "object_window"]:
        fail("TextureDB windowed mode 7: the window kernels differ from "
             "their plain versions")
    print("TextureDB readings: " + json.dumps(runs) + f" [{card}]")
    return worst, cmp["max_abs_err"]


# ---------------------------------------------------------------------------
# Mode 9's "xla" bank stream, the public API and the trainer (phases 18-20)
# ---------------------------------------------------------------------------


def xla_bank_vs_cpu(dev):
    """Phase 18a: the "xla" stream's bank and warp planes of one epoch at
    128x96 (big field 384^2), on the card and by the same function on the
    CPU, held by the bank gate."""
    import flowgen_torch
    from flowgen_torch.random.streams import root_key
    from flowgen_torch.warpfields import generator as wg

    cfg = flowgen_torch.DataGenConfig(mode=9, batch_size=2, width=128,
                                      height=96, seed=0, warp_bank_impl="xla")
    bk, ak = wg.make_bank_and_aux(root_key(cfg.seed, dev), 0, cfg)
    bc, ac = wg.make_bank_and_aux(root_key(cfg.seed, "cpu"), 0, cfg)
    res = {name: field_gate(a.cpu(), b) for name, a, b in (
        ("flow", bk.flow, bc.flow), ("iflow", bk.iflow, bc.iflow),
        ("obj_aux", ak.obj, ac.obj), ("bg_aux", ak.bg, ac.bg))}
    bits = sum(bits_unequal(a.cpu(), b) for a, b in (
        (bk.flow, bc.flow), (bk.iflow, bc.iflow), (ak.obj, ac.obj),
        (ak.bg, ac.bg)))
    print("xla bank, card vs CPU (128x96, 4 big fields of 384^2; NaN-mask "
          "mismatch, median |d|, share of values over 0.01 px): "
          + json.dumps(res, sort_keys=True) + f"; {bits} values with other "
          "bits")
    if not all(r["ok"] for r in res.values()):
        fail("the xla bank on the card fails the bank gate against the CPU")
    return max(r["max_abs_err"] for r in res.values())


def bank_producer_ms(cfg, dev, impl, reps=3):
    """Host-clock ms of one bank epoch's make_bank_and_aux in stream
    ``impl`` (synchronized), the median of ``reps`` epochs after one
    warm-up epoch."""
    from flowgen_torch.random.streams import root_key
    from flowgen_torch.warpfields import generator as wg

    root = root_key(cfg.seed, dev)
    reuse = max(cfg.warp_bank_reuse_steps, 1)
    times = [host_ms(lambda e=e: wg.make_bank_and_aux(root, e * reuse, cfg,
                                                      impl=impl))[0]
             for e in range(reps + 1)]
    return float(np.median(times[1:]))


def phase_mode9_xla(res9, card, dev):
    """Phase 18: mode 9 with the "xla" bank stream at 512x384, B=64. The
    bank against the CPU's (18a); the scene kernel on the stream's warp
    planes against its plain version on samples 0-3 of step 0, bit for bit;
    the main path through Generator beside phase 7's (the "pallas" stream),
    with no composition kernel launched (the elementary field takes its
    kernel in both streams); the bank producer's ms per epoch at
    1536^2 in both streams. Returns the scene kernel's worst difference and
    launches."""
    import dataclasses

    import flowgen_torch
    from flowgen_torch.compose import fused
    from flowgen_torch.ops import scene as ps
    from flowgen_torch.pipeline.generator import make_slab_packer
    from flowgen_torch.random.streams import root_key
    from flowgen_torch.warpfields import generator as wg

    bank_err = xla_bank_vs_cpu(dev)
    cfg = flowgen_torch.DataGenConfig(mode=9, batch_size=64, seed=0,
                                      warp_bank_impl="xla")
    atlas = procedural_atlas(cfg.height, cfg.width)
    cfg4 = dataclasses.replace(cfg, batch_size=4)
    slabs = make_slab_packer(cfg4, dev)(atlas)
    _, aux = wg.make_bank_and_aux(root_key(cfg.seed, dev), 0, cfg)
    scenes = sample(cfg4, cfg.seed, torch.arange(4), dev, wg.bank_size(cfg))
    args, opts = fused.scene_tables(scenes, cfg4, *slabs, aux)
    opts = {**opts, "inverse_flow": True, "emit_masks": True}
    k_out = ps.scene_render(*args, **opts)
    torch.cuda.synchronize()
    p_out = ps.scene_render_plain(*args, **opts)
    bits = (int((k_out[0] != p_out[0]).sum()) + bits_differ(k_out[1], p_out[1])
            + int((k_out[2] != p_out[2]).sum()))
    plain = as_batch(p_out)
    cmp = gates(as_batch(k_out), plain)
    n_obj = int((scenes.objects.warp & scenes.objects.valid).sum())
    n_bg = int(scenes.background.warp.sum())
    print(f"mode 9 xla kernel vs plain (samples 0-3, inverse flow and ids, "
          f"{n_obj} deforming objects, {n_bg} deforming backgrounds): "
          + json.dumps(cmp, sort_keys=True) + f"; {bits} values with other "
          "bits")
    if bits or not cmp["ok"]:
        fail("mode 9 xla: the scene kernel differs from its plain version")
    del args, slabs, aux

    first, res = run_main_path(cfg, atlas, card, prof_steps=2,
                               label=", xla bank stream")
    g = gates({k: first[k][:4] for k in first},
              {k: plain[k] for k in ("image0", "image1", "flow0")})
    print("mode 9 xla main path step 0 vs plain (samples 0-3): "
          + json.dumps(g, sort_keys=True))
    if not g["ok"]:
        fail("mode 9 xla main path output disagrees with the plain render")
    del first
    counts = res["launches"]
    if counts["coarse_gdisp"] or counts["hwarp_rows"]:
        fail(f"the xla stream launched composition kernels: {counts}")
    print(f"mode 9 pipelined, xla stream {res['ms_per_step']:.2f} ms/step "
          f"({res['samples_per_s']:.1f} samples/s, {res['cuda_kernels']:.0f} "
          f"CUDA kernels a step), pallas stream (phase 7) "
          f"{res9['ms_per_step']:.2f} ms/step ({res9['samples_per_s']:.1f} "
          f"samples/s, {res9['cuda_kernels']:.0f}), same call [{card}]")
    xla_ms = bank_producer_ms(cfg, dev, "xla")
    pal_ms = bank_producer_ms(cfg, dev, "pallas")
    big = wg.big_field_size(cfg.width, cfg.height)
    print(f"bank producer (make_bank_and_aux, {cfg.warp_fields_per_batch} big "
          f"fields of {big}^2, host clock, synchronized, median of 3 "
          f"epochs): xla stream {xla_ms:.1f} ms per epoch, pallas stream "
          f"{pal_ms:.1f} ms [{card}]")
    return {"max_abs_err": max(cmp["max_abs_err"], g["max_abs_err"]),
            "bank_err": bank_err, "launches": counts["scene_render"],
            "ms_per_step": res["ms_per_step"],
            "samples_per_s": res["samples_per_s"],
            "bank_epoch_ms": {"xla": xla_ms, "pallas": pal_ms}}


def phase_windowed_xla(dev):
    """Phase 19: the windowed renderer at 1024x436, B=4, mode 9 with the
    "xla" bank stream (3072^2 big fields), through the window kernels
    against their plain versions on samples with a deforming object and
    background, bit for bit (the sign of a zero aside). Returns the worst
    difference and the kernels' launches."""
    import dataclasses

    from flowgen_torch.compose.render import render_batch
    from flowgen_torch.ops import window
    from flowgen_torch.pipeline.generator import make_atlas_packer
    from flowgen_torch.random.streams import root_key
    from flowgen_torch.warpfields import generator as wg

    cfg = sintel_cfg(mode=9, warp_bank_impl="xla")
    cfg4 = dataclasses.replace(cfg, batch_size=4)
    atlas_q = make_atlas_packer(dev)(procedural_atlas(cfg.height, cfg.width))
    ms, bank = host_ms(lambda: wg.make_warp_bank(root_key(cfg.seed, dev), 0,
                                                 cfg))
    s0, scenes = windowed_samples(cfg, dev)
    reset_counts()
    k_out = as_windowed(render_batch(scenes, atlas_q, cfg4, bank), cfg4)
    torch.cuda.synchronize()
    counts = read_counts()
    with window.plain_versions():
        p_out = as_windowed(render_batch(scenes, atlas_q, cfg4, bank), cfg4)
    bits = sum(bits_differ(k_out[k], p_out[k]) for k in k_out)
    cmp = gates(k_out, p_out)
    big = wg.big_field_size(cfg.width, cfg.height)
    print(f"windowed mode 9 xla kernels vs plain (samples {s0}-{s0 + 3}, "
          f"{cfg.width}x{cfg.height}, bank of {big}^2 fields built in "
          f"{ms:.1f} ms, launches "
          f"{json.dumps(counts)}): " + json.dumps(cmp, sort_keys=True)
          + f"; {bits} values with other bits")
    if bits or not cmp["ok"]:
        fail("windowed mode 9 xla: kernels differ from their plain versions")
    if not counts["object_window"] or not counts["polygon_coverage"]:
        fail(f"windowed mode 9 xla: a window kernel was not launched: {counts}")
    return cmp["max_abs_err"], counts


def phase_api(card, dev):
    """Phase 20a: the exported API and the adapters on the card. The
    DataLoader over torch_iterable_dataset (no workers) and
    FlowStepDataSource against Generator's steps, the mixed stream over
    modes 7 and 9 against the numpy draw and each ingredient's own batch,
    and one step of examples/train.prototxt. All bit for bit."""
    import flowgen_torch
    from torch.utils.data import DataLoader

    from flowgen_torch.pipeline import adapters, prototxt
    from flowgen_torch.random.streams import root_key

    def equal(a, b):
        return set(a) == set(b) and all(
            bits_unequal(torch.as_tensor(a[k]).to(dev), b[k].to(dev)) == 0
            for k in b)

    cfg = flowgen_torch.DataGenConfig(mode=7, batch_size=64, seed=0)
    atlas = procedural_atlas(cfg.height, cfg.width)
    gen = flowgen_torch.Generator(cfg, atlas=atlas, device=dev)
    ref = [gen.retrieve_batch() for _ in range(3)]
    gen.stop()
    it = iter(DataLoader(adapters.torch_iterable_dataset(cfg, atlas=atlas),
                         batch_size=None, num_workers=0))
    loader_ok = all(equal(next(it), ref[i]) for i in range(3))
    del it
    src = adapters.FlowStepDataSource(cfg, num_steps=4, atlas=atlas,
                                      start_step=1)
    source_ok = equal(src[1], ref[2]) and equal(src[0], ref[1])
    print(f"adapters on the card (mode 7, B={cfg.batch_size}): DataLoader over "
          f"torch_iterable_dataset steps 0-2 equal Generator's: {loader_ok}; "
          f"FlowStepDataSource(start_step=1)[0], [1] equal steps 1, 2: "
          f"{source_ok}")
    if not (loader_ok and source_ok):
        fail("an adapter's batches differ from Generator's")
    del ref, src

    cfgs = [flowgen_torch.DataGenConfig(mode=m, batch_size=16, seed=0)
            for m in (7, 9)]
    mixed = flowgen_torch.make_mixed_generate_fn(cfgs, device=dev)
    own = [flowgen_torch.make_generate_fn(c, dev) for c in cfgs]
    root = root_key(0, dev)
    picks, mixed_ok = [], True
    for step in range(8):
        u = np.random.default_rng([0, step, 0x6D69785D]).random()
        i = int(np.searchsorted(np.cumsum([0.5, 0.5]), u, side="right"))
        picks.append(cfgs[i].mode)
        mixed_ok &= equal(mixed(root, step, atlas), own[i](root, step, atlas))
    print(f"make_mixed_generate_fn over modes 7 and 9 (B={cfgs[0].batch_size}"
          f"), steps 0-7 "
          f"pick modes {picks}; each batch equals its ingredient's: "
          f"{mixed_ok}")
    if not mixed_ok or len(set(picks)) != 2:
        fail("the mixed stream disagrees with its ingredients")

    pcfg = prototxt.load_config(os.path.join(HERE, "examples",
                                             "train.prototxt"),
                                layout="nhwc", texture_dbases=())
    gen = flowgen_torch.Generator(pcfg, device=dev)
    out = gen.retrieve_batch()
    gen.stop()
    B, H, W = pcfg.batch_size, pcfg.height, pcfg.width
    shapes = {k: tuple(v.shape) for k, v in out.items()}
    print(f"examples/train.prototxt (mode {pcfg.mode}, B={B}, "
          f"{pcfg.channel_order}): one step, {json.dumps(shapes)}")
    if (shapes.get("image0") != (B, H, W, 3) or shapes.get("flow0") != (
            B, H, W, 2) or not bool(torch.isfinite(out["flow0"]).all())):
        fail("examples/train.prototxt's step is malformed")


def phase_trainer(card, dev):
    """Phase 20b: FlowNetS (width 32) trained on the port's batches, mode 7
    with photometric augmentation, 512x384, B=64: 10 fused generate-and-
    train steps with PyTorch's default TF32 setting for convolutions (on),
    every loss finite and the parameters moved; the generate step's and the
    train step's ms (host clock, synchronized), the fused loop's samples/s
    and the peak memory. Then the forward pass on one fixed batch with
    weights from a seed, on the card with TF32 off (scoped to the check)
    against the CPU's. Returns the kernel launches of the fused loop."""
    import dataclasses

    import flowgen_torch
    from flowgen_torch.pipeline.generator import generate_batch
    from flowgen_torch.random.streams import root_key
    from flowgen_torch.train import flownet

    cfg = flowgen_torch.DataGenConfig(mode=7, batch_size=64, seed=0,
                                      photometric_augment=True)
    atlas = procedural_atlas(cfg.height, cfg.width)
    root = root_key(cfg.seed, dev)
    torch.manual_seed(0)
    model = flownet.create_model(width=32).to(dev)
    opt = flownet.make_optimizer(model)
    before = [p.detach().clone() for p in model.parameters()]
    prev_tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True      # PyTorch's default
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    fused = flownet.make_generate_and_train_step(cfg, model, opt, dev)
    fused(root, 0, atlas)                       # warm-up: cuDNN's choices
    torch.cuda.synchronize()
    n = 10
    t0 = time.perf_counter()
    losses = [fused(root, s, atlas) for s in range(1, n + 1)]
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = read_counts()
    losses = torch.stack(losses).cpu()
    moved = sum(float((p.detach() - q).abs().max()) > 0
                for p, q in zip(model.parameters(), before))
    gen = flowgen_torch.make_generate_fn(cfg, dev)
    gen_ms = float(np.median([host_ms(lambda s=s: gen(root, s, atlas))[0]
                              for s in range(3)]))
    batch = gen(root, 0, atlas)
    step = flownet.make_train_step(model, opt)
    train_ms = float(np.median([host_ms(lambda: step(batch))[0]
                                for _ in range(3)]))
    torch.backends.cudnn.allow_tf32 = prev_tf32
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"FlowNetS (width 32) on mode 7 with photometric, "
          f"B={cfg.batch_size}, {cfg.width}x{cfg.height}, "
          f"TF32 convolutions on: losses {[round(float(x), 4) for x in losses]}"
          f"; {moved} of {len(before)} parameter tensors moved; generate "
          f"step {gen_ms:.2f} ms, train step {train_ms:.2f} ms (host clock, "
          f"synchronized, median of 3); fused loop {n * cfg.batch_size / dt:.1f}"
          f" samples/s ({1e3 * dt / n:.2f} ms a step over {n} steps); peak "
          f"memory {peak:.2f} GiB; kernel launches {json.dumps(counts)} "
          f"[{card}]")
    if not bool(torch.isfinite(losses).all()) or moved != len(before):
        fail("FlowNetS training: a loss is not finite or a parameter did not "
             "move")
    if counts["scene_render"] != n + 1 or counts["photometric"] != n + 1:
        fail(f"the trainer's batches did not go through the kernels: {counts}")
    del batch, gen, fused, opt

    # The forward pass, card against CPU, on weights from a seed.
    torch.manual_seed(1)
    ref = flownet.create_model(width=32)
    card_model = flownet.create_model(width=32).to(dev)
    card_model.load_state_dict(ref.state_dict())
    x = flownet.preprocess(generate_batch(
        cfg.seed, 0, atlas, dataclasses.replace(cfg, batch_size=2),
        device=dev))
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.no_grad():
            got = [t.cpu() for t in card_model(x)]
            want = ref(x.cpu())
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
    err = max(float((g - w).abs().max()) for g, w in zip(got, want))
    rel = max(float(((g - w).abs() / (1e-4 + w.abs())).max())
              for g, w in zip(got, want))
    ok = all(torch.allclose(g, w, rtol=1e-4, atol=1e-4)
             for g, w in zip(got, want))
    print(f"FlowNetS forward, card (TF32 off) vs CPU (2 samples of step 0, "
          f"width 32, weights from seed 1): max |d| {err:.3e}, max |d| / "
          f"(1e-4 + |want|) {rel:.3e}; tolerance |d| <= 1e-4 + 1e-4 |want|: "
          f"{ok}")
    if not ok:
        fail("FlowNetS forward on the card disagrees with the CPU's")
    return counts

def batch_bits_unequal(got, want) -> int:
    """Values of two batches (dicts of tensors) whose bits differ, over
    every key; a key in one only counts as a difference."""
    if set(got) != set(want):
        return 1
    n = 0
    for k, v in want.items():
        a = got[k].to(v.device)
        if v.dtype == torch.float32:
            n += bits_unequal(a, v)
        else:
            n += int((a != v).sum())
    return n


def add_counts(total, counts):
    for k, v in counts.items():
        total[k] = total.get(k, 0) + v
    return total


def sharded_generation(mesh, dev, cases, steps):
    """For each (label, cfg) of ``cases``: ``make_sharded_generate_fn`` over
    ``mesh`` against ``make_generate_fn``'s batch on ``dev`` over
    ``steps``, the rank's shard against its rows bit for bit. Every count
    is set to 0 just before each sharded step and read just after. Returns
    ({label: values with other bits}, the sharded steps' kernel
    launches)."""
    from flowgen_torch.pipeline.generator import make_generate_fn
    from flowgen_torch.pipeline.sharding import make_sharded_generate_fn

    n = mesh["data"].size()
    di = mesh.get_local_rank("data")
    out, counts = {}, {}
    for label, cfg in cases:
        atlas = procedural_atlas(cfg.height, cfg.width)
        sharded = make_sharded_generate_fn(cfg, mesh)
        single = make_generate_fn(cfg, dev)
        b = cfg.batch_size // n
        out[label] = 0
        for step in steps:
            reset_counts()
            got = {k: v.to_local() for k, v in
                   sharded(cfg.seed, step, atlas).items()}
            add_counts(counts, read_counts())
            want = {k: v[di * b:(di + 1) * b] for k, v in
                    single(cfg.seed, step, atlas).items()}
            out[label] += batch_bits_unequal(got, want)
    return out, counts


def _two_rank_worker(rank, store, out_dir):
    """One of phase 21's two ranks sharing the card: modes 7 and 9 at
    B=16 over steps 0-2, its shard against its rows of the single-process
    batch, and distribute_atlas of two 16-texture halves."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    import flowgen_torch
    from flowgen_torch.pipeline.sharding import distribute_atlas

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=2)
    try:
        mesh = init_device_mesh("cuda", (2,), mesh_dim_names=("data",))
        dev = torch.device("cuda", 0)
        cases = [(f"mode {m}", flowgen_torch.DataGenConfig(
            mode=m, batch_size=16, seed=0)) for m in (7, 9)]
        res = {"bits": sharded_generation(mesh, dev, cases, (0, 1, 2))[0]}
        atlas = procedural_atlas(384, 512)
        half = atlas.shape[0] // 2
        got = distribute_atlas(mesh, atlas[rank * half:(rank + 1) * half])
        res["atlas_equal"] = bool(np.array_equal(got.to_local().cpu().numpy(),
                                                 atlas))
        res["atlas_device"] = str(got.to_local().device)
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(res, f)
    finally:
        dist.destroy_process_group()


def flownet_step_bits(model, batch, step_fn):
    """One train step's loss and gradients: (loss, {name: full grad})."""
    loss = step_fn(batch)
    grads = {}
    for k, p in model.named_parameters():
        g = p.grad
        grads[k] = g.full_tensor() if hasattr(g, "full_tensor") else g
    return loss, grads


def phase_sharding(m7, card, dev):
    """Phase 21: generation over a DeviceMesh on the card. World size 1
    (one nccl rank, a "cuda" mesh ("data",)): the sharded batch in modes 7
    and 9 at B=64 over steps 0-2 (a bank epoch boundary) and windowed mode
    9 at B=16, each bit for bit against make_generate_fn's, with every
    kernel count at 0 before; Generator(cfg, mesh=mesh) timed in mode 7
    beside phase 3. Two ranks sharing the card (two spawned processes, a
    gloo group) in modes 7 and 9 at B=16, each shard against its rows of
    the single-process batch, and distribute_atlas of two 16-texture
    halves against the 32-texture atlas. FlowNetS (width 32) on a
    ("data", "model") = (1, 1) mesh: one sharded generate-and-train step
    with photometric augmentation against the unsharded step, loss and
    gradients bit for bit, with TF32 off and deterministic algorithms
    (the unsharded step run twice beside it).
    Returns the sharded path's kernel launches."""
    import dataclasses
    import tempfile

    import torch.distributed as dist
    import torch.multiprocessing as mp
    from torch.distributed.device_mesh import init_device_mesh

    import flowgen_torch
    from flowgen_torch.pipeline.generator import make_generate_fn
    from flowgen_torch.pipeline.sharding import make_sharded_generate_fn
    from flowgen_torch.random.streams import root_key
    from flowgen_torch.train import flownet

    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method=f"file://{tmp}/store",
                                rank=0, world_size=1)
        try:
            mesh = init_device_mesh("cuda", (1,), mesh_dim_names=("data",))
            cases = [(f"mode {m}", flowgen_torch.DataGenConfig(
                mode=m, batch_size=64, seed=0)) for m in (7, 9)]
            cases.append(("windowed mode 9", flowgen_torch.DataGenConfig(
                mode=9, batch_size=16, seed=0, render_impl="windowed")))
            bits, counts = sharded_generation(mesh, dev, cases, (0, 1, 2))
            print(f"sharded generation, world size 1 (nccl, \"cuda\" mesh "
                  f"(\"data\",)), steps 0-2, to_local() vs make_generate_fn, "
                  f"values with other bits: {json.dumps(bits)}; the sharded "
                  f"path's kernel launches {json.dumps(counts)}")
            if any(bits.values()):
                fail("a sharded batch differs from the single-device batch")

            cfg = cases[0][1]
            atlas = procedural_atlas(cfg.height, cfg.width)
            gen = flowgen_torch.Generator(cfg, atlas=atlas, mesh=mesh)
            for _ in range(2):
                gen.retrieve_batch()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            n = 5
            for _ in range(n):
                gen.retrieve_batch()
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            gen.stop()
            print(f"Generator(mode 7, B=64, mesh=mesh), world size 1: "
                  f"{1e3 * dt / n:.2f} ms/step, {cfg.batch_size * n / dt:.1f} "
                  f"samples/s over {n} timed steps; phase 3 without a mesh "
                  f"{m7['ms_per_step']:.2f} ms/step, "
                  f"{m7['samples_per_s']:.1f} samples/s [{card}]")

            # FlowNetS on a (1, 1) mesh against the unsharded step.
            mesh2 = init_device_mesh("cuda", (1, 1),
                                     mesh_dim_names=("data", "model"))
            fcfg = dataclasses.replace(cfg, photometric_augment=True)
            # Without deterministic algorithms the unsharded step does not
            # repeat itself: the bilinear upsample's backward adds with
            # atomics (about 10.8 million gradient values of width 32 at
            # B=64 differed between two runs on an H100).
            tf32 = (torch.backends.cuda.matmul.allow_tf32,
                    torch.backends.cudnn.allow_tf32,
                    torch.are_deterministic_algorithms_enabled(),
                    torch.is_deterministic_algorithms_warn_only_enabled())
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
            torch.use_deterministic_algorithms(True, warn_only=True)
            try:
                torch.manual_seed(2)
                ref = flownet.create_model(width=32)
                models = []
                for _ in range(3):
                    m = flownet.create_model(width=32)
                    m.load_state_dict(ref.state_dict())
                    models.append(m.to(dev))
                flownet.shard_model(models[2], mesh2)
                batch = make_generate_fn(fcfg, dev)(0, 0, atlas)
                plain = [flownet_step_bits(
                    m, batch, flownet.make_train_step(
                        m, flownet.make_optimizer(m))) for m in models[:2]]
                sm = models[2]
                fused = flownet.make_generate_and_train_step(
                    fcfg, sm, flownet.make_optimizer(sm), mesh=mesh2)
                reset_counts()
                sharded = flownet_step_bits(
                    sm, None, lambda _: fused(root_key(0, dev), 0, atlas))
                add_counts(counts, read_counts())
            finally:
                (torch.backends.cuda.matmul.allow_tf32,
                 torch.backends.cudnn.allow_tf32) = tf32[:2]
                torch.use_deterministic_algorithms(tf32[2], warn_only=tf32[3])

            def diff(a, b):
                return (bits_unequal(a[0].reshape(1), b[0].reshape(1)),
                        sum(bits_unequal(a[1][k], b[1][k]) for k in a[1]),
                        max(float((a[1][k] - b[1][k]).abs().max())
                            for k in a[1]))

            rerun = diff(plain[0], plain[1])
            shard = diff(sharded, plain[0])
            print(f"FlowNetS (width 32) on a (data, model) = (1, 1) mesh, mode "
                  f"7 with photometric, B=64, TF32 off, deterministic algorithms: "
                  f"loss {float(sharded[0]):.6f}; sharded vs unsharded step: "
                  f"loss values with other bits {shard[0]}, gradient values "
                  f"with other bits {shard[1]}, max |d| {shard[2]:.3e}; "
                  f"unsharded step run twice: {rerun[0]}, {rerun[1]}, "
                  f"{rerun[2]:.3e}")
            if shard[0] or shard[1]:
                fail("the sharded FlowNetS step differs from the unsharded "
                     "one")
        finally:
            dist.destroy_process_group()

        # Two ranks sharing the one card.
        t0 = time.perf_counter()
        mp.spawn(_two_rank_worker, args=(f"{tmp}/store2", tmp), nprocs=2,
                 join=True)
        for rank in (0, 1):
            with open(os.path.join(tmp, f"rank{rank}.json")) as f:
                r = json.load(f)
            print(f"two ranks sharing the card (gloo, \"cuda\" mesh), rank "
                  f"{rank}: shards vs its rows of the single-process batch "
                  f"(B=16, steps 0-2), values with other bits "
                  f"{json.dumps(r['bits'])}; distribute_atlas of two halves "
                  f"equals the 32-texture atlas: {r['atlas_equal']} (on "
                  f"{r['atlas_device']}); {time.perf_counter() - t0:.1f} s")
            if any(r["bits"].values()) or not r["atlas_equal"]:
                fail(f"rank {rank} of two on the card disagrees")
    return counts


def phase_modes(card, dev):
    """Phase 22: the modes no other phase holds on the card, through
    tools/torch_check_kernels.py at 512x384, B=4: the scene kernel against
    its plain version, both on the card (with inverse flow and ids; the
    JAX tool's gates are the bar, the bits are printed), and the fused
    renderer against the windowed one. Returns the largest difference
    between kernel and plain."""
    sys.path.insert(0, os.path.join(HERE, "tools"))
    import torch_check_kernels as ck

    worst = 0.0
    for mode in (1, 2, 3, 4, 5, 6, 8, 10, 12, 107, 109):
        kvp = ck.kernel_vs_plain(mode, dev)
        fvw = ck.fused_vs_windowed(mode, dev)
        print(f"mode {mode}: kernel vs plain {json.dumps(kvp)}; fused vs "
              f"windowed {json.dumps(fvw)}")
        if not (kvp["ok"] and fvw["ok"]):
            fail(f"mode {mode}: a check of phase 22 failed")
        worst = max(worst, kvp["flow_max"], kvp["img_max"])
    print(f"phase 22: modes 1-6, 8, 10, 12 and disparity_mode(7), "
          f"disparity_mode(9) pass [{card}]")
    return worst


COARSE_STRIDES = (1, 2, 4, 8)
COARSE_STEPS = (0, 4, 8, 20)


def coarse_case(args, kw, launches):
    """A coarse_gdisp_batch call's (stride, n_iter) and its launches, for
    record_launches."""
    from flowgen_torch.warpfields import compose

    stride = args[1] if len(args) > 1 else kw.get("stride", compose.COARSE)
    n_iter = (args[2] if len(args) > 2
              else kw.get("n_iter", compose.SOLVE_ITERS))
    return stride, n_iter, launches


def other_coarse_launches(cases):
    """The launches of the recorded coarse_gdisp_batch calls at any stride
    or step count but the bank's, and the calls by (stride, n_iter)."""
    from flowgen_torch.warpfields import compose

    bank = (compose.COARSE, compose.SOLVE_ITERS)
    calls = {}
    for stride, n_iter, _ in cases:
        k = f"{stride}/{n_iter}"
        calls[k] = calls.get(k, 0) + 1
    return sum(n for s, it, n in cases if (s, it) != bank), calls


def phase_coarse_strides(card, dev):
    """Phase 23: coarse_gdisp_batch at every lattice stride (1, 2, 4, 8)
    and fixed-point step count (0, 4, 8, 20) on the bank's own 8 fields of
    768^2 (bank epoch 0 at 512x384, the 16th half-lattice doubling) and of
    3072^2 (the full-size doubling at 1024x436), each against its plain
    version on the same card tensors bit for bit, timed by CUDA events
    (back to back, 10 calls) with its bytes bound and share; the bank's
    own case (stride 4, 8 steps) is among them. Then the keyed "pallas" big
    field (compose.make_big_field) at 384^2 on the card against the CPU,
    bit for bit. main() adds the main path's launches at these strides
    and step counts (phase 7's record). Returns the readings and the worst
    difference."""
    import flowgen_torch
    from flowgen_torch.random.streams import Stream, root_key, stream_key
    from flowgen_torch.warpfields import compose

    cfg = flowgen_torch.DataGenConfig(mode=9, batch_size=64, seed=0)
    shapes = (("768", lambda: bank_doubling_inputs(cfg, dev)[0]),
              ("3072", lambda: bank_doubling_inputs(sintel_cfg(mode=9),
                                                    dev)[1]))
    rows, worst, bits = {}, 0.0, 0
    for label, fields_of in shapes:
        D = fields_of().permute(0, 2, 3, 1)
        for stride in COARSE_STRIDES:
            for n_iter in COARSE_STEPS:
                call = functools.partial(compose.coarse_gdisp_batch, D,
                                         stride, n_iter)
                c0 = compose.coarse_gdisp_batch.launches
                k = call()
                launches = compose.coarse_gdisp_batch.launches - c0
                with compose.plain_versions():
                    p = call()
                err = float((k - p).abs().max())
                nb = bits_unequal(k, p)
                del k, p
                ms = event_ms(call)
                bound = 1e3 * coarse_bytes(D, stride) / PEAK_BYTES_S
                rows[f"{label}/s{stride}/n{n_iter}"] = r = {
                    "ms": ms, "bound_ms": bound, "share": bound / ms,
                    "kernels_a_call": launches, "max_abs_err": err,
                    "bits_differ": nb}
                worst, bits = max(worst, err), bits + nb
                print(f"coarse_gdisp_batch on 8 fields of {label}^2, stride "
                      f"{stride}, {n_iter} steps: {ms:.4f} ms (CUDA events, "
                      f"back to back), bound {bound:.4f} ms by bytes, share "
                      f"{r['share']:.3f}, {launches} kernels a call; vs "
                      f"plain max |d| {err}, {nb} values with other bits "
                      f"[{card}]", flush=True)
        del D
    key = stream_key(root_key(3), Stream.WARP_FIELD, 0)
    g = compose.make_big_field(key.to(dev), 384)
    c = compose.make_big_field(key, 384)
    big_bits = sum(bits_unequal(a.cpu(), b) for a, b in zip(g, c))
    print(f"keyed pallas big field (compose.make_big_field, 384^2), card vs "
          f"CPU: {big_bits} values with other bits (NaN included), "
          f"{int(torch.isnan(c[0]).sum())} flagged flow pixels")
    if worst != 0.0 or bits or big_bits:
        fail("coarse_gdisp_batch at other strides or step counts, or the "
             "keyed big field, differs from its plain version")
    return {"shapes": rows, "keyed_big_field_384_bits_differ": big_bits}, worst


def bench_cell(label, *args, **kwargs):
    """One bench_torch._bench_mode cell with every kernel count at 0
    before it; returns the cell and the launches it made."""
    import bench_torch

    reset_counts()
    cell = bench_torch._bench_mode(*args, device="cuda", **kwargs)
    counts = read_counts()
    if not (cell.rate > 0 and cell.spread >= 0):
        fail(f"bench_torch {label}: rate {cell.rate}, spread {cell.spread}")
    if any(counts[k] for k in WINDOW_KERNELS + ("affine_resample",
                                                  "photometric")):
        fail(f"bench_torch {label} launched kernels off its path: {counts}")
    return cell, counts


def phase_bench(m13, card):
    """Phase 24: bench_torch.py's mode-7 and mode-9 cells at B=64 in this
    process, their legacy-form lines, mode 9's per-step ms, the launches
    of each, and mode 13 with flow1 and masks after the cell's hygiene,
    its peak beside phase 10's."""
    import bench_torch

    atlas = procedural_atlas(384, 512)
    for mode, n_steps in ((7, 8), (9, 6)):
        cell, counts = bench_cell(f"mode {mode}", mode, 64, n_steps, atlas,
                                  pipelined=(mode == 9))
        dispatched = 1 + n_steps + (
            bench_torch.pipelined_steps(n_steps, 64) if mode == 9 else 0)
        built = counts["coarse_gdisp"] // 36
        if counts["scene_render"] != dispatched or (
                mode == 9 and (not built
                               or counts["coarse_gdisp"] != 36 * built
                               or counts["hwarp_rows"] != 34 * built
                               or counts["elementary_field"] != built)) or (
                mode == 7 and counts["coarse_gdisp"] + counts["hwarp_rows"]
                + counts["elementary_field"]):
            fail(f"bench_torch mode {mode}: kernel launches {counts} for "
                 f"{dispatched} steps")
        print(f"phase 24, bench_torch.py {mode} 64 ({n_steps} steps): "
              + json.dumps(bench_torch.legacy_payload(mode, cell, 64,
                                                      n_steps)))
        print(f"bench_torch mode {mode}, B=64: timed steps (ms, step order) "
              f"{[round(1e3 * t, 2) for t in cell.step_s]}, pipelined "
              + (f"{cell.pipelined:.2f} samples/s" if cell.pipelined
                 else "not run")
              + f", peak memory {cell.peak_gib:.2f} GiB, kernel launches "
              f"{json.dumps(counts)} for {dispatched} steps"
              + (f" ({built} bank builds through the kernels' wrappers: "
                 "eager, or captured in a CUDA graph)" if mode == 9 else "")
              + f" [{card}]", flush=True)
    cell, counts = bench_cell("mode 13", 13, 64, 6, atlas, cfg_kwargs={
        "compute_inverse_flow": True, "emit_masks": True})
    if counts["scene_render"] != 7:
        fail(f"bench_torch mode 13: kernel launches {counts} for 7 steps")
    print(f"bench_torch mode 13 with flow1 and masks, B=64 (phase 10's cell"
          f" after gc.collect and empty_cache): {cell.rate:.1f} samples/s, "
          f"peak memory {cell.peak_gib:.2f} GiB; phase 10's main path "
          f"{m13['peak_gib']:.2f} GiB with {m13['held_gib']:.2f} held at its "
          f"start [{card}]", flush=True)


def main():
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a GPU")
    import flowgen_torch
    from flowgen_torch.compose import fused
    from flowgen_torch.ops import _build
    from flowgen_torch.warpfields import generator as wg

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    name = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__}")
    print(f"cuda {torch.version.cuda}")
    print(card)

    # ---- 1: build, one nvcc per source and g++ for the loader, at once ----
    from flowgen_torch.texture_io import native

    t0 = time.time()
    loader = native.start_build()
    _build.build_all()
    native.finish_build(loader)
    print(f"build: {time.time() - t0:.1f} s for {len(_build.LIBRARIES)} "
          f"CUDA libraries and the texture loader [{card}]")
    for lib, info in _build.BUILD_INFO.items():
        print(f"  {lib}: nvcc {info['seconds']:.1f} s")
        for ln in ptxas_summary(info["log"]):
            print(f"    {ln}")
    print(f"  texture loader: g++ {native.BUILD_INFO['seconds']:.1f} s")

    stamp("build done")
    # ---- 2-4: mode 7 ----
    m7 = phase_mode7(card, dev)

    stamp("phases 2-4 (mode 7) done")
    # ---- 5: bank kernels vs plain ----
    cfg = flowgen_torch.DataGenConfig(mode=9, batch_size=64, seed=0)
    atlas = procedural_atlas(cfg.height, cfg.width)
    bank = phase_bank(cfg, dev)

    # ---- 6: mode-9 scene kernel vs plain ----
    s0, plain9, worst9, slabs = phase_mode9_scene(cfg, atlas, bank["aux"],
                                                  card, dev)

    # ---- 7: the mode-9 main path ----
    from flowgen_torch.warpfields import compose

    coarse_cases, restore = record_launches(compose, "coarse_gdisp_batch",
                                            coarse_case)
    try:
        first, res = run_main_path(cfg, atlas, card, prof_steps=2)
    finally:
        restore()
    other_launches, coarse_calls = other_coarse_launches(coarse_cases)
    print(f"mode 9 main path coarse_gdisp_batch calls by (stride, n_iter): "
          f"{json.dumps(coarse_calls)}; launches at other strides or step "
          f"counts than the bank's (4, 8): {other_launches}")
    if sum(n for _, _, n in coarse_cases) != res["launches"]["coarse_gdisp"]:
        fail("the recorded coarse_gdisp_batch launches disagree with the "
             "counter")
    del coarse_cases
    g = gates({k: v[s0 : s0 + 4] for k, v in first.items()}, plain9)
    print(f"mode 9 main path step 0 vs plain (samples {s0}-{s0 + 3}): "
          + json.dumps(g, sort_keys=True))
    if not g["ok"]:
        fail("mode 9 main path output disagrees with the plain render")
    del first
    counts = res["launches"]
    built = counts["coarse_gdisp"] // 36
    if not all(counts[k] for k in FUSED_KERNELS) or (
            counts["coarse_gdisp"] != 36 * built) or (
            counts["hwarp_rows"] != 34 * built) or (
            counts["elementary_field"] != built):
        fail(f"the mode-9 path's kernel launches are off: {counts}")
    print(f"mode 9 bank epochs built: {built} (36 coarse_gdisp launches, "
          f"its two kernels in each of 18 calls, 34 hwarp_rows and 1 "
          f"elementary_field) for "
          f"{res['dispatched']} steps dispatched, "
          f"{cfg.warp_bank_reuse_steps} steps an epoch")
    layers = layer_breakdown(cfg, slabs, dev)
    print("mode 9 layers (ms per step, host clock, synchronized): "
          + json.dumps({k: round(v, 3) for k, v in layers.items()})
          + f" [{card}]")

    # ---- 8: per-kernel timing at the main path's shapes ----
    idx = torch.arange(cfg.batch_size)
    scenes = sample(cfg, cfg.seed, idx, dev, wg.bank_size(cfg))
    args, opts = fused.scene_tables(scenes, cfg, *slabs, bank["aux"])
    t = phase_scene_timing("mode 9", args, opts, card)
    m9 = {"launches": counts["scene_render"], **t,
          "max_abs_err": max(worst9, g["max_abs_err"], t["max_abs_err"])}
    f3072 = bank_doubling_inputs(sintel_cfg(mode=9), dev)[1]
    bt = phase_bank_timing((("768", bank["f768"]), ("1536", bank["f1536"]),
                            ("3072", f3072)), card)
    del f3072
    h768, h1536 = bt["768"]["hwarp"], bt["1536"]["hwarp"]
    h_epoch = epoch_hwarp(cfg, dev, card)
    c768, c1536, c3072 = (bt[k]["coarse"] for k in ("768", "1536", "3072"))
    c_epoch = phase_coarse_epoch(cfg, dev, card)
    bank_err = bank["max_abs_err"]
    del bank, slabs, args

    stamp("phases 5-8 (mode 9) done")
    # ---- 9-11: modes 13 and 11, the mode-13 main path ----
    m13 = phase_mode13(card, dev)

    stamp("phases 9-11 (modes 13, 11) done")
    # ---- 12-15: the windowed renderer at MPI-Sintel's 1024x436 ----
    win_rows, sintel_bank_err = phase_windowed(card, dev)

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
            "calls": counts["coarse_gdisp"] // 2,
            "max_abs_err": max(bank_err, sintel_bank_err,
                               c768["max_abs_err"], c1536["max_abs_err"],
                               c3072["max_abs_err"], c_epoch["max_abs_err"]),
            "ms": c768["ms"], "plain_ms": c768["plain_ms"],
            "bound_ms": c768["bound_ms"], "bound_by": "bytes",
            "library_ms": None,
            "shape": "coarse_gdisp_batch whole (coarse_solve_kernel and "
                     "upsample4_kernel, both counted in launches) on 8 "
                     "fields of 768^2 (16 of the 18 calls of an epoch)",
            "at_1536": c1536, "at_3072": c3072, "epoch": c_epoch,
        },
        {
            "name": "hwarp_rows", "route": "cuda",
            "source": "flowgen_torch/csrc/fields.cu",
            "replaces": "flowgen/warpfields/pallas_fields.py:174",
            "launches": counts["hwarp_rows"],
            "max_abs_err": max(bank_err, sintel_bank_err,
                               h768["max_abs_err"], h1536["max_abs_err"],
                               h_epoch["max_abs_err"]),
            "ms": h768["ms"], "plain_ms": h768["plain_ms"],
            "bound_ms": h768["bound_ms"], "bound_by": "bytes",
            "library_ms": h768["library_ms"],
            "shape": "12288 x 768 rows (32 of the 34 launches of an epoch)",
            "at_1536": h1536, "epoch": h_epoch,
        },
    ] + win_rows
    stamp("phases 12-15 (windowed) done")
    # ---- 16: photometric augmentation ----
    rows.append(phase_photometric(card, dev))
    stamp("phase 16 (photometric) done")
    # ---- 17: texture databases ----
    scene_err, window_err = phase_texture_db(card, dev)
    by_name = {r["name"]: r for r in rows}
    by_name["scene_render"]["max_abs_err"] = max(
        by_name["scene_render"]["max_abs_err"], scene_err)
    by_name["object_window"]["max_abs_err"] = max(
        by_name["object_window"]["max_abs_err"], window_err)
    stamp("phase 17 (TextureDB) done")
    # ---- 18: mode 9 with the "xla" bank stream ----
    x9 = phase_mode9_xla(res, card, dev)
    by_name["scene_render"]["max_abs_err"] = max(
        by_name["scene_render"]["max_abs_err"], x9["max_abs_err"])
    by_name["scene_render"]["mode9_xla"] = {
        k: x9[k] for k in ("launches", "ms_per_step", "samples_per_s")}
    by_name["coarse_gdisp"]["xla_stream"] = {
        "launches": 0, "bank_epoch_ms": x9["bank_epoch_ms"],
        "note": "no kernel: plain PyTorch, as XLA in the JAX package"}
    stamp("phase 18 (mode 9 xla) done")
    # ---- 19: the windowed renderer with the "xla" bank stream ----
    wx_err, wx_counts = phase_windowed_xla(dev)
    for k in WINDOW_KERNELS:
        by_name[k]["max_abs_err"] = max(by_name[k]["max_abs_err"], wx_err)
        by_name[k]["windowed_mode9_xla_launches"] = wx_counts[k]
    stamp("phase 19 (windowed mode 9 xla) done")
    # ---- 20: the public API, the adapters and the trainer ----
    phase_api(card, dev)
    tr_counts = phase_trainer(card, dev)
    by_name["photometric"]["trainer_launches"] = tr_counts["photometric"]
    by_name["scene_render"]["trainer_launches"] = tr_counts["scene_render"]
    stamp("phase 20 (API, adapters, FlowNetS) done")
    # ---- 21: generation and FlowNetS over a DeviceMesh ----
    sh_counts = phase_sharding(m7, card, dev)
    for r in rows:
        r["sharded_launches"] = sh_counts[r["name"]]
    stamp("phase 21 (sharding) done")
    # ---- 22: the modes no other phase holds on the card ----
    by_name["scene_render"]["max_abs_err"] = max(
        by_name["scene_render"]["max_abs_err"], phase_modes(card, dev))
    stamp("phase 22 (modes 1-6, 8, 10, 12, disparity) done")
    # ---- 23: coarse_gdisp_batch at every stride and step count ----
    strides, c_err = phase_coarse_strides(card, dev)
    strides["launches"] = other_launches
    strides["main_path_calls"] = coarse_calls
    by_name["coarse_gdisp"]["strides"] = strides
    by_name["coarse_gdisp"]["max_abs_err"] = max(
        by_name["coarse_gdisp"]["max_abs_err"], c_err)
    stamp("phase 23 (coarse_gdisp strides and steps) done")
    # ---- 24: bench_torch.py's cells ----
    phase_bench(m13, card)
    stamp("phase 24 (bench_torch.py cells) done")
    # ---- 25: the elementary field's kernel ----
    ef = phase_elementary_field(card, dev)
    ef["launches"] = counts["elementary_field"]
    ef["sharded_launches"] = sh_counts["elementary_field"]
    rows.append(ef)
    stamp("phase 25 (elementary field) done")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if sys.argv[1:] == ["--coarse-kernel-counts"]:
        if not torch.cuda.is_available():
            fail("torch.cuda.is_available() is false: this count needs a GPU")
        import flowgen_torch

        print(json.dumps(coarse_kernel_counts(
            flowgen_torch.DataGenConfig(mode=9, batch_size=64, seed=0),
            torch.device("cuda"))))
    else:
        main()
