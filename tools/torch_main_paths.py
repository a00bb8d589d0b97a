#!/usr/bin/env python3
"""Time the port's main paths end to end on the card, trees and cells in
alternating turns.

    python3 tools/torch_main_paths.py [--turns N] [--steps S]
                                      [--cell NAME ...] ROOT [ROOT ...]

Each ROOT is a checkout of the repository (the parent unpacked with ``git
archive`` into a git-ignored directory, this tree as ``.``). For every
(ROOT, cell) pair, an arm, one worker process imports that ROOT's own
``flowgen_torch``, builds its kernels and keeps a ``Generator`` (B=64,
seed 0, the procedural atlas of ROOT's ``chip_smoke.py``) warm. The
workers then take N turns each, in the order of the arms on even turns and
the reverse on odd ones (A B, B A, ...), one worker running at a time: a
turn retrieves the ``prefetch`` steps the worker's pipeline finished while
it waited, untimed, then times S more ``Generator.retrieve_batch`` calls
on the host clock, ended by ``torch.cuda.synchronize()``. Every arm has
taken the same steps when a turn starts, so in mode 9 (S + prefetch even)
each turn covers the same part of a bank epoch. Drift of the host or the
card over the call then falls on every arm alike.

Cells (``--cell``, default the five main paths): "mode 7", "mode 9",
"mode 13" (with ``flow1`` and the masks) at 512x384; "Sintel mode 7",
"Sintel mode 9" at MPI-Sintel's 1024x436 (the windowed renderer); and
"mode 7 photometric" (``photometric_augment``, for trees that have it).

Prints one JSON line a turn and arm, then one summary line an arm (every
turn's ms/step, median, min, max, peak memory) and, for each arm after the
first, the turn-by-turn ratio of its ms/step to the first arm's (median,
min, max), each with the card's name and power limit. The workers read
nothing outside their ROOT and are stopped before the script exits.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

CELLS = {
    "mode 7": dict(mode=7),
    "mode 9": dict(mode=9),
    "mode 13": dict(mode=13, compute_inverse_flow=True, emit_masks=True),
    "Sintel mode 7": dict(mode=7, height=436, width=1024),
    "Sintel mode 9": dict(mode=9, height=436, width=1024),
    "mode 7 photometric": dict(mode=7, photometric_augment=True),
}
MAIN_PATHS = ("mode 7", "mode 9", "mode 13", "Sintel mode 7", "Sintel mode 9")
TAG = "@@ "


def say(obj):
    print(TAG + json.dumps(obj), flush=True)


def worker(root, cell, steps):
    """One arm: ROOT's Generator for ``cell``, a timed turn per "turn" line
    on standard input, stopped by any other line or its end."""
    sys.path.insert(0, root)
    import torch

    import chip_smoke as cs  # ROOT's own
    import flowgen_torch
    from flowgen_torch.ops import _build
    from flowgen_torch.pipeline.generator import Generator

    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is false: this timing needs a GPU")
    _build.build_all()
    cfg = flowgen_torch.DataGenConfig(batch_size=64, seed=0, **CELLS[cell])
    if (steps + cfg.prefetch) % max(cfg.warp_bank_reuse_steps, 1):
        cs.fail(f"{steps} timed steps and {cfg.prefetch} in flight split a "
                f"bank epoch of {cfg.warp_bank_reuse_steps} steps")
    torch.cuda.reset_peak_memory_stats()
    gen = Generator(cfg, atlas=cs.procedural_atlas(cfg.height, cfg.width),
                    device="cuda")
    for _ in range(2 * cfg.warp_bank_reuse_steps):
        gen.retrieve_batch()
    torch.cuda.synchronize()
    say({"ready": True})
    for line in sys.stdin:
        if line.strip() != "turn":
            break
        for _ in range(cfg.prefetch):
            gen.retrieve_batch()
        t0 = time.perf_counter()
        for _ in range(steps):
            gen.retrieve_batch()
        torch.cuda.synchronize()
        say({"ms_per_step": 1e3 * (time.perf_counter() - t0) / steps,
             "peak_gib": torch.cuda.max_memory_allocated() / 2**30})
    gen.stop()


def read_tagged(proc):
    """The worker's next protocol line; other output goes to stderr."""
    for line in proc.stdout:
        if line.startswith(TAG):
            return json.loads(line[len(TAG):])
        sys.stderr.write(line)
    raise RuntimeError(f"worker {proc.args[3:5]} ended (rc {proc.wait()})")


def card_line():
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    return r.stdout.strip().splitlines()[0] if r.returncode == 0 else None


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("roots", nargs="+")
    ap.add_argument("--cell", action="append", choices=sorted(CELLS))
    ap.add_argument("--turns", type=int, default=10)
    ap.add_argument("--steps", type=int, default=4)
    args = ap.parse_args()
    card = card_line()
    if card is None:
        sys.exit("nvidia-smi failed: this timing needs a GPU")
    arms = [(os.path.abspath(r), c) for c in (args.cell or MAIN_PATHS)
            for r in args.roots]
    procs = []
    try:
        for root, cell in arms:
            t0 = time.perf_counter()
            p = subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--worker", root,
                 cell, str(args.steps)],
                stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True,
                cwd=root)
            procs.append(p)
            read_tagged(p)
            print(json.dumps({"tree": root, "cell": cell, "ready_s":
                              time.perf_counter() - t0}), flush=True)
        runs = [[] for _ in arms]
        peak = [0.0 for _ in arms]
        for turn in range(args.turns):
            order = range(len(arms)) if turn % 2 == 0 else reversed(
                range(len(arms)))
            for i in order:
                procs[i].stdin.write("turn\n")
                procs[i].stdin.flush()
                r = read_tagged(procs[i])
                runs[i].append(r["ms_per_step"])
                peak[i] = r["peak_gib"]
                print(json.dumps({"turn": turn, "tree": arms[i][0],
                                  "cell": arms[i][1],
                                  "ms_per_step": r["ms_per_step"]}),
                      flush=True)
    finally:
        for p in procs:
            if p.poll() is None:
                try:
                    p.stdin.write("quit\n")
                    p.stdin.flush()
                    p.wait(timeout=120)
                except (OSError, subprocess.TimeoutExpired):
                    p.kill()
                    p.wait()
    for i, (root, cell) in enumerate(arms):
        print(json.dumps({
            "tree": root, "cell": cell, "steps_per_turn": args.steps,
            "ms_per_step": runs[i], "median": statistics.median(runs[i]),
            "min": min(runs[i]), "max": max(runs[i]), "peak_gib": peak[i],
            "card": card}), flush=True)
    for i in range(1, len(arms)):
        ratio = [b / a for a, b in zip(runs[0], runs[i])]
        print(json.dumps({
            "arm": list(arms[i]), "against": list(arms[0]),
            "ratio_per_turn": ratio, "median": statistics.median(ratio),
            "min": min(ratio), "max": max(ratio), "card": card}), flush=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--worker"]:
        worker(sys.argv[2], sys.argv[3], int(sys.argv[4]))
    else:
        main()
