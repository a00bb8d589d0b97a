#!/usr/bin/env python3
"""Time ``coarse_gdisp_batch`` of a checkout of the PyTorch port on one GPU.

    python3 tools/torch_coarse_gdisp_timing.py [ROOT] [--breakdown]

ROOT (default: this repository) is the checkout whose ``flowgen_torch`` is
timed, so two trees (a parent unpacked with ``git archive`` and this one)
can be compared in one call, in turns. The measurements are
``chip_smoke.py``'s own helpers, applied to ROOT's modules: the whole call
(``coarse_whole``: CUDA events back to back and with a cold L2, the plain
version, the bytes bound) on 8 fields of 768^2 and 1536^2 (bank epoch 0 of
mode 9 at 512x384, its 16th half-lattice doubling and its full-size
doubling), of 3072^2 (the same at MPI-Sintel's 1024x436) and of 4608^2
(at 1536x864, past the 4096 px that the solve holds in registers);
torch.profiler's count of CUDA kernels in one call and in one bank epoch
at 512x384 (``coarse_kernel_counts``, first in the process, where the
profiler counts the ctypes kernels reliably); and every call of that epoch
against its plain version, timed alone with a cold L2 (``epoch_coarse``).
``--breakdown`` (this repository's tree only) splits the time into the
solve with 0, 1 and SOLVE_ITERS fixed-point steps, the upsample, and an
empty kernel's launch.
Prints one JSON line, after the card's name and power limit; exits
non-zero if any call differs from its plain version.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

import chip_smoke as cs  # noqa: E402  (adds this repository to sys.path)
import torch  # noqa: E402


def _breakdown(compose, fields):
    """Per size: the solve kernel alone with 0, 1 and SOLVE_ITERS
    fixed-point steps (the differences are the cost of the steps), the
    upsample kernel alone, and an empty kernel's launch."""
    from flowgen_torch.ops._build import load_fields_library

    lib = load_fields_library()
    out = {"noop_ms": cs.event_ms(
        lambda: lib.flowgen_noop(compose._stream(fields[0][1])))}
    for label, f in fields:
        D = f.permute(0, 2, 3, 1)
        N, Hd, Wd, _ = D.shape
        Hc, Wc = Hd // compose.COARSE, Wd // compose.COARSE
        gd = torch.empty((N, Hc, Wc), dtype=torch.float32, device=f.device)
        fine = torch.empty((N, Hd, Wd), dtype=torch.float32, device=f.device)

        def solve(n_iter):
            err = lib.flowgen_coarse_solve(
                compose._ptr(D), *D.stride(), compose.COARSE,
                compose._ptr(gd), compose._ptr(fine), fine.numel(), N, Hc,
                Wc, n_iter, compose.COARSE_SCAN, compose._stream(D))
            if err:
                cs.fail(f"coarse solve launch failed: CUDA error {err}")

        row = {f"solve_{k}_steps_ms": cs.event_ms(lambda: solve(k))
               for k in (0, 1, compose.SOLVE_ITERS)}
        row["upsample_ms"] = cs.event_ms(lambda: lib.flowgen_upsample4(
            compose._ptr(gd), compose._ptr(fine), N, Hc, Wc,
            compose._stream(D)))
        out[label] = row
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("root", nargs="?", default=HERE)
    ap.add_argument("--breakdown", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        cs.fail("no CUDA device: this timing needs a GPU")
    root = os.path.abspath(args.root)
    if args.breakdown and root != HERE:
        cs.fail("--breakdown calls this tree's kernels: time ROOT without it")
    sys.path.insert(0, root)
    import flowgen_torch
    from flowgen_torch.warpfields import compose

    if not os.path.abspath(flowgen_torch.__file__).startswith(root):
        cs.fail(f"flowgen_torch came from {flowgen_torch.__file__}, not {root}")
    card = cs.card_line()
    print(card)
    dev = torch.device("cuda")
    t0 = time.time()
    cfg = flowgen_torch.DataGenConfig(mode=9, batch_size=64, seed=0)
    f768, f1536 = cs.bank_doubling_inputs(cfg, dev)
    _, f3072 = cs.bank_doubling_inputs(cs.sintel_cfg(mode=9), dev)
    fields = [("768", f768), ("1536", f1536), ("3072", f3072)]
    res = {"root": root, "card": card, "whole": {}}
    for label, f in fields:
        res["whole"][label] = cs.coarse_whole(f.permute(0, 2, 3, 1))
        print(f"{label}^2 x 8: " + json.dumps(res["whole"][label]), flush=True)
    res["cuda_kernels"] = cs.coarse_kernel_counts(cfg, dev)
    res["epoch"] = cs.epoch_coarse(cfg, dev)
    if args.breakdown:
        res["breakdown"] = _breakdown(compose, fields)
        print("breakdown: " + json.dumps(res["breakdown"]), flush=True)
    del f768, f1536, f3072, fields
    wide_cfg = flowgen_torch.DataGenConfig(mode=9, batch_size=64, seed=0,
                                           width=1536, height=864)
    f4608 = cs.bank_doubling_inputs(wide_cfg, dev)[1]
    res["whole"]["4608"] = cs.coarse_whole(f4608.permute(0, 2, 3, 1))
    print("4608^2 x 8: " + json.dumps(res["whole"]["4608"]), flush=True)
    res["seconds"] = time.time() - t0
    print(json.dumps(res))
    checked = list(res["whole"].values()) + [res["epoch"]]
    if any(r["bits_differ"] or r["max_abs_err"] != 0.0 for r in checked):
        cs.fail("coarse_gdisp_batch differs from its plain version")


if __name__ == "__main__":
    main()
