#!/usr/bin/env python3
"""Standalone dataset generator on the PyTorch/CUDA port (the twin of
``examples/generate.py``).

Generates N samples with ``flowgen_torch.Generator`` and saves each as
``{idx}-0.ppm``, ``{idx}-1.ppm`` and ``{idx}-flow.flo`` (plus an optional
.pfm and a flow visualization PNG), printing the samples/s of the run.

Usage:
    python examples/torch_generate.py --mode 7 --n 16 --out /tmp/flowgen-out \
        [--texture-db /path/to/database.txt] [--seed 0] [--pfm] [--viz] \
        [--device cuda]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import flowgen_torch  # noqa: E402
from flowgen_torch.utils import flow_io  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", type=int, default=7)
    ap.add_argument("--n", type=int, default=8)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--out", default="/tmp/flowgen-out")
    ap.add_argument("--texture-db", default=None, action="append")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--pfm", action="store_true", help="also save flow as .pfm")
    ap.add_argument("--viz", action="store_true", help="save flow color PNGs")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    args = ap.parse_args()

    os.makedirs(args.out, exist_ok=True)
    cfg = flowgen_torch.DataGenConfig(
        mode=args.mode,
        batch_size=args.batch,
        seed=args.seed,
        texture_dbases=tuple(args.texture_db) if args.texture_db else (),
    )
    gen = flowgen_torch.Generator(cfg, as_numpy=True, device=args.device)
    gen.start()

    idx = 0
    while idx < args.n:
        batch = gen.retrieve_batch()
        for b in range(cfg.batch_size):
            if idx >= args.n:
                break
            stem = os.path.join(args.out, f"{idx:05d}")
            flow_io.write_ppm(stem + "-0.ppm", batch["image0"][b])
            flow_io.write_ppm(stem + "-1.ppm", batch["image1"][b])
            flow_io.write_flo(stem + "-flow.flo", batch["flow0"][b])
            if args.pfm:
                flow_io.write_pfm(stem + "-flow.pfm", batch["flow0"][b])
            if args.viz:
                from PIL import Image

                Image.fromarray(
                    flow_io.flow_to_color(batch["flow0"][b])
                ).save(stem + "-flow.png")
            idx += 1
        print(f"saved {idx}/{args.n} ({gen.meter.samples_per_sec:.1f} "
              f"samples/s on {gen.device})")
    gen.stop()


if __name__ == "__main__":
    main()
