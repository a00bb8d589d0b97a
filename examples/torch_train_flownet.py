#!/usr/bin/env python3
"""Train FlowNetS on batches the PyTorch/CUDA port generates on the same
card (the twin of ``examples/train_flownet.py``): each step generates a
batch and takes one Adam update on it, on one device and stream, so no
sample passes through the host.

Usage:
    python examples/torch_train_flownet.py --mode 7 --batch 8 --steps 100 \
        [--device cuda]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import torch  # noqa: E402

import flowgen_torch  # noqa: E402
from flowgen_torch.pipeline.generator import resolve_device  # noqa: E402
from flowgen_torch.random.streams import root_key  # noqa: E402
from flowgen_torch.train import flownet  # noqa: E402
from flowgen_torch.utils.profiling import (  # noqa: E402
    ThroughputMeter,
    force_sync,
)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", type=int, default=7)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--width", type=int, default=512)
    ap.add_argument("--height", type=int, default=384)
    ap.add_argument("--model-width", type=int, default=24)
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--texture-db", default=None, action="append")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    args = ap.parse_args()

    dev = resolve_device(args.device)
    cfg = flowgen_torch.DataGenConfig(
        mode=args.mode,
        batch_size=args.batch,
        width=args.width,
        height=args.height,
        seed=args.seed,
        texture_dbases=tuple(args.texture_db) if args.texture_db else (),
    )
    atlas = flowgen_torch.atlas_for_config(cfg)

    torch.manual_seed(args.seed)
    model = flownet.create_model(width=args.model_width).to(dev)
    opt = flownet.make_optimizer(model, args.lr)
    fused = flownet.make_generate_and_train_step(cfg, model, opt, dev)

    root = root_key(cfg.seed, dev)
    meter = ThroughputMeter()
    for step in range(args.steps):
        loss = fused(root, step, atlas)
        if step % 10 == 0 or step == args.steps - 1:
            lv = force_sync(loss)
            meter.tick(10 * cfg.batch_size if step else cfg.batch_size)
            print(
                f"step {step:5d}  loss {lv:8.4f}  "
                f"{meter.samples_per_sec:7.1f} samples/s"
            )
    print("done")


if __name__ == "__main__":
    main()
