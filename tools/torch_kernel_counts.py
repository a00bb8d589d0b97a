#!/usr/bin/env python3
"""Work a main-path step launches, per tree: torch.profiler over 3
``Generator`` steps after 2 warm-up steps, in a fresh process for each
(tree, mode), trees in the order given (parent, change, change, parent
puts each tree first once).

    python3 tools/torch_kernel_counts.py ROOT [ROOT ...]

Each ROOT is a checkout whose own ``flowgen_torch`` is imported. Modes 13
(``flow1`` and masks) and 7 at 512x384, B=64 on a CUDA card, B=2 on the
CPU. Prints one JSON line per (tree, mode): CUDA kernels a step (0 on the
CPU) and torch ops a step.
"""

import json
import os
import subprocess
import sys


def one(root: str, mode: int):
    sys.path.insert(0, os.path.abspath(root))
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import flowgen_torch
    from flowgen_torch.pipeline.generator import Generator

    cuda = torch.cuda.is_available()
    if cuda:
        from flowgen_torch.ops import _build

        _build.build_all()
    kw = dict(compute_inverse_flow=True, emit_masks=True) if mode == 13 else {}
    cfg = flowgen_torch.DataGenConfig(mode=mode, batch_size=64 if cuda else 2,
                                      seed=0, **kw)
    gen = Generator(cfg, device="cuda" if cuda else "cpu")
    gen.retrieve_batch()
    gen.retrieve_batch()
    acts = [ProfilerActivity.CPU]
    if cuda:
        torch.cuda.synchronize()
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        for _ in range(3):
            gen.retrieve_batch()
        if cuda:
            torch.cuda.synchronize()
    gen.stop()
    events = prof.key_averages()
    print(json.dumps({
        "root": root, "mode": mode,
        "cuda_kernels_per_step": sum(e.count for e in events
                                     if e.device_type == DeviceType.CUDA) / 3,
        "torch_ops_per_step": sum(e.count for e in events
                                  if e.device_type == DeviceType.CPU) / 3,
    }), flush=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--one"]:
        one(sys.argv[2], int(sys.argv[3]))
    else:
        for mode in (13, 7):
            for root in sys.argv[1:]:
                subprocess.run([sys.executable, os.path.abspath(__file__),
                                "--one", root, str(mode)], check=True)
