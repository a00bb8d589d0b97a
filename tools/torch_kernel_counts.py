#!/usr/bin/env python3
"""Work a main-path step launches, per tree: torch.profiler over 3
``Generator`` steps after 2 warm-up steps, in a fresh process for each
(tree, mode), trees in the order given (parent, change, change, parent
puts each tree first once).

    python3 tools/torch_kernel_counts.py [--cpu] ROOT [ROOT ...]

Each ROOT is a checkout whose own ``flowgen_torch`` is imported. Modes 13
(``flow1`` and masks) and 7 at 512x384, B=64 on the CUDA card; with
``--cpu``, B=2 on the CPU (the kernels' plain versions: 0 CUDA kernels).
Without a card and without ``--cpu`` it exits non-zero. Prints one JSON
line per (tree, mode): CUDA kernels a step and torch ops a step.
"""

import json
import os
import subprocess
import sys


def one(root: str, mode: int, cpu: bool = False):
    sys.path.insert(0, os.path.abspath(root))
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import flowgen_torch
    from flowgen_torch.pipeline.generator import Generator

    cuda = not cpu
    if cuda and not torch.cuda.is_available():
        sys.exit("torch.cuda.is_available() is false: this count needs a "
                 "GPU (pass --cpu to count the plain versions' torch ops)")
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
    # Not the program's spans (utils/profiling.py:span): they launch nothing.
    events = [e for e in prof.key_averages() if not e.is_user_annotation]
    print(json.dumps({
        "root": root, "mode": mode,
        "cuda_kernels_per_step": sum(e.count for e in events
                                     if e.device_type == DeviceType.CUDA) / 3,
        "torch_ops_per_step": sum(e.count for e in events
                                  if e.device_type == DeviceType.CPU) / 3,
    }), flush=True)


if __name__ == "__main__":
    args = sys.argv[1:]
    cpu = "--cpu" in args
    args = [a for a in args if a != "--cpu"]
    if args[:1] == ["--one"]:
        one(args[1], int(args[2]), cpu)
    else:
        for mode in (13, 7):
            for root in args:
                subprocess.run([sys.executable, os.path.abspath(__file__),
                                "--one", root, str(mode)]
                               + (["--cpu"] if cpu else []), check=True)
