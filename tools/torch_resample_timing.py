#!/usr/bin/env python3
"""Time the standalone ``affine_resample`` of a checkout of the PyTorch port
on one GPU.

    python3 tools/torch_resample_timing.py [ROOT]

ROOT (default: this repository) is the checkout whose ``flowgen_torch`` is
timed, so two trees (a parent unpacked with ``git archive`` and this one)
can be compared in one call, in turns: run the script once a tree, in the
order parent, this, this, parent. The measurement is ``chip_smoke.py``'s
own ``resample_timing`` applied to ROOT's modules: at each of
``resample_cases`` (a 192x256 window of a 512x384 texture, whole 384x512
and 436x1024 frames from 2H x 2W sources) with the default bands, the
kernel by CUDA events, the whole call by host clock, an empty kernel's
launch, the plain version and its difference, the bytes bound; and, where
this process compiled it, ptxas's summary of the resample library.
Prints the card's name and power limit, one line a shape, then one JSON
line; exits non-zero if the kernel differs from its plain version.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

import chip_smoke as cs  # noqa: E402  (adds this repository to sys.path)
import torch  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("root", nargs="?", default=HERE)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        cs.fail("no CUDA device: this timing needs a GPU")
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import flowgen_torch

    if not os.path.abspath(flowgen_torch.__file__).startswith(root):
        cs.fail(f"flowgen_torch came from {flowgen_torch.__file__}, not {root}")
    card = cs.card_line()
    print(card)
    rows = cs.resample_timing(card, torch.device("cuda"))
    from flowgen_torch.ops import _build

    for ln in cs.ptxas_summary(
            _build.BUILD_INFO.get("flowgen_resample", {}).get("log", "")):
        print(f"  {ln}")
    print(json.dumps({"root": root, "card": card, "shapes": rows}))


if __name__ == "__main__":
    main()
