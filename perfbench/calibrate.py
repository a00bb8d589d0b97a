"""The readings that a cell's limits are set from, on the card, at the
cell's own size, in one process:

    python3 perfbench/calibrate.py --workload CELL --seeds 101-112 \\
        --control-seeds 201-203 [--seconds 3]

For each of ``--seeds``: a run of the cell (``run.run_cell``) with a short
window, whose compared numbers are the program's (the lower readings).
For each of ``--control-seeds``: the control in the program's place, the
configuration's reference module rendering with ``lowp=True`` (``rigid``:
every per-pixel value in bfloat16), against the reference itself on the
rows a run of that seed compares (the upper readings). One JSON line each.
"""

import argparse
import json
import random
import sys
from pathlib import Path

CHECKOUT = Path(__file__).resolve().parent.parent
if str(CHECKOUT) not in sys.path:
    sys.path.insert(0, str(CHECKOUT))

from perfbench import compare, run  # noqa: E402
from perfbench.atlas import procedural_atlas  # noqa: E402
from perfbench.cells import Cell  # noqa: E402


def seeds(text: str):
    out = []
    for part in text.split(","):
        lo, _, hi = part.partition("-")
        out += list(range(int(lo), int(hi or lo) + 1))
    return out


def control_rows(cell: Cell, seed: int, batches: int):
    """Global sample indices a run of ``seed`` would compare, had its window
    held ``batches`` batches (the reservoir's draws, then the last)."""
    B = cell.generator_settings(seed)["batch_size"]
    rng = random.Random(seed)
    keeper = compare.RowKeeper(int(cell.traffic["compare_rows"]), B, rng)
    first = int(cell.traffic["warmup_batches"])
    for i in range(batches):
        keeper.offer(first + i, None)
    keeper.last(first + batches - 1, None)
    return [i for i, _ in keeper.kept]


def control(cell: Cell, seed: int, device, batches: int = 300) -> dict:
    """The control's compared numbers for ``seed``."""
    reference = cell.reference()
    settings = cell.generator_settings(seed)
    atlas = procedural_atlas(int(cell.config["atlas"]["textures"]),
                             2 * settings["height"], 2 * settings["width"],
                             seed, device)
    idx = control_rows(cell, seed, batches)
    ref = reference.render_rows(seed % 2**32, idx, settings, atlas)
    low = reference.render_rows(seed % 2**32, idx, settings, atlas, lowp=True)
    return compare.numbers(low, ref)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=3.0)
    args = p.parse_args(argv)
    cell = Cell(args.workload)
    run.use_caches()
    dev = run.card(cell.chips)
    for s in seeds(args.seeds) if args.seeds else []:
        res, _ = run.run_cell(cell, s, args.seconds, False, dev)
        print(json.dumps({"cell": cell.name, "seed": s, "side": "program",
                          "correct": res["correct"],
                          "batches": res["attempted"],
                          "numbers": {k: v["value"] for k, v in
                                      res["checks"].items()}}), flush=True)
    for s in seeds(args.control_seeds) if args.control_seeds else []:
        print(json.dumps({"cell": cell.name, "seed": s, "side": "control",
                          "numbers": control(cell, s, dev)}), flush=True)


if __name__ == "__main__":
    main()
