"""The program's spans in the traced run's profile, and a traced run that
prints them.

``flowgen_torch`` names its layers with ``record_function`` spans
(``flowgen_torch/utils/profiling.py:span``, names ``flowgen.*``), which the
profile holds as ``user_annotation`` host events on the clock of the CUDA
launches (runtime calls and ``cuLaunchKernel``) made inside them. :func:`span_table` gives, per
span name and per profiled step, the host time and what was launched inside:
CUDA kernels and their device time, synchronizing calls, host-to-device
copies. A launch belongs to the innermost span whose interval holds the
launch's start: the ``Generator`` dispatches every step on one thread, so
its spans nest and containment is enough.

    python3 perfbench/spans.py --workload CELL --seed N --seconds S

runs ``run.py``'s traced run (``--trace 1``) of the cell, prints its result
line, then one JSON line with the span table, the per-layer readings of
``metrics/`` that read it, and the profiled step's host time. The host times
are those of profiled steps, which the profiler slows 1.5-2 times: compare
them between trees, never with the unprofiled ``host_step_ms``.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import Dict, List, Optional

CHECKOUT = Path(__file__).resolve().parent.parent
if str(CHECKOUT) not in sys.path:
    sys.path.insert(0, str(CHECKOUT))

from perfbench.trace import (  # noqa: E402
    DEVICE_KINDS, LAUNCH_KINDS, STEP_SPAN, Event, _union, summarize)

PREFIX = "flowgen."
PROGRAM_STEP = "flowgen.step"
# Runtime calls that block the host until the device has caught up;
# ``cudaMemcpy`` is the blocking copy (``cudaMemcpyAsync`` is not).
SYNC_CALLS = frozenset(("cudaStreamSynchronize", "cudaDeviceSynchronize",
                        "cudaEventSynchronize", "cudaMemcpy"))
COUNTS = ("kernels", "device_s", "syncs", "h2d")
# The readers under ``metrics/`` that read the span table.
METRICS = ("sampler_kernels_per_step", "sampler_host_ms", "sampler_device_ms",
           "precompute_kernels_per_step", "precompute_host_ms",
           "precompute_device_ms", "host_syncs_per_step",
           "h2d_copies_per_step")


def _launch_counts(launch: Event, device: Dict[int, List[Event]]) -> dict:
    work = device.get(launch.corr, ()) if launch.corr else ()
    return {
        "kernels": sum(1 for d in work if d.kind == "kernel"),
        "device_s": sum(d.end_ns - d.start_ns for d in work) / 1e9,
        "syncs": 1 if launch.name in SYNC_CALLS else 0,
        "h2d": sum(1 for d in work
                   if d.kind == "gpu_memcpy" and "HtoD" in d.name),
    }


def span_table(events: List[Event], lo: int, hi: int, steps: int) -> dict:
    """Per ``flowgen.*`` span name inside [lo, hi] ns, each value a
    profiled step's: ``calls``; ``host_s``, the spans' wall time, and
    ``self_s``, less what their child ``flowgen.*`` spans cover;
    ``kernels``, the CUDA kernels whose launch starts inside the span and in
    none of its children, ``device_s`` the device time of those launches'
    work (joined by correlation id), ``syncs`` the synchronizing runtime
    calls (:data:`SYNC_CALLS`) and ``h2d`` the host-to-device copies among
    them; ``inclusive`` the same four counted over the span and all of its
    children; ``idle_s``, the device's idle time in [lo, hi] whose gaps'
    middles fall in the span and in none of its children."""
    spans = sorted((e for e in events if not e.on_device
                    and e.kind == "user_annotation"
                    and e.name.startswith(PREFIX)
                    and lo <= e.start_ns and e.end_ns <= hi),
                   key=lambda e: (e.start_ns, -e.end_ns))
    device: Dict[int, List[Event]] = {}
    for e in events:
        if e.on_device and e.kind in DEVICE_KINDS:
            device.setdefault(e.corr, []).append(e)
    busy = _union(((e.start_ns, e.end_ns) for work in device.values()
                   for e in work), lo, hi)
    edges = [lo] + [x for iv in busy for x in iv] + [hi]
    # What happened at a time t: a launch, or the middle of an idle gap.
    probes = sorted([(e.start_ns, _launch_counts(e, device))
                     for e in events if not e.on_device
                     and e.kind in LAUNCH_KINDS and lo <= e.start_ns <= hi]
                    + [((s + e) // 2, {"idle_s": (e - s) / 1e9})
                       for s, e in zip(edges[0::2], edges[1::2]) if e > s],
                    key=lambda p: p[0])

    per = [{"self": {}, "inclusive": {}, "children_ns": 0} for _ in spans]
    stack: List[int] = []
    si = 0
    for t, got in probes + [(hi + 1, None)]:
        while si < len(spans) and spans[si].start_ns <= t:
            while stack and spans[stack[-1]].end_ns <= spans[si].start_ns:
                stack.pop()
            if stack:
                per[stack[-1]]["children_ns"] += (spans[si].end_ns
                                                  - spans[si].start_ns)
            stack.append(si)
            si += 1
        while stack and spans[stack[-1]].end_ns < t:
            stack.pop()
        if got is None or not stack:
            continue
        for k, v in got.items():
            own = per[stack[-1]]["self"]
            own[k] = own.get(k, 0) + v
            for j in stack:
                inc = per[j]["inclusive"]
                inc[k] = inc.get(k, 0) + v

    n = max(steps, 1)
    rows: Dict[str, dict] = {}
    for e, p in zip(spans, per):
        r = rows.setdefault(e.name, {"calls": 0, "host_s": 0.0, "self_s": 0.0,
                                     **dict.fromkeys(COUNTS, 0), "idle_s": 0.0,
                                     "inclusive": dict.fromkeys(COUNTS, 0)})
        wall = (e.end_ns - e.start_ns) / 1e9
        r["calls"] += 1 / n
        r["host_s"] += wall / n
        r["self_s"] += (wall - p["children_ns"] / 1e9) / n
        for k, v in p["self"].items():
            r[k] += v / n
        for k in COUNTS:
            r["inclusive"][k] += p["inclusive"].get(k, 0) / n
    return rows


def stretch(events: List[Event]):
    """The profiled stretch [lo, hi] ns as ``trace.summarize`` takes it:
    from the first ``perfbench.step`` span's start to the last one's end;
    None without such a span."""
    steps = [e for e in events if e.name == STEP_SPAN and not e.on_device]
    if not steps:
        return None
    return min(e.start_ns for e in steps), max(e.end_ns for e in steps)


def summarize_with_spans(events: List[Event], steps: int,
                         top: int = 10) -> Optional[dict]:
    """``trace.summarize``'s dict with one key more, ``spans``, the
    :func:`span_table` of its profiled stretch."""
    out = summarize(events, steps, top)
    if out is not None:
        out["spans"] = span_table(events, *stretch(events), steps)
    return out


def span_reading(rec: dict, name: str, key: str,
                 inclusive: bool = False) -> Optional[float]:
    """Span ``name``'s ``key`` a step from the record's trace summary
    (``inclusive`` over its children too), or None where the summary holds
    no span table or no such span."""
    t = rec.get("trace")
    row = (t or {}).get("spans", {}).get(name)
    if row is None:
        return None
    return row["inclusive"][key] if inclusive else row[key]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    args = p.parse_args(argv)

    from perfbench import run
    from perfbench.cells import Cell

    seen = {}

    def keep(events, steps, top=10):
        seen["events"], seen["steps"] = events, steps
        seen["summary"] = summarize_with_spans(events, steps, top)
        return seen["summary"]

    run.summarize_with_spans = keep
    rc = run.main(["--workload", args.workload, "--seed", str(args.seed),
                   "--seconds", str(args.seconds), "--trace", "1"])
    summary = seen.get("summary")
    if rc != 0 or summary is None:
        return rc or 1
    steps = seen["steps"]
    marks = [e for e in seen["events"]
             if e.name == STEP_SPAN and not e.on_device]
    cell = Cell(args.workload)
    rec = {"trace": summary}
    step = summary["spans"].get(PROGRAM_STEP)
    line = {
        "cell": args.workload, "seed": args.seed, "steps": steps,
        "perfbench_step_ms": sum(e.end_ns - e.start_ns
                                 for e in marks) / 1e6 / len(marks),
        "cuda_kernels_per_step": len(summary["kernels"]) / steps,
        "step_kernels": step["inclusive"]["kernels"] if step else None,
        "unattributed_kernel_share": (
            step["kernels"] / step["inclusive"]["kernels"]
            if step and step["inclusive"]["kernels"] else None),
        "metrics": {m: cell.reader(m)(rec) for m in METRICS},
        "idle_gaps": summary["idle_gaps"],
        "spans": summary["spans"],
    }
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
