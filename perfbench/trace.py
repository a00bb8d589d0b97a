"""Reading the traced run's profile: ``torch.profiler`` (CPU and CUDA
activities) over a fixed number of the window's steps.

The trace is reduced to plain event tuples (:class:`Event`) first, so that
the arithmetic below runs on any list of events. Device work counted for
the profiled steps is the device activity whose launch (a CUDA runtime or
driver call) the profile recorded: work enqueued before the profile began
is left out, and the run synchronizes before the profile ends, so the work
of every step launched inside it is in. The device's busy time is the union
of all its activity intervals inside the profiled stretch, which runs from
the first profiled request to the last profiled batch being ready."""

from __future__ import annotations

import bisect
import json
import os
import re
import tempfile
from typing import Dict, Iterable, List, NamedTuple, Optional, Tuple

DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_KINDS = ("cuda_runtime", "cuda_driver")
STEP_SPAN = "perfbench.step"


class Event(NamedTuple):
    name: str
    kind: str        # trace category: cpu_op, user_annotation, kernel, ...
    start_ns: int
    end_ns: int
    corr: int        # correlation id (links a launch to its device activity)
    on_device: bool


DEVICE_CATS = DEVICE_KINDS + ("gpu_user_annotation",)


def profile_events(prof) -> List[Event]:
    """The profile's events as :class:`Event` tuples, read from its Chrome
    trace (written to a temporary file and removed), whose layout holds
    across PyTorch versions: complete events with a category, start and
    duration in microseconds, and the launch's correlation id."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            raw = json.load(f)
    finally:
        os.remove(path)
    out = []
    for e in raw.get("traceEvents", raw) if isinstance(raw, dict) else raw:
        if e.get("ph") != "X" or "ts" not in e:
            continue
        start = int(round(float(e["ts"]) * 1e3))
        cat = str(e.get("cat", ""))
        out.append(Event(str(e.get("name", "")), cat, start,
                         start + int(round(float(e.get("dur", 0)) * 1e3)),
                         int(e.get("args", {}).get("correlation", 0) or 0),
                         cat in DEVICE_CATS))
    return out


_OPS = (r"(\w+)_kernel_cuda", r"(\w+)_kernel_impl", r"native::(\w+_kernel)<",
        r"(\w*Functor\w*)")


def short_name(name: str) -> str:
    """A device operation's name without its argument list: the kernel's
    name with its template arguments (at most 80 characters), and for
    PyTorch's generic elementwise kernels the operation they run in
    brackets."""
    n = name[5:] if name.startswith("void ") else name
    n = n.replace("(anonymous namespace)::", "")
    head = re.split(r"[<(]", n, maxsplit=1)[0]
    if head.startswith("at::native::"):
        for pat in _OPS:
            ops = [m for m in re.findall(pat, n[len(head):]) if m != "gpu"]
            if ops:
                return f"{head}[{ops[-1]}]"
    if head != n and n[len(head)] == "<":
        return (head + n[len(head):].split("(", 1)[0])[:80]
    return head


def _union(intervals: Iterable[Tuple[int, int]], lo: int, hi: int):
    """Disjoint sorted intervals covering the union of ``intervals``
    clipped to [lo, hi]."""
    out = []
    for s, e in sorted(intervals):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _innermost(host: List[Event], starts: List[int], spans: List[Event],
               t: int) -> str:
    """Name of the shortest host event running at time ``t``, that is with
    ``start_ns <= t <= end_ns``: one of the 2,000 host operations that
    started last before it, or a span."""
    best = None
    i = bisect.bisect_right(starts, t)
    for ev in list(reversed(host[max(0, i - 2000):i])) + spans:
        if ev.start_ns <= t <= ev.end_ns and (
                best is None
                or ev.end_ns - ev.start_ns < best.end_ns - best.start_ns):
            best = ev
    return best.name if best is not None else "(no host op)"


def summarize(events: List[Event], steps: int, top: int = 10) -> Optional[dict]:
    """Per-step device work and the stretch's busy and idle time.

    Returns None when the profile holds no ``perfbench.step`` span, else a
    dict: ``steps``; ``window_s`` (the stretch) and ``busy_s``; ``kernels``,
    (name, seconds) of every kernel launched inside the profile;
    ``device_ops``, the ``top`` device activities by total seconds; and
    ``idle_gaps``, the stretch's idle seconds summed by the innermost host
    operation running at each gap's middle, the ``top`` largest."""
    spans = [e for e in events if e.name == STEP_SPAN and not e.on_device]
    if not spans:
        return None
    lo = min(e.start_ns for e in spans)
    hi = max(e.end_ns for e in spans)
    launched = {e.corr for e in events
                if not e.on_device and e.kind in LAUNCH_KINDS}
    every = [e for e in events if e.on_device and e.kind in DEVICE_KINDS]
    device = [e for e in every if e.corr in launched] if launched else every
    busy = _union(((e.start_ns, e.end_ns) for e in every), lo, hi)
    busy_ns = sum(e - s for s, e in busy)
    by_name: Dict[str, float] = {}
    for e in device:
        k = short_name(e.name)
        by_name[k] = by_name.get(k, 0.0) + (e.end_ns - e.start_ns) / 1e9
    host = sorted((e for e in events if not e.on_device
                   and e.kind not in LAUNCH_KINDS),
                  key=lambda e: e.start_ns)
    starts = [e.start_ns for e in host]
    marks = [e for e in host if e.kind == "user_annotation"]
    gaps: Dict[str, float] = {}
    edges = [lo] + [x for iv in busy for x in iv] + [hi]
    for s, e in zip(edges[0::2], edges[1::2]):
        if e > s:
            name = _innermost(host, starts, marks, (s + e) // 2)
            gaps[name] = gaps.get(name, 0.0) + (e - s) / 1e9
    rank = lambda d: sorted(([k, v] for k, v in d.items()),
                            key=lambda kv: -kv[1])[:top]
    return {
        "steps": steps,
        "window_s": (hi - lo) / 1e9,
        "busy_s": busy_ns / 1e9,
        "kernels": [(e.name, (e.end_ns - e.start_ns) / 1e9) for e in device
                    if e.kind == "kernel"],
        "device_ops": rank(by_name),
        "idle_gaps": rank(gaps),
    }


def kernel_ms(summary: Optional[dict], token: str) -> Optional[float]:
    """Device ms a profiled step of the kernels whose name holds ``token``,
    or None where the profile saw none."""
    if not summary:
        return None
    hit = [s for name, s in summary["kernels"] if token in name]
    return 1e3 * sum(hit) / summary["steps"] if hit else None
