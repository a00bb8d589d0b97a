"""The benchmark of ``flowgen_torch``, the PyTorch and CUDA generator.

    python3 perfbench/run.py --workload CELL --seed N --seconds S --trace 0|1

from the root of a checkout. A run loads the cell's configuration and
traffic mix by name (``cells.py``), makes the texture bank on the card from
the seed (``atlas.py``), builds ``flowgen_torch.Generator`` on it, warms up
the cell's own shapes, then runs a closed loop for ``S`` seconds: one
consumer asks for the next batch through ``retrieve_batch`` when it has the
previous one, and waits until that batch is ready on the card. After the
window it compares rows of the window's batches with the configuration's
plain reference (``compare.py``, ``reference/``) and prints one JSON line,
the last of its standard output. ``--trace 1`` profiles a fixed number of
steps in the window's second half and reports the cell's per-layer metrics
(``metrics/``) from the profile's summary and span table (``spans.py``);
``--trace 0`` its end-to-end metrics.

Without a CUDA card (or with fewer than the cell asks for) it exits with 2
and prints no result; so it does if the process has loaded JAX or the JAX
package ``flowgen`` by the end of the window.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import random  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

CHECKOUT = Path(__file__).resolve().parent.parent
if str(CHECKOUT) not in sys.path:
    sys.path.insert(0, str(CHECKOUT))

from perfbench import compare, importcheck, stats  # noqa: E402
from perfbench.atlas import procedural_atlas  # noqa: E402
from perfbench.cells import Cell  # noqa: E402
from perfbench.spans import summarize_with_spans  # noqa: E402
from perfbench.trace import STEP_SPAN, profile_events  # noqa: E402

# Fixed build and kernel-cache directories inside the checkout, so that
# only a cell's first run in a checkout compiles.
CACHE = CHECKOUT / "build" / "perfbench"


class NoCard(RuntimeError):
    pass


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def use_caches():
    """Point the program's kernel builds and any PyTorch extension or
    Triton cache at fixed directories inside the checkout."""
    from flowgen_torch.utils.profiling import enable_compile_cache

    enable_compile_cache(CACHE / "kernels")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")


def card(chips: int):
    """The CUDA device to run on; raises :class:`NoCard` when there is no
    card or fewer than ``chips``."""
    import torch

    if not torch.cuda.is_available():
        raise NoCard("torch.cuda.is_available() is false: this benchmark "
                     "measures the CUDA card and does not run on the CPU")
    if torch.cuda.device_count() < chips:
        raise NoCard(f"the cell asks for {chips} cards, "
                     f"{torch.cuda.device_count()} found")
    return torch.device("cuda", 0)


def power_limit():
    """The card's power limit as nvidia-smi reads it, or None."""
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                            "--format=csv,noheader,nounits", "-i", "0"],
                           capture_output=True, text=True, timeout=20)
        return float(r.stdout.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


def served(cfg, atlas, device):
    """``flowgen_torch.Generator`` that records a CUDA event after each
    step it enqueues, so that the consumer can wait for exactly its batch
    (every step runs on one stream, and the next ones are queued behind
    it). ``next_ready()`` returns the next batch and a function that waits
    until it is ready."""
    import collections

    import torch
    from flowgen_torch.pipeline.generator import Generator

    class Served(Generator):
        def _dispatch(self):
            out = super()._dispatch()
            ev = None
            if self.device.type == "cuda":
                ev = torch.cuda.Event()
                ev.record()
            self._ready.append(ev)
            return out

        def next_ready(self):
            out = self.retrieve_batch()
            ev = self._ready.popleft()
            return out, (ev.synchronize if ev is not None else (lambda: None))

    gen = Served(cfg, atlas, device=device)
    gen._ready = collections.deque()
    return gen


def closed_loop(next_ready, seconds, samples=0, clock=time.perf_counter,
                on_batch=None, hooks=None):
    """One consumer for ``seconds``: ask for a batch, wait until it is
    ready, repeat; no request is made after the window closes. Returns
    (t_open, t_close, records, the last batch) with one ``stats.Batch`` of
    ``samples`` samples a request.
    ``on_batch(i, out)`` sees every batch once ready; ``hooks(i, t)`` is
    called before request ``i`` and may return a context for it."""
    import contextlib

    records = []
    t_open = clock()
    t_close = t_open + seconds
    i = 0
    out = None
    while True:
        t_req = clock()
        if t_req >= t_close:
            break
        ctx = hooks(i, t_req - t_open) if hooks else None
        with ctx or contextlib.nullcontext():
            out, wait = next_ready()
            t_ret = clock()
            wait()
            t_ready = clock()
        records.append(stats.Batch(t_req, t_ret, t_ready, samples))
        if on_batch is not None:
            on_batch(i, out)
        i += 1
    return t_open, t_close, records, out


class Profiler:
    """Profiles ``steps`` consecutive requests from the first one made in
    the window's second half (``torch.profiler``, CPU and CUDA), each
    request inside a ``perfbench.step`` span; synchronizes the device
    before it stops."""

    def __init__(self, seconds: float, steps: int):
        self.half = seconds / 2.0
        self.steps = steps
        self.first = None
        self.prof = None
        self.events = None

    def __call__(self, i, t):
        import torch
        from torch.profiler import ProfilerActivity, profile, record_function

        if self.first is None and t >= self.half:
            self.first = i
            acts = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(ProfilerActivity.CUDA)
            self.prof = profile(activities=acts)
            self.prof.start()
        if self.first is None or i >= self.first + self.steps:
            return None
        return _Step(self, i, record_function(STEP_SPAN))

    def profiled(self, i) -> bool:
        """Whether request ``i`` was profiled or came right after (the
        pipeline refills after the synchronize)."""
        return (self.first is not None
                and self.first <= i < self.first + self.steps + 2)

    def stop(self):
        import torch

        if self.prof is not None:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            self.prof.stop()
            self.events = profile_events(self.prof)
            self.prof = None


class _Step:
    def __init__(self, owner, i, span):
        self.owner, self.i, self.span = owner, i, span

    def __enter__(self):
        self.span.__enter__()

    def __exit__(self, *exc):
        self.span.__exit__(*exc)
        if self.i == self.owner.first + self.owner.steps - 1:
            self.owner.stop()
        return False


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device):
    """One run of ``cell`` on ``device``: the result's dict and the lines
    for standard error."""
    import torch

    import flowgen_torch

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize()

    stamps = [("imports", time.perf_counter())]
    settings = cell.generator_settings(seed)
    atlas_cfg = cell.config["atlas"]
    traffic = cell.traffic
    B = settings["batch_size"]
    atlas = procedural_atlas(int(atlas_cfg["textures"]),
                             2 * settings["height"], 2 * settings["width"],
                             seed, device)
    sync()
    stamps.append(("atlas", time.perf_counter()))
    gen = served(flowgen_torch.DataGenConfig(**settings), atlas, device)
    sync()
    stamps.append(("generator", time.perf_counter()))
    for _ in range(int(traffic["warmup_batches"])):
        _, wait = gen.next_ready()
        wait()
    sync()
    stamps.append(("warm-up", time.perf_counter()))
    setup_s = stamps[-1][1] - T_START
    prev, parts = T_START, []
    for name, t in stamps:
        parts.append(f"{name} {t - prev:.3f}")
        prev = t

    keeper = compare.RowKeeper(int(traffic["compare_rows"]), B,
                               random.Random(seed))
    # Batches come back in step order: the window's i-th is step first + i.
    first = int(traffic["warmup_batches"])

    def on_batch(i, out):
        keeper.offer(first + i, out)

    def segments():
        if device.type != "cuda":
            return 0, 0
        m = torch.cuda.memory_stats(device)
        return m.get("segment.all.allocated", 0), m.get("num_alloc_retries", 0)

    prof = Profiler(seconds, int(traffic["profile_steps"])) if trace else None
    seg0 = segments()
    t_open, t_close, recs, last = closed_loop(gen.next_ready, seconds, B,
                                              on_batch=on_batch, hooks=prof)
    seg1 = segments()
    if prof is not None:
        prof.stop()   # a profile the window's close cut short
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    if recs:
        keeper.last(first + len(recs) - 1, last)
    gen.stop()
    del gen, last
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    idx, prog = keeper.rows()
    try:
        ref = cell.reference().render_rows(seed % 2**32, idx, settings,
                                           atlas)
        values = compare.numbers(prog, ref)
    except ValueError as e:
        print(f"perfbench: the reference cannot check this cell: {e}",
              file=sys.stderr)
        values = {k: float("inf") for k in cell.limits}
    correct = compare.judge(values, cell.limits) and len(recs) > 0

    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": cell.chips, "memory_peak_bytes": int(peak)}
    result = {"correct": correct, "attempted": len(recs),
              "failed": 0, "metrics": {}, "device": dev}
    if trace:
        summary = (summarize_with_spans(prof.events, prof.steps)
                   if prof.events else None)
        host = [r for i, r in enumerate(recs) if not prof.profiled(i)]
        record = {"cell": cell.name, "settings": settings,
                  "config": cell.config, "traffic": traffic,
                  "host": {"step_ms": [1e3 * (r.t_ret - r.t_req) for r in host],
                           "ready_wait_ms": [1e3 * (r.t_ready - r.t_ret)
                                             for r in host],
                           "before_profile": (len(recs) if prof.first is None
                                              else prof.first)},
                  "trace": summary}
        for m in cell.per_layer():
            v = cell.reader(m["name"])(record)
            if v is not None:
                result["metrics"][m["name"]] = {"value": v, "unit": m["unit"]}
        if summary is not None:
            dev["busy_s"] = summary["busy_s"]
            dev["window_s"] = summary["window_s"]
            result["breakdown"] = {"device_ops": summary["device_ops"],
                                   "idle_gaps": summary["idle_gaps"]}
    else:
        e2e = {
            "samples_per_s": stats.samples_per_s(recs, t_open, t_close),
            "batch_wait_p95_ms": stats.batch_wait_p95_ms(recs),
            "peak_mem_gib": peak / 2**30,
            "setup_s": setup_s,
        }
        for m in cell.end_to_end():
            result["metrics"][m["name"]] = {"value": e2e[m["name"]],
                                            "unit": m["unit"]}
    dev["power_limit_w"] = power_limit() if device.type == "cuda" else None
    result["checks"] = {k: {"value": v, "limit": cell.limits.get(k)}
                        for k, v in values.items()}
    lines = [f"perfbench: {cell.name} seed {seed}: set-up s: "
             + ", ".join(parts),
             f"perfbench: {cell.name} seed {seed}: {len(recs)} batches of "
             f"{B}, rows compared {len(idx)}, correct {correct}"]
    if len(recs) >= 4:
        tenth = (t_close - t_open) / 10
        rates = [round(stats.samples_per_s(recs, t_open + k * tenth,
                                           t_open + (k + 1) * tenth))
                 for k in range(10)]
        waits = [1e3 * (r.t_ready - r.t_req) for r in recs]
        q = statistics.quantiles(waits, n=4)
        lines.append(f"perfbench: samples/s over the window "
                     f"{stats.samples_per_s(recs, t_open, t_close)!r}, "
                     f"by tenth of the window {rates}; "
                     f"batch wait ms quartiles {q[0]:.2f} {q[1]:.2f} "
                     f"{q[2]:.2f}, max {max(waits):.2f}; device memory "
                     f"segments allocated in the window {seg1[0] - seg0[0]}, "
                     f"allocation retries {seg1[1] - seg0[1]}")
    lines += [f"check {k}: {v['value']!r} limit {v['limit']!r}"
              for k, v in result["checks"].items()]
    return result, lines


def main(argv=None) -> int:
    args = parse(argv)
    cell = Cell(args.workload)
    try:
        use_caches()
        dev = card(cell.chips)
    except (ImportError, NoCard) as e:
        print(f"perfbench: {e}", file=sys.stderr)
        return 2
    result, lines = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                             dev)
    bad = importcheck.loaded()
    if bad:
        print(f"perfbench: the run loaded JAX or the JAX package: {bad}",
              file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    for line in lines:
        print(line, file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
