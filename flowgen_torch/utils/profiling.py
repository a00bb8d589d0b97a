"""Throughput counters and device profiling (port of
``flowgen/utils/profiling.py``).

A samples/sec meter, a synchronization that waits for the device by reading
one value back, a ``torch.profiler`` trace written as a Chrome trace, the
spans that name the program's layers in such a trace, and the kernel build
cache's location."""

from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass, field
from typing import List

import torch


def enable_compile_cache(path: str | None = None) -> None:
    """Keep the compiled CUDA kernels (``ops/_build.py``) under ``path``, so
    later processes load them instead of running ``nvcc`` again. Without a
    path the build directory stays where it is (``build/kernels`` at the
    repository root unless ``FLOWGEN_TORCH_BUILD_DIR`` names another).
    Call it before the first kernel launch; libraries already loaded stay
    loaded."""
    if path is not None:
        os.environ["FLOWGEN_TORCH_BUILD_DIR"] = os.fspath(path)


def force_sync(tree) -> float:
    """Wait for a computation by reading one value of its first tensor back
    to the host (``.item()`` waits for the tensor's stream). ``tree`` is a
    tensor, or a dict, list or tuple holding tensors."""
    leaf = tree
    while not torch.is_tensor(leaf):
        leaf = next(iter(leaf.values() if isinstance(leaf, dict) else leaf))
    if hasattr(leaf, "to_local"):          # a DTensor: the rank's own shard
        leaf = leaf.to_local()
    return float(leaf.reshape(-1)[0].item())


@dataclass
class ThroughputMeter:
    """Rolling samples/sec meter. Feed it batch sizes as batches complete."""

    window: int = 32
    _times: List[float] = field(default_factory=list)
    _counts: List[int] = field(default_factory=list)
    total_samples: int = 0

    def tick(self, n_samples: int) -> None:
        self._times.append(time.perf_counter())
        self._counts.append(n_samples)
        self.total_samples += n_samples
        if len(self._times) > self.window:
            self._times.pop(0)
            self._counts.pop(0)

    @property
    def samples_per_sec(self) -> float:
        if len(self._times) < 2:
            return 0.0
        dt = self._times[-1] - self._times[0]
        return sum(self._counts[1:]) / max(dt, 1e-9)


_OFF = contextlib.nullcontext()


def span(name: str, arg: str | None = None):
    """A context naming a stretch of the program in a ``torch.profiler``
    trace: while a profiler runs, ``record_function(name, arg)``, which the
    trace holds as a ``user_annotation`` event on the clock of the CUDA
    calls and kernels launched inside it; otherwise one shared null
    context, so the spans cost a check (well under a microsecond) when no
    profile is taken."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name, arg)
    return _OFF


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block with ``torch.profiler`` (CPU activity, and CUDA
    where a card is present) and write a Chrome trace,
    ``log_dir/trace.json`` (open it in Perfetto or chrome://tracing). The
    program's :func:`span` events name its layers there: ``flowgen.step``
    (one ``Generator`` step, its index as argument) holds
    ``flowgen.sampler``, ``flowgen.precompute``, ``flowgen.scene_kernel``,
    ``flowgen.unpack`` (with ``flowgen.masks``), ``flowgen.photometric`` and
    ``flowgen.adapt``, or on the windowed renderer
    ``flowgen.background_pass`` and ``flowgen.objects``; mode 9's bank
    epochs build under ``flowgen.bank_epoch`` (argument ``demand`` or
    ``ahead``), which holds ``flowgen.bank_fields`` (displacer grids and
    elementary fields), ``flowgen.bank_compose`` (the doublings) and, on
    the scene kernel's path, ``flowgen.bank_aux`` (crops, column-inverse
    solve, the background's upscaled planes and bands)."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield log_dir
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
