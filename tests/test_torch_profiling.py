"""The port's profiling utilities (``flowgen_torch/utils/profiling.py``)
against the JAX package's, and ``Generator.meter``."""

import json
import os

import jax.numpy as jnp
import pytest
import torch

import flowgen.utils.profiling as jprof
import flowgen_torch
from flowgen_torch.ops import _build
from flowgen_torch.utils import profiling as tprof

torch.set_num_threads(1)


class _Clock:
    """A stand-in for ``time.perf_counter`` that returns the given times."""

    def __init__(self, times):
        self._times = iter(times)

    def __call__(self):
        return next(self._times)


@pytest.mark.parametrize("window,ticks", [
    (32, [(0.0, 4), (0.5, 4), (1.25, 8)]),
    (3, [(0.0, 1), (0.1, 2), (0.3, 3), (0.7, 4), (1.5, 5), (2.0, 6)]),
    (32, [(1.0, 64)]),
    (2, [(5.0, 16), (5.0, 16), (5.0, 16)]),
])
def test_meter_matches_jax(monkeypatch, window, ticks):
    times = [t for t, _ in ticks]
    meters = []
    for mod, meter in ((tprof, tprof.ThroughputMeter(window=window)),
                       (jprof, jprof.ThroughputMeter(window=window))):
        monkeypatch.setattr(mod.time, "perf_counter", _Clock(times))
        for _, n in ticks:
            meter.tick(n)
        meters.append(meter)
    t, j = meters
    assert t.samples_per_sec == j.samples_per_sec
    assert t.total_samples == j.total_samples == sum(n for _, n in ticks)
    assert t._times == j._times and t._counts == j._counts


def test_force_sync_reads_the_first_value():
    assert tprof.force_sync(torch.tensor([[3.5, 1.0]])) == 3.5
    assert tprof.force_sync({"a": torch.tensor(2.0), "b": torch.zeros(3)}) == 2.0
    assert tprof.force_sync([torch.full((2, 2), 7.0)]) == 7.0
    assert (tprof.force_sync({"x": torch.tensor([1.25])})
            == jprof.force_sync({"x": jnp.asarray([1.25])}))


def test_trace_writes_a_chrome_trace(tmp_path):
    d = tmp_path / "trace"
    with tprof.trace(str(d)) as log_dir:
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert log_dir == str(d)
    with open(d / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)


def test_enable_compile_cache_points_the_build_directory(monkeypatch, tmp_path):
    monkeypatch.delenv("FLOWGEN_TORCH_BUILD_DIR", raising=False)
    default = _build.build_dir()
    tprof.enable_compile_cache()
    assert _build.build_dir() == default
    assert default.parts[-2:] == ("build", "kernels")
    tprof.enable_compile_cache(tmp_path / "kernels")
    assert _build.build_dir() == tmp_path / "kernels"
    assert os.environ["FLOWGEN_TORCH_BUILD_DIR"] == str(tmp_path / "kernels")


def test_generator_meter_counts_retrieved_batches():
    cfg = flowgen_torch.DataGenConfig(mode=7, batch_size=2, width=128,
                                      height=96)
    gen = flowgen_torch.Generator(
        cfg, atlas=flowgen_torch.procedural_atlas(2, height=96, width=128),
        device="cpu")
    assert gen.meter.total_samples == 0
    for _ in range(3):
        gen.retrieve_batch()
    gen.stop()
    assert gen.meter.total_samples == 6
    assert len(gen.meter._times) == 3 and gen.meter.samples_per_sec > 0
