"""The span table (``spans.py``) and its readers on a scripted profile."""

import pytest

from perfbench.cells import Cell
from perfbench.spans import METRICS, span_table, stretch, summarize_with_spans
from perfbench.trace import Event, summarize

MS = 1_000_000


def _host(name, kind, start_ms, end_ms, corr=0):
    return Event(name, kind, int(start_ms * MS), int(end_ms * MS), corr, False)


def _dev(name, kind, start_ms, end_ms, corr):
    return Event(name, kind, int(start_ms * MS), int(end_ms * MS), corr, True)


def _events():
    """Two profiled steps of 10 ms. Step 1: the sampler launches a kernel,
    a pageable host-to-device copy and a stream synchronize; the
    precompute a kernel; the scene kernel one by ``cuLaunchKernel``; the
    unpack one of its own and one inside its nested masks span; the step
    one outside every child span; the harness records an event after the
    step. Step 2: the sampler launches a kernel and a blocking copy."""
    rt, ua = "cuda_runtime", "user_annotation"
    return [
        _host("perfbench.step", ua, 0, 10),
        _host("perfbench.step", ua, 10, 20),
        _host("flowgen.step", ua, 0.2, 9),
        _host("flowgen.sampler", ua, 1, 4),
        _host("flowgen.precompute", ua, 4, 7),
        _host("flowgen.scene_kernel", ua, 7, 8),
        _host("flowgen.unpack", ua, 8, 8.9),
        _host("flowgen.masks", ua, 8.3, 8.8),
        _host("cudaLaunchKernel", rt, 0.5, 0.51, 18),
        _host("cudaLaunchKernel", rt, 1.5, 1.51, 11),
        _host("cudaMemcpyAsync", rt, 2.0, 2.01, 12),
        _host("cudaStreamSynchronize", rt, 2.5, 3.0, 13),
        _host("cudaLaunchKernel", rt, 5.0, 5.01, 14),
        _host("cuLaunchKernel", "cuda_driver", 7.5, 7.51, 15),
        _host("cudaLaunchKernel", rt, 8.1, 8.11, 17),
        _host("cudaLaunchKernel", rt, 8.5, 8.51, 16),
        _host("cudaEventRecord", rt, 9.5, 9.51, 19),
        _dev("void k_sampler(float*)", "kernel", 2.0, 2.5, 11),
        _dev("Memcpy HtoD (Pageable -> Device)", "gpu_memcpy", 2.1, 2.2, 12),
        _dev("void k_tables(float*)", "kernel", 5.0, 6.0, 14),
        _dev("scene_kernel_rigid", "kernel", 7.6, 8.0, 15),
        _dev("void k_unpack(int*)", "kernel", 8.15, 8.2, 17),
        _dev("void k_masks(int*)", "kernel", 8.6, 8.7, 16),
        _dev("void k_root(long*)", "kernel", 0.6, 0.7, 18),
        _host("flowgen.step", ua, 10.2, 19),
        _host("flowgen.sampler", ua, 11, 14),
        _host("aten::mul", "cpu_op", 14.5, 16.5),
        _host("cudaLaunchKernel", rt, 11.5, 11.51, 21),
        _host("cudaMemcpy", rt, 12.5, 12.9, 22),
        _dev("void k_sampler(float*)", "kernel", 12.0, 13.0, 21),
        _dev("Memcpy HtoD (Pageable -> Device)", "gpu_memcpy", 12.5, 12.6,
             22),
    ]


def test_launches_go_to_the_innermost_span():
    t = span_table(_events(), 0, 20 * MS, steps=2)
    assert set(t) == {"flowgen.step", "flowgen.sampler", "flowgen.precompute",
                      "flowgen.scene_kernel", "flowgen.unpack",
                      "flowgen.masks"}
    # kernels a step: self, then over the span and its children
    kernels = {n: (r["kernels"], r["inclusive"]["kernels"])
               for n, r in t.items()}
    assert kernels == {"flowgen.step": (0.5, 3.5),
                       "flowgen.sampler": (1.0, 1.0),
                       "flowgen.precompute": (0.5, 0.5),
                       "flowgen.scene_kernel": (0.5, 0.5),
                       "flowgen.unpack": (0.5, 1.0),
                       "flowgen.masks": (0.5, 0.5)}
    assert t["flowgen.sampler"]["calls"] == 1.0
    assert t["flowgen.masks"]["calls"] == 0.5
    # host time: wall, and less the child spans
    assert t["flowgen.step"]["host_s"] == pytest.approx(8.8e-3)
    assert t["flowgen.unpack"]["self_s"] == pytest.approx((0.9 - 0.5) / 2e3)
    assert t["flowgen.step"]["self_s"] == pytest.approx(
        (8.8 - 7.9 + 8.8 - 3.0) / 2e3)


def test_device_time_joins_by_correlation_id():
    t = span_table(_events(), 0, 20 * MS, steps=2)
    # the sampler: 0.5 ms kernel and 0.1 ms copy in step 1, 1 ms kernel and
    # 0.1 ms copy in step 2
    assert t["flowgen.sampler"]["device_s"] == pytest.approx(1.7e-3 / 2)
    assert t["flowgen.precompute"]["device_s"] == pytest.approx(1e-3 / 2)
    assert t["flowgen.step"]["device_s"] == pytest.approx(0.1e-3 / 2)
    assert t["flowgen.step"]["inclusive"]["device_s"] == pytest.approx(
        (0.1 + 0.5 + 0.1 + 1.0 + 0.4 + 0.05 + 0.1 + 1.0 + 0.1) / 2e3)


def test_idle_time_goes_to_the_span_holding_the_gap():
    t = span_table(_events(), 0, 20 * MS, steps=2)
    # gaps (ms) by their middle: [0, 0.6], [8.7, 12] and [13, 20] in
    # flowgen.step; [0.7, 2] and [2.5, 5] in the sampler; [6, 7.6] in the
    # precompute; [8, 8.15] in the unpack; [8.2, 8.6] in the masks
    idle = {n: r["idle_s"] for n, r in t.items()}
    assert idle == pytest.approx({
        "flowgen.step": 10.9e-3 / 2, "flowgen.sampler": 3.8e-3 / 2,
        "flowgen.precompute": 1.6e-3 / 2, "flowgen.scene_kernel": 0.0,
        "flowgen.unpack": 0.15e-3 / 2, "flowgen.masks": 0.4e-3 / 2},
        abs=1e-9)


def test_synchronizing_calls_and_host_to_device_copies():
    t = span_table(_events(), 0, 20 * MS, steps=2)
    # cudaStreamSynchronize (step 1) and the blocking cudaMemcpy (step 2);
    # cudaMemcpyAsync and cudaEventRecord do not block
    assert t["flowgen.sampler"]["syncs"] == 1.0
    assert t["flowgen.step"]["inclusive"]["syncs"] == 1.0
    assert t["flowgen.sampler"]["h2d"] == 1.0
    assert t["flowgen.step"]["inclusive"]["h2d"] == 1.0
    assert t["flowgen.precompute"]["syncs"] == t["flowgen.precompute"]["h2d"] \
        == 0


def test_summary_keeps_its_keys_and_adds_the_span_table():
    events = _events()
    base = summarize(events, steps=2)
    out = summarize_with_spans(events, steps=2)
    assert set(out) == set(base) | {"spans"}
    assert {k: v for k, v in out.items() if k != "spans"} == base
    assert out["spans"] == span_table(events, 0, 20 * MS, 2)
    assert stretch(events) == (0, 20 * MS)
    # trace.summarize's own readings of this profile, pinned
    assert base["steps"] == 2
    assert base["window_s"] == pytest.approx(0.020)
    # busy: [0.6, 0.7], [2.0, 2.5], [5, 6], [7.6, 8], [8.15, 8.2],
    # [8.6, 8.7], [12, 13] ms
    assert base["busy_s"] == pytest.approx(3.15e-3)
    assert len(base["kernels"]) == 7
    assert base["device_ops"][0] == ["k_sampler", pytest.approx(1.5e-3)]
    # trace.summarize names each idle gap by the shortest host event that
    # holds the gap's middle (trace.py:_innermost): [13, 20] ms by
    # aten::mul, [0, 0.6] and [8.7, 12] by flowgen.step, [0.7, 2] and
    # [2.5, 5] by flowgen.sampler; flowgen.masks, which starts later,
    # holds only [8.2, 8.6]
    assert base["idle_gaps"] == [
        ["aten::mul", pytest.approx(0.007)],
        ["flowgen.step", pytest.approx(0.0039)],
        ["flowgen.sampler", pytest.approx(0.0038)],
        ["flowgen.precompute", pytest.approx(0.0016)],
        ["flowgen.masks", pytest.approx(0.0004, abs=1e-9)],
        ["flowgen.unpack", pytest.approx(0.00015)]]
    assert summarize_with_spans([], steps=2) is None


def _read(tiny_bench, metric, record):
    bench, base = tiny_bench
    return Cell("chairs_m7.trainer", bench, base).reader(metric)(record)


def test_readers_of_the_span_table(tiny_bench):
    rec = {"trace": summarize_with_spans(_events(), steps=2)}
    got = {m: _read(tiny_bench, m, rec) for m in METRICS}
    assert got == {
        "sampler_kernels_per_step": 1.0,
        "sampler_host_ms": pytest.approx(3.0),
        "sampler_device_ms": pytest.approx(0.85),
        "precompute_kernels_per_step": 0.5,
        "precompute_host_ms": pytest.approx(1.5),
        "precompute_device_ms": pytest.approx(0.5),
        "host_syncs_per_step": 1.0,
        "h2d_copies_per_step": 1.0,
    }


@pytest.mark.parametrize("metric", METRICS)
def test_span_readers_find_nothing_without_program_spans(tiny_bench,
                                                         metric):
    """A profile of a program with no ``flowgen.*`` span (an older tree),
    a summary without a span table, and no trace all read None."""
    bare = [e for e in _events() if not e.name.startswith("flowgen.")]
    for trace in (summarize_with_spans(bare, steps=2),
                  summarize(_events(), steps=2), None):
        assert _read(tiny_bench, metric, {"trace": trace}) is None
