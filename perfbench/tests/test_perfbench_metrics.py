"""The per-layer readers: the shape-only byte counts against hand-worked
cases, and the trace arithmetic on scripted events."""

import pytest

from perfbench.cells import Cell
from perfbench.trace import Event, kernel_ms, short_name, summarize


def _read(tiny_bench, metric, record):
    bench, base = tiny_bench
    return Cell("chairs_m7.trainer", bench, base).reader(metric)(record)


def test_scene_kernel_bytes_by_hand(tiny_bench):
    bench, base = tiny_bench
    mod = Cell("chairs_m7.trainer", bench, base).reader("scene_kernel_roofline")
    step_bytes = mod.__globals__["step_bytes"]
    s = {"batch_size": 1024, "height": 384, "width": 512}
    # two frames of packed RGB (4 + 4) and flow0 (8): 16 bytes a pixel
    assert step_bytes(s) == 1024 * 384 * 512 * 16 == 3_221_225_472
    # with flow1 (8) and two id planes (4 + 4): 32 bytes a pixel
    assert step_bytes(dict(s, compute_inverse_flow=True, emit_masks=True)) \
        == 1024 * 384 * 512 * 32


def test_photometric_bytes_by_hand(tiny_bench):
    bench, base = tiny_bench
    mod = Cell("chairs_m7.trainer", bench, base).reader("photometric_roofline")
    step_bytes = mod.__globals__["step_bytes"]
    # 1024 pairs of 384x512x3 float32 values, each read and written once
    assert step_bytes({"batch_size": 1024, "height": 384, "width": 512}) \
        == 8 * 1024 * 384 * 512 * 3 * 2 == 9_663_676_416


def _events():
    """Two profiled steps over 10 ms: kernels of 2 and 3 ms launched inside
    the profile (one overlapping another), a 1 ms copy, and one kernel
    launched before the profile began."""
    ms = 1_000_000
    return [
        Event("perfbench.step", "user_annotation", 0, 5 * ms, 0, False),
        Event("perfbench.step", "user_annotation", 5 * ms, 10 * ms, 0, False),
        Event("aten::sort", "cpu_op", 6 * ms, 9 * ms, 0, False),
        Event("cudaLaunchKernel", "cuda_runtime", 0, 1, 7, False),
        Event("cudaLaunchKernel", "cuda_runtime", 1, 2, 8, False),
        Event("cudaMemcpyAsync", "cuda_runtime", 2, 3, 9, False),
        Event("void scene_kernel<false>(SceneParams)", "kernel",
              1 * ms, 3 * ms, 7, True),
        Event("void scene_kernel<false>(SceneParams)", "kernel",
              2 * ms, 5 * ms, 8, True),
        Event("Memcpy DtoH", "gpu_memcpy", 9 * ms, 10 * ms, 9, True),
        Event("old_kernel", "kernel", 0, 1 * ms, 3, True),
    ]


def test_trace_summary_by_hand():
    t = summarize(_events(), steps=2)
    assert t["window_s"] == pytest.approx(0.010)
    # busy: [0, 5] ms (the old kernel counts for busy time) and [9, 10]
    assert t["busy_s"] == pytest.approx(0.006)
    assert [k for k, _ in t["kernels"]] == [
        "void scene_kernel<false>(SceneParams)"] * 2
    assert kernel_ms(t, "scene_kernel") == pytest.approx(2.5)
    assert kernel_ms(t, "photometric") is None
    # the idle [5, 9] ms falls in aten::sort's call at its middle
    assert t["idle_gaps"] == [["aten::sort", pytest.approx(0.004)]]
    assert t["device_ops"][0] == ["scene_kernel<false>", pytest.approx(0.005)]


def test_device_operations_are_named_without_their_arguments():
    assert short_name("void scene_kernel<false>(SceneParams)") == \
        "scene_kernel<false>"
    assert short_name("flowgen::object_window_kernel(float const*, int)") \
        == "flowgen::object_window_kernel"
    assert short_name(
        "void at::native::elementwise_kernel<128, 2, at::native::"
        "gpu_kernel_impl_nocast<at::native::BinaryFunctor<float, float, "
        "float, at::native::binary_internal::MulFunctor<float> > >(at::"
        "TensorIteratorBase&)") == "at::native::elementwise_kernel[MulFunctor]"
    assert short_name(
        "void at::native::unrolled_elementwise_kernel<at::native::"
        "direct_copy_kernel_cuda(at::TensorIteratorBase&)::{lambda()#3}") \
        == "at::native::unrolled_elementwise_kernel[direct_copy]"


def test_readers_on_a_summary(tiny_bench):
    rec = {"settings": {"batch_size": 1024, "height": 384, "width": 512},
           "host": {"step_ms": [10.0, 20.0], "ready_wait_ms": [1.0, 3.0]},
           "trace": summarize(_events(), steps=2)}
    assert _read(tiny_bench, "host_step_ms", rec) == pytest.approx(15.0)
    assert _read(tiny_bench, "ready_wait_ms", rec) == pytest.approx(2.0)
    assert _read(tiny_bench, "first_half_samples_per_s", rec) \
        == pytest.approx(1024 * 2 / 0.034)
    before = dict(rec, host=dict(rec["host"], before_profile=1))
    assert _read(tiny_bench, "first_half_samples_per_s", before) \
        == pytest.approx(1024 / 0.011)
    assert _read(tiny_bench, "device_idle_share", rec) == pytest.approx(0.4)
    assert _read(tiny_bench, "cuda_kernels_per_step", rec) == 1.0
    assert _read(tiny_bench, "scene_kernel_ms", rec) == pytest.approx(2.5)
    share = 100 * 3_221_225_472 / 3.35e12 / 2.5e-3
    assert _read(tiny_bench, "scene_kernel_roofline", rec) == pytest.approx(share)
    # a reader that finds nothing returns nothing
    for m in ("photometric_ms", "photometric_roofline"):
        assert _read(tiny_bench, m, rec) is None
    assert _read(tiny_bench, "scene_kernel_roofline", dict(rec, trace=None)) is None
    no_host = dict(rec, host={"step_ms": [], "ready_wait_ms": []})
    assert _read(tiny_bench, "first_half_samples_per_s", no_host) is None
