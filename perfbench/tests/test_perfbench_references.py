"""A configuration names its plain reference, the traced record carries the
span table, idle gaps go to the span that holds them, and every output the
reference returns is compared: on the CPU, at small sizes."""

import json
import re
import shutil
import sys

import pytest
import torch

from perfbench import calibrate, compare, importcheck, reference, run, spans
from perfbench.cells import HERE as PERFBENCH
from perfbench.cells import Cell
from perfbench.reference import rigid
from perfbench.trace import Event, _innermost, summarize

CPU = torch.device("cpu")
MS = 1_000_000

# A reference module that renders through ``rigid`` and records its calls.
PROBE = '''"""Renders through rigid and records each call."""
from . import rigid

calls = []


def check_supported(cfg):
    rigid.check_supported(cfg)


def render_rows(seed, indices, cfg, atlas, lowp=False):
    calls.append((seed, list(indices), lowp))
    return rigid.render_rows(seed, indices, cfg, atlas, lowp)
'''
INCOMPLETE = '''"""Has no render_rows."""


def check_supported(cfg):
    pass
'''
NEW = {"probe_ref": PROBE, "incomplete_ref": INCOMPLETE}


@pytest.fixture
def named(tiny_bench, tmp_path, monkeypatch):
    """``tiny_bench`` plus reference modules under a directory of their own,
    found as ``perfbench.reference.<name>``, and cells ``tiny_<ref>.t`` of
    the tiny chairs configuration whose ``reference`` key names ``probe_ref``,
    ``incomplete_ref`` or ``no_such_ref``, and ``tiny_masks.t``, which adds
    ``emit_masks`` and names no reference. Returns (BENCHMARK.json path,
    base directory)."""
    bench_path, base = tiny_bench
    refs = tmp_path / "refs"
    refs.mkdir()
    for name, text in NEW.items():
        (refs / f"{name}.py").write_text(text)
    monkeypatch.setattr(reference, "__path__",
                        [*reference.__path__, str(refs)])
    bench = json.loads(bench_path.read_text())
    src = json.loads((base / "configs" / "tiny_chairs.json").read_text())
    for ref in ("probe_ref", "incomplete_ref", "no_such_ref", None):
        name = f"tiny_{ref}" if ref else "tiny_masks"
        cfg = dict(src, name=name)
        if ref:
            cfg["reference"] = ref
        else:
            cfg["generator"] = dict(src["generator"], emit_masks=True)
        (base / "configs" / f"{name}.json").write_text(json.dumps(cfg))
        bench["workloads"].append({"name": f"{name}.t", "config": name,
                                   "traffic": "t", "chips": 1,
                                   "why": "a small cell for the CPU tests"})
        shutil.copy(base / "limits" / "tiny_chairs.t.json",
                    base / "limits" / f"{name}.t.json")
    bench_path.write_text(json.dumps(bench))
    yield bench_path, base
    for name in NEW:
        sys.modules.pop(f"perfbench.reference.{name}", None)


def _files(*dirs):
    return {p: p.read_bytes() for d in dirs for p in d.rglob("*")
            if p.is_file() and "__pycache__" not in p.parts}


def test_a_configuration_renders_through_the_reference_it_names(named):
    bench_path, base = named
    before = _files(PERFBENCH, base)
    cell = Cell("tiny_probe_ref.t", bench_path, base)
    probe = cell.reference()
    assert probe.__name__ == "perfbench.reference.probe_ref"
    result, _ = run.run_cell(cell, 2**31 + 17, 2.5, False, CPU)
    assert result["correct"] is True, result["checks"]
    # the run's compared rows: the reservoir's and one of the last batch
    assert len(probe.calls) == 1
    seed, idx, lowp = probe.calls[0]
    assert seed == (2**31 + 17) % 2**32 and not lowp
    assert len(idx) == cell.traffic["compare_rows"] + 1
    got = calibrate.control(cell, 3, CPU, batches=4)
    assert [c[2] for c in probe.calls[1:]] == [False, True]
    assert not compare.judge(got, cell.limits)
    assert _files(PERFBENCH, base) == before
    assert importcheck.loaded() == []


@pytest.mark.parametrize("cfg,why", [
    ("tiny_no_such_ref", "no reference module perfbench.reference.no_such"),
    ("tiny_incomplete_ref", "lacks ['render_rows']"),
    ("bad_name", "not a benchmark name")])
def test_a_missing_or_incomplete_reference_is_refused_at_load(named, cfg, why):
    bench_path, base = named
    if cfg == "bad_name":
        c = json.loads((base / "configs" / "tiny_chairs.json").read_text())
        c["reference"] = "../rigid"
        (base / "configs" / "tiny_chairs.json").write_text(json.dumps(c))
        cfg = "tiny_chairs"
    with pytest.raises(ValueError, match=re.escape(why)):
        Cell(f"{cfg}.t", bench_path, base)


@pytest.mark.parametrize("name,small", [
    ("chairs_m7.trainer", "tiny_chairs.t"),
    ("chairs_m7.trainer_photo", "tiny_chairs.t_photo")])
def test_both_cells_render_through_rigid_as_before(tiny_bench, name, small):
    """The benchmark's cells name no reference and render through ``rigid``,
    whose functions are the ones ``perfbench.reference`` has always
    exported; at the cells' settings, shrunk, it equals the program's
    windowed renderer bit for bit, as the reference did before."""
    import flowgen_torch
    from flowgen_torch.pipeline.generator import make_generate_fn

    from perfbench.atlas import procedural_atlas

    assert "reference" not in Cell(name, *tiny_bench).config
    assert Cell(name, *tiny_bench).reference() is rigid
    assert (reference.render_rows, reference.check_supported,
            reference.SUPPORTED) == (rigid.render_rows, rigid.check_supported,
                                     rigid.SUPPORTED)
    cell = Cell(small, *tiny_bench)
    s = dict(cell.generator_settings(2**31 + 5), batch_size=2)
    atlas = procedural_atlas(4, 2 * s["height"], 2 * s["width"], 5, CPU)
    prog = make_generate_fn(
        flowgen_torch.DataGenConfig(**s, render_impl="windowed"), CPU)(
        s["seed"], 1, atlas)
    ref = cell.reference().render_rows(s["seed"], [2, 3], s, atlas)
    assert set(ref) == {"image0", "image1", "flow0"}
    for k in ref:
        assert torch.equal(prog[k], ref[k]), k


@pytest.mark.parametrize("extra", [
    {"mode": 9}, {"mode": 9, "warp_bank_reuse_steps": 4},
    {"compute_inverse_flow": True}, {"emit_masks": True}])
def test_rigid_still_refuses_what_it_cannot_render(tiny_bench, extra):
    s = dict(Cell("tiny_chairs.t", *tiny_bench).generator_settings(3),
             **extra)
    with pytest.raises(ValueError):
        rigid.check_supported(s)
    with pytest.raises(ValueError):
        rigid.render_rows(3, [0], s,
                          torch.zeros(1, 8, 8, 3, dtype=torch.uint8))


def test_a_cell_its_reference_cannot_render_is_not_correct(named):
    """As before: the run ends, every compared number reads infinite."""
    cell = Cell("tiny_masks.t", *named)
    assert cell.reference() is rigid
    result, lines = run.run_cell(cell, 2**31 + 19, 2.5, False, CPU)
    assert result["correct"] is False and result["attempted"] >= 1
    assert {k: v["value"] for k, v in result["checks"].items()} == {
        "flow_max_px": float("inf"), "image_share_ge1": float("inf")}


def _mark(name, start_ms, end_ms):
    return Event(name, "user_annotation", int(start_ms * MS),
                 int(end_ms * MS), 0, False)


def test_an_idle_gap_goes_to_the_span_that_holds_it():
    """The device idles from 1 to 9 ms, inside the precompute's span; the
    adapt span is shorter but starts after the gap's middle."""
    pre, adapt = _mark("flowgen.precompute", 0.5, 9), _mark("flowgen.adapt",
                                                            8.5, 8.6)
    assert _innermost([], [], [pre, adapt], 5 * MS) == "flowgen.precompute"
    assert _innermost([], [], [pre, adapt], int(8.55 * MS)) == "flowgen.adapt"
    assert _innermost([], [], [adapt], 5 * MS) == "(no host op)"
    events = [_mark("perfbench.step", 0, 10), pre, adapt,
              Event("cudaLaunchKernel", "cuda_runtime", 0, 1, 1, False),
              Event("cudaLaunchKernel", "cuda_runtime", 2, 3, 2, False),
              Event("void k(float*)", "kernel", 0, 1 * MS, 1, True),
              Event("void k(float*)", "kernel", 9 * MS, 10 * MS, 2, True)]
    gaps = summarize(events, steps=1)["idle_gaps"]
    assert gaps == [["flowgen.precompute", pytest.approx(0.008)]]


@pytest.fixture
def cpu_runs(tiny_bench, monkeypatch):
    """``run.main`` and ``spans.main`` on the CPU over ``tiny_bench``: the
    card's check passes with the CPU, and a cell loads from the fixture."""
    monkeypatch.setattr(run, "card", lambda chips: CPU)
    monkeypatch.setattr(run, "use_caches", lambda: None)
    monkeypatch.setattr(Cell.__init__, "__defaults__", tiny_bench)
    # spans.main replaces it; restored after the test
    monkeypatch.setattr(run, "summarize_with_spans",
                        run.summarize_with_spans)
    return tiny_bench


def _last_json(text):
    return json.loads(text.strip().splitlines()[-1])


def test_the_traced_record_feeds_the_span_readers(cpu_runs, capsys):
    assert run.main(["--workload", "tiny_chairs.t", "--seed",
                     str(2**31 + 23), "--seconds", "5", "--trace", "1"]) == 0
    result = _last_json(capsys.readouterr().out)
    assert result["correct"] is True
    got = {m: result["metrics"].get(m, {}).get("value")
           for m in spans.METRICS}
    assert None not in got.values(), got
    # the CPU launches no CUDA kernel, copy or synchronize; the host runs
    assert got["sampler_kernels_per_step"] == 0
    assert got["precompute_kernels_per_step"] == 0
    assert got["host_syncs_per_step"] == got["h2d_copies_per_step"] == 0
    assert got["sampler_host_ms"] > 0 and got["precompute_host_ms"] > 0
    assert "flowgen.adapt" not in [n for n, _ in
                                   result["breakdown"]["idle_gaps"][:1]]


def test_the_span_tool_still_prints_its_table(cpu_runs, capsys):
    assert spans.main(["--workload", "tiny_chairs.t", "--seed",
                       str(2**31 + 29), "--seconds", "5"]) == 0
    line = _last_json(capsys.readouterr().out)
    assert line["cell"] == "tiny_chairs.t"
    assert set(line["metrics"]) == set(spans.METRICS)
    assert {"flowgen.step", "flowgen.sampler",
            "flowgen.precompute"} <= set(line["spans"])


def _outputs(masks=True):
    g = torch.Generator().manual_seed(0)
    out = {"image0": torch.rand(2, 4, 6, 3, generator=g) * 255,
           "image1": torch.rand(2, 4, 6, 3, generator=g) * 255,
           "flow0": torch.randn(2, 4, 6, 2, generator=g)}
    if masks:
        out["occlusion"] = torch.rand(2, 4, 6, generator=g) > 0.5
        out["motion_boundary"] = torch.rand(2, 4, 6, generator=g) > 0.8
    return out


def test_integer_and_boolean_outputs_are_compared_exactly():
    ref = _outputs()
    same = {k: v.clone() for k, v in ref.items()}
    assert compare.numbers(same, ref) == {
        "flow_max_px": 0.0, "image_share_ge1": 0.0, "int_mismatch_share": 0.0}
    flipped = dict(same, occlusion=same["occlusion"].clone())
    flipped["occlusion"][1, 2, 3] ^= True
    got = compare.numbers(flipped, ref)
    assert got["int_mismatch_share"] == pytest.approx(1 / 96)
    assert got["flow_max_px"] == 0.0 and got["image_share_ge1"] == 0.0
    limits = {"flow_max_px": 0.01, "image_share_ge1": 0.2,
              "int_mismatch_share": 0.0}
    assert compare.judge(compare.numbers(same, ref), limits)
    assert not compare.judge(got, limits)
    # a number with no limit fails: today's limits cannot pass masks
    assert not compare.judge(compare.numbers(same, ref),
                             {"flow_max_px": 0.01, "image_share_ge1": 0.2})
    # an integer output missing or of another shape is infinitely far
    missing = {k: v for k, v in same.items() if k != "motion_boundary"}
    assert compare.numbers(missing, ref)["int_mismatch_share"] == float("inf")


def test_without_integer_outputs_the_numbers_are_as_before():
    ref = _outputs(masks=False)
    assert set(compare.numbers(ref, ref)) == {"flow_max_px",
                                              "image_share_ge1"}


def test_an_output_with_no_rule_is_refused():
    ref = dict(_outputs(masks=False), depth=torch.zeros(2, 4, 6))
    with pytest.raises(ValueError, match="depth"):
        compare.numbers(ref, ref)
