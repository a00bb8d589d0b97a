"""Cells, configurations, traffic mixes, limits and per-layer metrics are
found by name, and a new one is added with new files alone."""

import json
import re

import pytest

from perfbench.cells import BENCHMARK, HERE, Cell

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_every_cell_of_the_benchmark_loads():
    bench = json.loads(BENCHMARK.read_text())
    for w in bench["workloads"]:
        cell = Cell(w["name"])
        assert cell.config["name"] == w["config"]
        assert cell.traffic["name"] == w["traffic"]
        assert set(cell.limits) == {"flow_max_px", "image_share_ge1"}
        s = cell.generator_settings(2**31 + 7)
        assert s["batch_size"] == cell.config["generator"]["batch_size"]
        assert s["seed"] == 2**31 + 7
        assert {m["name"] for m in cell.end_to_end()} >= {"setup_s"}
        assert len(cell.end_to_end()) >= 2 and cell.per_layer()
        for m in cell.per_layer():
            assert callable(cell.reader(m["name"]))


def test_the_configuration_is_its_source_as_it_stands():
    """example-prototxt/train.prototxt: data_param batch_size 8, prefetch
    40, mode 7, the layer's 512x384 frames, antialiasing at its default."""
    g = Cell("chairs_m7.trainer").config["generator"]
    assert g == {"mode": 7, "width": 512, "height": 384, "batch_size": 8,
                 "prefetch": 40, "use_antialiasing": True}


def test_benchmark_json_keeps_the_contract_shape():
    bench = json.loads(BENCHMARK.read_text())
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["perfbench"]
    names = [c["name"] for c in bench["configs"]]
    for c in bench["configs"]:
        assert (HERE.parent / c["file"]).is_file()
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in bench["workloads"]:
        assert w["config"] in names and w["chips"] == 1
        assert len(w["why"]) <= 200
    cells = {w["name"] for w in bench["workloads"]}
    e2e = {m["name"] for m in bench["end_to_end"]}
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= cells
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
        assert (HERE / "metrics" / f"{m['name']}.py").is_file()
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25


def test_a_new_cell_config_mix_and_metric_are_files_alone(tiny_bench, tmp_path):
    bench_path, base = tiny_bench
    before = {p: p.read_bytes() for p in base.rglob("*") if p.is_file()}
    (base / "metrics" / "rows_per_batch.py").write_text(
        "def read(rec):\n    return float(rec['settings']['batch_size'])\n")
    bench = json.loads(bench_path.read_text())
    bench["per_layer"].append({
        "name": "rows_per_batch", "unit": "rows", "better": "higher",
        "source": "host_clock", "layer": "runtime", "moves": "batch_wait_p95_ms",
        "workloads": ["tiny_chairs.t"]})
    bench_path.write_text(json.dumps(bench))
    cell = Cell("tiny_chairs.t", bench_path, base)
    assert cell.generator_settings(3)["width"] == 128
    assert cell.generator_settings(3)["batch_size"] == 4
    assert "rows_per_batch" in {m["name"] for m in cell.per_layer()}
    assert cell.reader("rows_per_batch")({"settings": {"batch_size": 4}}) == 4.0
    other = Cell("tiny_windowed.t", bench_path, base)
    assert "rows_per_batch" not in {m["name"] for m in other.per_layer()}
    for p, data in before.items():
        assert p.read_bytes() == data


def test_a_cell_that_is_not_there_is_refused(tiny_bench):
    bench_path, base = tiny_bench
    with pytest.raises(KeyError):
        Cell("no_such.cell", bench_path, base)
    with pytest.raises(ValueError):
        Cell("tiny_chairs.t", bench_path, base).reader("../run")
