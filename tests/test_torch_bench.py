"""``bench_torch.py``, the port's benchmark, held against ``bench.py``
itself on the CPU: the rate and spread bit for bit on scripted clocks, the
pipelined depth cap, the steps each cell times and their order, the JSON
keys of every form (``bench.py``'s less ``vs_baseline``), one real cell on
the CPU, its imports, and that it never runs on the CPU unless asked."""

import importlib.util
import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flowgen
import flowgen.utils.profiling
import flowgen_torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import bench_torch  # noqa: E402


@pytest.fixture
def bench(monkeypatch):
    """``bench.py`` loaded from its file, unchanged. Its compile-cache
    variables are set first, so its ``setdefault`` changes nothing, and its
    cache switch is stubbed, so nothing is written."""
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "unused")
    monkeypatch.setenv("JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS", "2")
    monkeypatch.setattr(flowgen.utils.profiling, "enable_compile_cache",
                        lambda *a, **k: None)
    spec = importlib.util.spec_from_file_location(
        "bench_under_test", os.path.join(ROOT, "bench.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _Clock:
    """``time.perf_counter`` read twice a step: the step's start, then its
    start plus the scripted duration."""

    def __init__(self, durations):
        vals, t = [], 1000.0
        for d in durations:
            vals += [t, t + d]
            t += 0.25 + d
        self._it = iter(vals)

    def perf_counter(self):
        return next(self._it)


def _durations():
    rng = np.random.default_rng(0)
    return {
        # Mode 9's two groups: a bank epoch built on every odd step.
        "two-group 6": [0.31, 0.12, 0.30, 0.11, 0.32, 0.12],
        "ties 6": [0.1, 0.1, 0.1, 0.1, 0.1, 0.1],
        "random 7": list(rng.uniform(0.05, 0.3, 7)),
        "ties 8": [0.1, 0.1, 0.1, 0.2, 0.2, 0.1, 0.3, 0.1],
        "random 32": list(rng.uniform(0.05, 0.3, 32)),
        "two-group 32": [0.2 + 0.1 * (i % 2) for i in range(32)],
    }


@pytest.mark.parametrize("name", list(_durations()))
def test_measure_matches_bench(bench, monkeypatch, name):
    d = _durations()[name]
    monkeypatch.setattr(bench, "time", _Clock(d))
    monkeypatch.setattr(bench_torch, "time", _Clock(d))
    rate, spread = bench._measure(lambda r, s, a: None, lambda o: 0.0,
                                  None, None, 64, len(d))
    got = bench_torch._measure(lambda r, s, a: None, lambda o: 0.0,
                               None, None, 64, len(d))
    assert got[:2] == (rate, spread)
    clock = _Clock(d)
    want = []
    for _ in d:
        t0 = clock.perf_counter()
        want.append(clock.perf_counter() - t0)
    assert got[2] == want                    # in step order, not sorted


@pytest.mark.parametrize("batch", [1, 2, 8, 64, 512])
@pytest.mark.parametrize("n_steps", [6, 32, 1000])
def test_pipelined_depth_matches_bench(bench, monkeypatch, batch, n_steps):
    runs = {}
    for name, mod in (("jax", bench), ("torch", bench_torch)):
        monkeypatch.setattr(mod, "time", _Clock([0.5]))
        steps, probed = [], []
        rate = mod._measure_pipelined(
            lambda r, s, a: steps.append(int(s)) or len(steps),
            lambda o: probed.append(o) or 0.0, None, None, batch, n_steps)
        assert probed == [len(steps)]        # one read, of the last output
        runs[name] = (steps, rate)
    assert runs["torch"] == runs["jax"]
    cap = min(n_steps, max(4, int(3e9 / (6.2e6 * batch))))
    assert runs["torch"][0] == list(range(100, 100 + cap))


def _recorder(steps, zeros):
    def make_generate_fn(cfg, *args, **kwargs):
        def fn(root, step, atlas):
            steps.append(int(step))
            return {"flow0": zeros((2, 4, 4, 2), "f"),
                    "image1": zeros((2, 4, 4, 3), "u")}
        return fn
    return make_generate_fn


def _jnp_zeros(shape, kind):
    return jnp.zeros(shape, jnp.float32 if kind == "f" else jnp.uint8)


def _torch_zeros(shape, kind):
    return torch.zeros(shape, dtype=torch.float32 if kind == "f"
                       else torch.uint8)


@pytest.mark.parametrize("mode,batch,n_steps,pipelined", [
    (7, 64, 32, True), (9, 64, 6, True), (1, 64, 6, False),
    (7, 2, 8, True), (13, 512, 6, False)])
def test_step_sequence_matches_bench(bench, monkeypatch, mode, batch, n_steps,
                                     pipelined):
    atlas = np.zeros((1, 4, 4, 3), np.uint8)
    jax_steps, torch_steps = [], []
    monkeypatch.setattr(flowgen, "make_generate_fn",
                        _recorder(jax_steps, _jnp_zeros))
    monkeypatch.setattr(flowgen_torch, "make_generate_fn",
                        _recorder(torch_steps, _torch_zeros))
    bench._bench_mode(mode, batch, n_steps, atlas, pipelined=pipelined)
    bench_torch._bench_mode(mode, batch, n_steps, atlas, pipelined=pipelined,
                            device="cpu")
    depth = min(n_steps, max(4, int(3e9 / (6.2e6 * batch))))
    want = [0] + list(range(1, n_steps + 1)) + (
        list(range(100, 100 + depth)) if pipelined else [])
    assert torch_steps == jax_steps == want


FORMS = [[], ["7"], ["9", "16"], ["reuse3"], ["texdb", "8"], ["train"],
         ["train", "8", "5"]]


def _keys(payload):
    """The payload's keys in order, and those of its dict values."""
    return [(k, list(v) if isinstance(v, dict) else None)
            for k, v in payload.items()]


@pytest.mark.parametrize("form", FORMS, ids=lambda f: " ".join(f) or "default")
def test_json_keys_match_bench(bench, monkeypatch, capsys, form):
    small = np.zeros((32, 4, 4, 3), np.uint8)
    monkeypatch.setattr(flowgen, "procedural_atlas", lambda *a, **k: small)
    monkeypatch.setattr(bench, "_bench_mode", lambda *a, **k: (1.0, 2.0, 0.1))
    monkeypatch.setattr(bench, "_bench_reuse3",
                        lambda *a, **k: (1.0, 2.0, 0.1, 12))
    monkeypatch.setattr(bench, "_bench_texdb", lambda *a, **k: (1.0, 2.0, 0.1))
    monkeypatch.setattr(bench, "_bench_train", lambda *a, **k: (1.0, 0.5))
    monkeypatch.setattr(sys, "argv", ["bench.py"] + form)
    bench.main()
    (line,) = capsys.readouterr().out.strip().splitlines()
    want = json.loads(line)
    assert "vs_baseline" in want
    del want["vs_baseline"]

    cell = bench_torch.Cell(1.0, 2.0, 0.1, [], None)
    monkeypatch.setattr(flowgen_torch, "procedural_atlas",
                        lambda *a, **k: small)
    monkeypatch.setattr(bench_torch, "_bench_mode", lambda *a, **k: cell)
    monkeypatch.setattr(bench_torch, "_bench_reuse3",
                        lambda *a, **k: (cell, 12))
    monkeypatch.setattr(bench_torch, "_bench_texdb", lambda *a, **k: cell)
    monkeypatch.setattr(bench_torch, "_bench_train", lambda *a, **k: (1.0, 0.5))
    bench_torch.main(form + ["--device", "cpu"])
    (line,) = capsys.readouterr().out.strip().splitlines()
    got = json.loads(line)
    assert _keys(got) == _keys(want)
    assert got == want                       # the same readings, same line


def test_texdb_form_prints_one_line(monkeypatch, capsys):
    """The database's sources are built as bench.py builds them, and what
    the loader prints goes to standard error: one line on standard out."""
    seen = []
    monkeypatch.setattr(bench_torch, "_bench_mode",
                        lambda *a, **k: seen.append(a[3])
                        or bench_torch.Cell(1.0, 2.0, 0.1, [], None))
    bench_torch.main(["texdb", "2", "--device", "cpu"])
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 1 and json.loads(out[0])["batch"] == 2
    (db,) = seen
    assert isinstance(db, flowgen_torch.TextureDB)
    assert db.sources.shape[:3] == (32, 1200, 1600)
    assert {tuple(int(n) for n in hw) for hw in np.asarray(db.sizes)} == {
        (768, 1024), (600, 800), (1200, 1600), (384, 512), (200, 300),
        (150, 180), (900, 700)}


def test_one_cell_on_cpu():
    cfg = {"height": 96, "width": 128}
    atlas = flowgen_torch.procedural_atlas(4, **cfg)
    cell = bench_torch._bench_mode(7, 2, 3, atlas, device="cpu",
                                   cfg_kwargs=cfg)
    assert np.isfinite(cell.rate) and cell.rate > 0
    assert cell.spread >= 0
    assert len(cell.step_s) == 3 and cell.pipelined is None
    assert cell.peak_gib is None             # no device memory on the CPU


def test_imports_neither_jax_nor_the_jax_package():
    code = ("import sys, bench_torch; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flowgen')]; print(bad); "
            "sys.exit(1 if bad else 0)")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


@pytest.mark.parametrize("form", [[], ["7"], ["train"]])
def test_main_raises_without_a_card(monkeypatch, capsys, form):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        bench_torch.main(form)
    assert capsys.readouterr().out == ""
