"""The port's layer spans (``flowgen_torch/utils/profiling.py:span``): where
they sit in a ``torch.profiler`` trace of ``Generator`` steps, that they
change no output, and that without a profiler they cost no
``record_function``."""

import contextlib
import json

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import flowgen_torch
from flowgen_torch.pipeline.generator import BankEpochCache
from flowgen_torch.random import streams
from flowgen_torch.utils import profiling

torch.set_num_threads(1)

STEP = "flowgen.step"
FUSED = ("flowgen.sampler", "flowgen.precompute", "flowgen.scene_kernel",
         "flowgen.unpack", "flowgen.adapt")


def _generator(**kw):
    c = dict(mode=7, batch_size=1, width=128, height=96, prefetch=1)
    c.update(kw)
    cfg = flowgen_torch.DataGenConfig(**c)
    atlas = flowgen_torch.procedural_atlas(2, height=2 * cfg.height,
                                           width=2 * cfg.width)
    return flowgen_torch.Generator(cfg, atlas=atlas, device="cpu")


def _batches(gen, n):
    out = [gen.retrieve_batch() for _ in range(n)]
    gen.stop()
    return out


def _spans(prof, tmp_path):
    """The profile's ``flowgen.*`` host spans as (name, start, end) in us,
    read from its Chrome trace."""
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    return [(e["name"], e["ts"], e["ts"] + e["dur"]) for e in events
            if e.get("cat") == "user_annotation"
            and e["name"].startswith("flowgen.")]


@pytest.mark.parametrize("photometric", [False, True],
                         ids=["plain", "photometric"])
def test_profiled_steps_hold_the_layer_spans(photometric, tmp_path):
    """A profile of the first request, which dispatches two steps (one
    batch in flight): two ``flowgen.step`` spans, each holding the fused
    path's layers once, the photometric span only with the jitter; the two
    batches equal those of steps taken with no profile."""
    want = _batches(_generator(photometric_augment=photometric), 2)
    gen = _generator(photometric_augment=photometric)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        got = [gen.retrieve_batch()]
    got += _batches(gen, 1)
    spans = _spans(prof, tmp_path)
    steps = [s for s in spans if s[0] == STEP]
    assert len(steps) == 2
    layers = set(FUSED) | ({"flowgen.photometric"} if photometric else set())
    for _, lo, hi in steps:
        inside = [n for n, s, e in spans if n != STEP and lo <= s and e <= hi]
        assert sorted(inside) == sorted(layers)
    assert {n for n, _, _ in spans} == layers | {STEP}
    for w, g in zip(want, got):
        assert w.keys() == g.keys()
        for k in w:
            assert torch.equal(w[k], g[k]), k


class _Recorder:
    """Stands in for ``torch.profiler.record_function``: records each span
    as (name, argument, enclosing span's name)."""

    def __init__(self):
        self.open, self.spans = [], []

    @contextlib.contextmanager
    def __call__(self, name, args=None):
        self.spans.append((name, args, self.open[-1] if self.open else None))
        self.open.append(name)
        try:
            yield
        finally:
            self.open.pop()


@pytest.fixture
def recorder(monkeypatch):
    rec = _Recorder()
    monkeypatch.setattr(torch.autograd, "_profiler_enabled", lambda: True)
    monkeypatch.setattr(torch.profiler, "record_function", rec)
    return rec


def _bank_epochs():
    cache = BankEpochCache(lambda root, step: step, reuse=2)
    for step in range(4):
        cache.get(0, step)
        cache.prefetch_next(0, step)


def _two_steps(layers):
    """The spans of a first request's two steps (steps 0 and 1), each a
    ``flowgen.step`` holding ``layers`` as (name, enclosing span); the
    sampler's span carries its argument, ``eager`` on the CPU."""
    arg = {"flowgen.sampler": "eager"}
    return [s for step in ("0", "1") for s in
            [(STEP, step, None)] + [(n, arg.get(n), p) for n, p in layers]]


@pytest.mark.parametrize("run,want", [
    (lambda: _batches(_generator(emit_masks=True), 1),
     _two_steps([("flowgen.sampler", STEP), ("flowgen.precompute", STEP),
                 ("flowgen.scene_kernel", STEP), ("flowgen.unpack", STEP),
                 ("flowgen.masks", "flowgen.unpack"),
                 ("flowgen.adapt", STEP)])),
    (lambda: _batches(_generator(width=64, height=48,
                                 render_impl="windowed", emit_masks=True,
                                 max_objects=2), 1),
     _two_steps([("flowgen.sampler", STEP), ("flowgen.background_pass", STEP),
                 ("flowgen.objects", STEP), ("flowgen.masks", STEP),
                 ("flowgen.adapt", STEP)])),
    (_bank_epochs,
     [("flowgen.bank_epoch", "demand", None),
      ("flowgen.bank_epoch", "ahead", None),
      ("flowgen.bank_epoch", "ahead", None)]),
], ids=["fused_masks", "windowed_masks", "bank_epochs"])
def test_layer_spans_nest_where_the_layers_run(recorder, run, want):
    """The spans of the paths no profiled test above takes, in order, each
    with its argument and the span it nests in."""
    run()
    assert recorder.spans == want


BANK = ("flowgen.bank_epoch", "flowgen.bank_fields", "flowgen.bank_compose",
        "flowgen.bank_aux")


def test_bank_epoch_build_holds_its_phases(recorder):
    """A mode-9 epoch built on demand for the scene kernel's path (256x192,
    one field) enters its three phase spans inside ``flowgen.bank_epoch``,
    in order, and counts as one demand build."""
    from flowgen_torch.pipeline.generator import bank_epoch_stats
    from flowgen_torch.warpfields import generator as warpgen

    cfg = flowgen_torch.DataGenConfig(mode=9, batch_size=1, width=256,
                                      height=192, warp_fields_per_batch=1,
                                      warp_bank_reuse_steps=2)
    cache = BankEpochCache(
        lambda root, step: warpgen.make_bank_and_aux(root, step, cfg)[1],
        cfg.warp_bank_reuse_steps)
    before = bank_epoch_stats()
    aux = cache.get(streams.root_key(5), 0)
    after = bank_epoch_stats()
    assert aux.obj.shape == (40, 4, 192, 256)
    assert recorder.spans == [
        ("flowgen.bank_epoch", "demand", None),
        ("flowgen.bank_fields", None, "flowgen.bank_epoch"),
        ("flowgen.bank_compose", None, "flowgen.bank_epoch"),
        ("flowgen.bank_aux", None, "flowgen.bank_epoch")]
    assert {k: after[k] - before[k] for k in after} == {"demand": 1,
                                                        "ahead": 0}


def test_bank_epoch_stats_count_demand_then_ahead():
    """Four steps at two steps an epoch: the first epoch is built on
    demand, the next two ahead, on each epoch's last step."""
    from flowgen_torch.pipeline.generator import bank_epoch_stats

    before = bank_epoch_stats()
    _bank_epochs()
    after = bank_epoch_stats()
    assert {k: after[k] - before[k] for k in after} == {"demand": 1,
                                                        "ahead": 2}


def test_mode7_step_enters_no_bank_span(recorder):
    """A mode-7 request builds no bank epoch: none of the bank's spans."""
    from flowgen_torch.pipeline.generator import bank_epoch_stats

    before = bank_epoch_stats()
    _batches(_generator(), 1)
    assert recorder.spans and not [s for s in recorder.spans
                                   if s[0] in BANK]
    assert bank_epoch_stats() == before


def test_no_profiler_means_no_record_function(monkeypatch):
    """With no profile running a step enters no ``record_function``: each
    span is the one shared null context."""
    def refuse(*a, **k):
        raise AssertionError("record_function entered with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert not torch.autograd._profiler_enabled()
    out = _batches(_generator(photometric_augment=True), 2)
    assert len(out) == 2 and out[1]["image0"].shape == (1, 96, 128, 3)
    assert profiling.span("flowgen.step", "0") is profiling.span("x")
    with profile(activities=[ProfilerActivity.CPU]):
        with pytest.raises(AssertionError, match="no profiler"):
            profiling.span("flowgen.step")


class _EagerGraph:
    """Stands in for ``sampler._SamplerGraph`` on the CPU: runs eagerly."""

    def __init__(self, dev, n, run):
        self.run = run

    def __call__(self, root, sample_indices):
        return self.run(root, sample_indices)


@pytest.mark.parametrize("graph", [False, True], ids=["eager", "graph"])
def test_sampler_span_carries_how_it_ran(recorder, monkeypatch, graph):
    """The ``flowgen.sampler`` span's argument and the sampler's counters
    say how each call ran: ``eager`` on the CPU; where a graph serves the
    call (stood in for here, as the CPU has none), ``capture`` on its key's
    first call and ``replay`` on every later one."""
    from flowgen_torch.params import sampler

    if graph:
        monkeypatch.setattr(sampler, "_GRAPHS", {})
        monkeypatch.setattr(sampler, "_SamplerGraph", _EagerGraph)
        monkeypatch.setattr(sampler, "_graph_key",
                            lambda root, idx, cfg, slots: ("key", len(idx)))
    cfg = flowgen_torch.DataGenConfig(mode=7, batch_size=2, width=128,
                                      height=96)
    root = streams.root_key(3)
    before = sampler.sampler_graph_stats()
    scenes = [sampler.sample_scene_batch(root, torch.arange(2) + 2 * i, cfg)
              for i in range(3)]
    after = sampler.sampler_graph_stats()
    how = ["capture", "replay", "replay"] if graph else ["eager"] * 3
    assert recorder.spans == [("flowgen.sampler", h, None) for h in how]
    assert {k: after[k] - before[k] for k in after} == {
        k: how.count(k) for k in ("capture", "replay", "eager")}
    want = sampler.sample_scene(
        streams.sample_key(root, torch.arange(4, 6)), cfg.mode_spec,
        width=128, height=96)
    for a, b in zip(want.prims, scenes[2].prims):
        assert torch.equal(a, b)
