"""The comparison that decides ``correct``, on the CPU at small sizes: the
reference against the port's plain paths, a run with its timed path broken
underneath (each fault must read as not correct), and the control (the
reference in bfloat16), which every cell's limits must refuse."""

import random

import pytest
import torch

from perfbench import calibrate, compare, importcheck, reference, run
from perfbench.atlas import procedural_atlas
from perfbench.cells import Cell

CPU = torch.device("cpu")


def _port_rows(settings, atlas, step):
    import flowgen_torch
    from flowgen_torch.pipeline.generator import make_generate_fn

    cfg = flowgen_torch.DataGenConfig(**settings)
    return make_generate_fn(cfg, CPU)(settings["seed"], step, atlas)


@pytest.mark.parametrize("cell,photo", [("tiny_chairs.t", False),
                                        ("tiny_chairs.t_photo", True),
                                        ("tiny_windowed.t", False)])
def test_reference_against_the_port_plain_path(tiny_bench, cell, photo):
    c = Cell(cell, *tiny_bench)
    s = c.generator_settings(2**31 + 5)
    assert s["photometric_augment"] is photo
    if cell == "tiny_windowed.t":
        s["batch_size"] = 2
    atlas = procedural_atlas(4, 2 * s["height"], 2 * s["width"], 5, CPU)
    prog = _port_rows(s, atlas, 1)
    B = s["batch_size"]
    ref = reference.render_rows(s["seed"], list(range(B, 2 * B)), s, atlas)
    got = compare.numbers(prog, ref)
    assert got["flow_max_px"] == 0.0
    if cell == "tiny_windowed.t":
        # the windowed renderer's plain path is the reference's arithmetic
        assert got["image_share_ge1"] == 0.0
        for k in ref:
            assert torch.equal(prog[k], ref[k]), k
    assert compare.judge(got, c.limits)


def _faulty(monkeypatch, fault):
    from flowgen_torch.pipeline import generator

    orig = generator.Generator._dispatch
    first = {}

    def dispatch(self):
        out = orig(self)
        if fault == "state unchanged":
            return first.setdefault("out", out)
        out = {k: v.clone() for k, v in out.items()}
        if fault == "half the batch left out":
            for v in out.values():
                v[v.shape[0] // 2:] = 0
        elif fault == "an answer altered":
            out["flow0"][:, 7, 9, 0] += 0.05
        return out

    monkeypatch.setattr(generator.Generator, "_dispatch", dispatch)


@pytest.mark.parametrize("fault", [None, "state unchanged",
                                   "half the batch left out",
                                   "an answer altered"])
def test_a_broken_timed_path_is_not_correct(tiny_bench, monkeypatch, fault):
    if fault is not None:
        _faulty(monkeypatch, fault)
    cell = Cell("tiny_chairs.t", *tiny_bench)
    result, lines = run.run_cell(cell, 2**31 + 11, 2.5, False, CPU)
    assert result["attempted"] >= 2
    assert result["correct"] is (fault is None), (fault, result["checks"])
    assert list(result)[-1] == "checks"
    assert lines[-2:] == [f"check {k}: {v['value']!r} limit {v['limit']!r}"
                          for k, v in result["checks"].items()]
    assert importcheck.loaded() == []


@pytest.mark.parametrize("name,small", [
    ("chairs_m7.trainer", "tiny_chairs.t"),
    ("chairs_m7.trainer_photo", "tiny_chairs.t_photo"),
    ("chairs_m7.trainer", "tiny_windowed.t")])
def test_the_control_fails_every_cell(tiny_bench, name, small):
    """The control at a small size on three seeds, against the limits of
    the cell whose configuration it shrinks."""
    limits = Cell(name, *tiny_bench).limits
    cell = Cell(small, *tiny_bench)
    for seed in (3, 2**31 + 1, 77):
        got = calibrate.control(cell, seed, CPU, batches=4)
        assert not compare.judge(got, limits), (seed, got)


def test_rows_are_drawn_from_both_halves_and_the_last_batch():
    keeper = compare.RowKeeper(4, 8, random.Random(1))
    for step in range(2, 50):
        keeper.offer(step, None)
    keeper.last(49, None)
    idx = [i for i, _ in keeper.kept]
    assert len(idx) == 5 and idx[-1] // 8 == 49
    halves = [(i % 8) // 4 for i in idx[:4]]
    assert halves == [0, 1, 0, 1]
    again = compare.RowKeeper(4, 8, random.Random(1))
    for step in range(2, 50):
        again.offer(step, None)
    again.last(49, None)
    assert [i for i, _ in again.kept] == idx
