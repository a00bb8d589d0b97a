"""Mode 9's reference (``reference/nonrigid.py``, ``reference/warpbank.py``),
the warp bank's byte counts (``bankbytes.py``) and its readers, on the CPU
at 256x192 (big fields of 768), B=2: the reference's bank bit for bit
against the port's plain bank, the port's batch against the reference, the
refused settings, the control, the readers and the byte counts."""

import json
import shutil

import pytest
import torch

from perfbench import bankbytes, compare, run
from perfbench.atlas import procedural_atlas
from perfbench.cells import BENCHMARK, HERE, Cell
from perfbench.reference import nonrigid, warpbank
from perfbench.reference.scenes import MODES, sample_scene
from perfbench.reference.streams import root_key, sample_key

CPU = torch.device("cpu")
W, H, B = 256, 192, 2
# Seed 0's step 2 holds a deforming background in both rows and four
# deforming objects in each (epoch 1 at two steps an epoch).
SEED, STEP = 0, 2
SETTINGS = {"mode": 9, "width": W, "height": H, "batch_size": B,
            "prefetch": 2, "use_antialiasing": True,
            "warp_fields_per_batch": 2, "warp_bank_reuse_steps": 2,
            "warp_bank_impl": "pallas", "warp_oob": "zero",
            "photometric_augment": False, "seed": SEED}
ROWS = list(range(STEP * B, STEP * B + B))


def _cfg(**kw):
    import flowgen_torch

    return flowgen_torch.DataGenConfig(**dict(SETTINGS, **kw))


@pytest.fixture(scope="module")
def port_epoch():
    """The port's plain bank and warp planes of the rows' epoch, with the
    shapes of every bank launch it made: (WarpAux, hwarp_rows planes and
    displacement shapes, coarse_gdisp_batch field shapes)."""
    from flowgen_torch.random import streams
    from flowgen_torch.warpfields import compose
    from flowgen_torch.warpfields import generator as warpgen

    hw, cg = [], []
    orig_h, orig_c = compose.hwarp_rows, compose.coarse_gdisp_batch

    def hwarp_rows(planes, disp):
        hw.append((tuple(planes.shape), tuple(disp.shape)))
        return orig_h(planes, disp)

    def coarse_gdisp_batch(D, stride=4, n_iter=8):
        cg.append((tuple(D.shape), stride))
        return orig_c(D, stride, n_iter)

    compose.hwarp_rows = hwarp_rows
    compose.coarse_gdisp_batch = coarse_gdisp_batch
    try:
        _, aux = warpgen.make_bank_and_aux(streams.root_key(SEED), STEP,
                                           _cfg())
    finally:
        compose.hwarp_rows, compose.coarse_gdisp_batch = orig_h, orig_c
    return aux, hw, cg


def test_the_rows_deform_background_and_objects():
    sc = sample_scene(sample_key(root_key(SEED), torch.tensor(ROWS)),
                      MODES[9], width=W, height=H,
                      n_warp_slots=warpbank.n_slots(W, H, 2))
    assert sc.background.warp.all()
    assert ((sc.objects.warp & sc.objects.valid).sum(-1) >= 2).all()


def test_reference_bank_equals_the_ports_bit_for_bit(port_epoch):
    """Every slot's object planes and the background's planes over 96 rows
    beyond the frame on both sides, bit for bit (NaN-free, zeros signed)."""
    aux = port_epoch[0]
    ep = warpbank.Epoch(root_key(SEED), STEP // 2, W, H, 2)
    rows = torch.arange(-96, H + 96)
    assert aux.obj.shape[0] == warpbank.n_slots(W, H, 2) == 80
    for s in range(aux.obj.shape[0]):
        for got, want in ((ep.obj_planes(s), aux.obj[s]),
                          (ep.bg_planes(s, rows), aux.bg[s])):
            assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    # the composed fields move pixels by tens of them
    assert float(aux.obj[:, :2].abs().max()) > 10.0


def _port_batch():
    from flowgen_torch.pipeline.generator import generate_batch

    atlas = procedural_atlas(4, 2 * H, 2 * W, SEED, CPU)
    return atlas, generate_batch(SEED, STEP, atlas, _cfg(), device=CPU)


def test_port_batch_against_the_reference(monkeypatch):
    """The port's plain scene kernel against the reference: flow0 exactly,
    images within the cell's limit; the deformations matter (without them
    frame 1 reads far off)."""
    atlas, prog = _port_batch()
    ref = nonrigid.render_rows(SEED, ROWS, SETTINGS, atlas)
    got = compare.numbers(prog, ref)
    limits = Cell("chairs_m9.trainer").limits
    assert got["flow_max_px"] == 0.0
    assert got["image_share_ge1"] < limits["image_share_ge1"]
    assert compare.judge(got, limits)
    monkeypatch.setattr(nonrigid, "_warped_object", lambda *a: None)
    monkeypatch.setattr(nonrigid, "_warped_background",
                        lambda bg, tex, H, W, epoch, q:
                        nonrigid._background(bg, tex, H, W, q)[1])
    flat = nonrigid.render_rows(SEED, ROWS, SETTINGS, atlas)
    far = float(((prog["image1"] - flat["image1"]).abs() >= 1).float().mean())
    assert far > 10 * got["image_share_ge1"]


@pytest.mark.parametrize("change", [
    {"warp_bank_impl": "xla"}, {"warp_oob": "nan"},
    {"compute_inverse_flow": True}, {"emit_masks": True},
    {"render_impl": "windowed"}, {"texture_db": "x"},
    {"width": 136, "height": 100}, {"width": 128, "height": 96}])
def test_settings_it_does_not_restate_are_refused(change):
    with pytest.raises(ValueError):
        nonrigid.check_supported(dict(SETTINGS, **change))


@pytest.mark.parametrize("key", ["warp_fields_per_batch",
                                 "warp_bank_reuse_steps"])
def test_the_bank_settings_must_be_stated(key):
    s = {k: v for k, v in SETTINGS.items() if k != key}
    with pytest.raises(ValueError, match=key):
        nonrigid.check_supported(s)


def test_the_control_fails_both_limits():
    atlas = procedural_atlas(4, 2 * H, 2 * W, SEED, CPU)
    ref = nonrigid.render_rows(SEED, ROWS, SETTINGS, atlas)
    low = nonrigid.render_rows(SEED, ROWS, SETTINGS, atlas, lowp=True)
    got = compare.numbers(low, ref)
    limits = Cell("chairs_m9.trainer").limits
    assert got["flow_max_px"] > limits["flow_max_px"]
    assert got["image_share_ge1"] > limits["image_share_ge1"]


def test_a_tiny_mode9_cell_runs_correct(tmp_path):
    """The cell's configuration at 256x192, B=2, prefetch 2, through
    ``run.run_cell``: its reference is ``nonrigid`` and the run is
    correct."""
    base = tmp_path / "perfbench"
    for d in ("configs", "traffic", "limits", "metrics"):
        shutil.copytree(HERE / d, base / d)
    cfg = json.loads((base / "configs" / "chairs_m9.json").read_text())
    cfg.update(name="tiny_m9")
    cfg["generator"].update(width=W, height=H, batch_size=B, prefetch=2)
    cfg["atlas"]["textures"] = 4
    (base / "configs" / "tiny_m9.json").write_text(json.dumps(cfg))
    t = json.loads((base / "traffic" / "trainer.json").read_text())
    t.update(name="t", compare_rows=2, profile_steps=2, warmup_batches=1)
    (base / "traffic" / "t.json").write_text(json.dumps(t))
    shutil.copy(base / "limits" / "chairs_m9.trainer.json",
                base / "limits" / "tiny_m9.t.json")
    bench = json.loads(BENCHMARK.read_text())
    bench["workloads"].append({"name": "tiny_m9.t", "config": "tiny_m9",
                               "traffic": "t", "chips": 1, "why": "CPU"})
    path = tmp_path / "BENCHMARK.json"
    path.write_text(json.dumps(bench))
    cell = Cell("tiny_m9.t", path, base)
    assert cell.reference() is nonrigid
    result, _ = run.run_cell(cell, 2**31 + 3, 0.5, False, CPU)
    assert result["attempted"] >= 1
    assert result["correct"], result["checks"]
    assert result["checks"]["flow_max_px"]["value"] == 0.0


MS = 1e-3


def _record(spans=None, kernels=()):
    trace = {"steps": 2, "window_s": 0.1, "busy_s": 0.05,
             "kernels": list(kernels), "device_ops": [], "idle_gaps": []}
    if spans is not None:
        trace["spans"] = spans
    return {"settings": {"mode": 9, "width": 512, "height": 384,
                         "batch_size": 8, "warp_fields_per_batch": 2,
                         "warp_bank_reuse_steps": 2},
            "trace": trace}


def _read(metric, rec):
    return Cell("chairs_m9.trainer").reader(metric)(rec)


def test_bank_readers_on_a_synthetic_record():
    row = {"calls": 0.5, "host_s": 40 * MS, "self_s": 1 * MS,
           "kernels": 3.0, "device_s": 0.1 * MS, "syncs": 0, "h2d": 0,
           "idle_s": 0.0, "inclusive": {"kernels": 7000.0,
                                        "device_s": 2.5 * MS, "syncs": 0,
                                        "h2d": 0}}
    kernels = ([("void hwarp_rows_kernel(float const*)", 0.4 * MS)] * 10
               + [("void coarse_solve_kernel<4>(CoarseSrc<4>)", 0.01 * MS)] * 4
               + [("upsample4_kernel(float const*, float*)", 0.005 * MS)] * 4
               + [("void scene_kernel<true>(SceneParams)", 0.5 * MS)] * 2)
    rec = _record({"flowgen.bank_epoch": row}, kernels)
    assert _read("bank_epoch_ms", rec) == pytest.approx(40.0)
    assert _read("bank_kernels_per_step", rec) == 7000.0
    assert _read("bank_device_ms", rec) == pytest.approx(2.5)
    s = rec["settings"]
    # 10 hwarp_rows launches in 4 ms: 10/34 of an epoch's bytes
    assert _read("hwarp_rows_roofline", rec) == pytest.approx(
        100 * 10 / 34 * bankbytes.hwarp_epoch_bytes(s) / 3.35e12 / 4e-3)
    # 4 solves (4/18 of an epoch) and their upsamples in 0.06 ms
    assert _read("coarse_gdisp_roofline", rec) == pytest.approx(
        100 * 4 / 18 * bankbytes.solve_epoch_bytes(s) / 3.35e12 / 6e-5)
    # two launches, a step's bytes each, in 1 ms
    assert _read("scene_kernel_warp_roofline", rec) == pytest.approx(
        100 * 2 * 8 * 384 * 512 * (16 + 16 * 0.2) / 3.35e12 / 1e-3)
    # whole epochs read the same share over any number of profiled steps
    epoch = ([("void hwarp_rows_kernel(float const*)", 0.05 * MS)] * 34
             + [("void coarse_solve_kernel<4>(CoarseSrc<4>)", 0.01 * MS)]
             * 18 + [("upsample4_kernel(float const*, float*)", 0.005 * MS)]
             * 18)
    for steps in (2, 6, 16):
        many = _record({"flowgen.bank_epoch": row}, epoch * (steps // 2))
        many["trace"]["steps"] = steps
        assert _read("hwarp_rows_roofline", many) == pytest.approx(
            100 * bankbytes.hwarp_epoch_bytes(s) / 3.35e12 / 1.7e-3)
    # a mode-7 record has no bank: its settings name no bank fields
    m7 = _record({}, kernels[-2:])
    del m7["settings"]["warp_fields_per_batch"]
    assert _read("hwarp_rows_roofline", m7) is None
    assert _read("coarse_gdisp_roofline", m7) is None
    # nothing to read: no span table, no such span, no such kernel
    bare = _record(None)
    for m in ("bank_epoch_ms", "bank_kernels_per_step", "bank_device_ms",
              "hwarp_rows_roofline", "coarse_gdisp_roofline",
              "scene_kernel_warp_roofline"):
        assert _read(m, bare) is None, m
        assert _read(m, _record({})) is None, m
        assert _read(m, dict(bare, trace=None)) is None, m


def test_bank_bytes_against_the_launch_shapes(port_epoch):
    """The settings-only counts equal the bytes of the launches one epoch
    made (10 bytes an hwarp_rows element, the solve's strided reads and
    its plane), and the cell's epoch is 34 launches and 18 calls."""
    _, hw, cg = port_epoch
    assert len(hw) == 34 and len(cg) == 18
    from math import prod
    hbytes = sum(4.0 * (2 * prod(p) + prod(d)) for p, d in hw)
    cbytes = sum(4.0 * (2 * N * (h // s) * (w // s) + N * h * w)
                 for (N, h, w, _), s in cg)
    small = dict(SETTINGS)
    assert bankbytes.hwarp_epoch_bytes(small) == hbytes
    assert bankbytes.solve_epoch_bytes(small) == cbytes
    cell = Cell("chairs_m9.trainer").generator_settings(1)
    # 512x384: 16 doublings of (4, 2, 768, 768) and one of 1536, 2 launches
    # each; 10 bytes an element
    assert bankbytes.hwarp_epoch_bytes(cell) == 10 * (
        32 * 4 * 2 * 768 ** 2 + 2 * 4 * 2 * 1536 ** 2) == 1_887_436_800
    assert bankbytes.solve_epoch_bytes(cell) == 4 * (
        16 * (2 * 4 * 192 ** 2 + 4 * 768 ** 2)
        + (2 * 4 * 384 ** 2 + 4 * 1536 ** 2)
        + (2 * 2 * 384 ** 2 + 2 * 1536 ** 2))
