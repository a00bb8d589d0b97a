"""The PyTorch port's package surface: its copy of the configuration and the
procedural texture bank match the JAX package, it imports without JAX, and
its entry points render every configuration."""

import ast
import dataclasses
import os
import pkgutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import flowgen
import flowgen.config as jcfg
import flowgen_torch
import flowgen_torch.config as tcfg

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("mode", list(range(1, 14)))
def test_modes_match(mode):
    assert dataclasses.asdict(tcfg.MODES[mode]) == dataclasses.asdict(
        jcfg.MODES[mode]
    )


def test_constants_and_defaults_match():
    for name in ("DEFAULT_WIDTH", "DEFAULT_HEIGHT", "MAX_OBJECTS",
                 "MAX_COMPONENTS", "MAX_SPOKES", "EDGE_SUBDIV", "MAX_EDGES",
                 "ELLIPSE_STEPS", "BACKGROUND_OBJ_ID", "FOREGROUND_ID_BASE",
                 "KIND_ELLIPSE", "KIND_POLYGON", "KIND_COMPOSITE", "PI"):
        assert getattr(tcfg, name) == getattr(jcfg, name), name
    for mode in (1, 7, 13):
        a = dataclasses.asdict(tcfg.DataGenConfig(mode=mode, batch_size=5))
        b = dataclasses.asdict(jcfg.DataGenConfig(mode=mode, batch_size=5))
        assert a == b
    assert [f.name for f in dataclasses.fields(tcfg.DataGenConfig)] == [
        f.name for f in dataclasses.fields(jcfg.DataGenConfig)
    ]


def test_disparity_mode_matches():
    assert tcfg.disparity_mode(7) == jcfg.disparity_mode(7) == 107
    assert dataclasses.asdict(tcfg.MODES[107]) == dataclasses.asdict(
        jcfg.MODES[107]
    )


def test_procedural_atlas_byte_equal():
    a = flowgen_torch.procedural_atlas(3, height=24, width=32, seed=5)
    b = flowgen.procedural_atlas(3, height=24, width=32, seed=5)
    assert a.dtype == b.dtype == np.uint8
    np.testing.assert_array_equal(a, b)


def test_import_without_jax():
    code = (
        "import sys, importlib, pkgutil\n"
        "sys.modules['jax'] = None\n"
        "import flowgen_torch\n"
        "for m in pkgutil.walk_packages(flowgen_torch.__path__, 'flowgen_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "assert not any(k == 'flowgen' or k.startswith('flowgen.') "
        "for k in sys.modules)\n"
        "print('ok')\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip().endswith("ok")


def _py_files():
    pkg = os.path.join(ROOT, "flowgen_torch")
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for d in ("tools", "examples"):
        out += [os.path.join(ROOT, d, f)
                for f in sorted(os.listdir(os.path.join(ROOT, d)))
                if f.startswith("torch_") and f.endswith(".py")]
    for d, _, files in os.walk(pkg):
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return out


def test_no_jax_or_flowgen_imports():
    bad = []
    for path in _py_files():
        tree = ast.parse(open(path).read(), path)
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            for n in names:
                top = n.split(".")[0]
                if top in ("jax", "jaxlib", "flowgen"):
                    bad.append(f"{path}: {n}")
    assert not bad, bad
    assert len(_py_files()) > 10


def test_generator_without_device_raises_without_card():
    from flowgen_torch.pipeline.generator import Generator

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    cfg = flowgen_torch.DataGenConfig(mode=7, batch_size=2, width=128,
                                      height=96)
    atlas = flowgen_torch.procedural_atlas(2, height=96, width=128)
    with pytest.raises(RuntimeError, match="CUDA"):
        Generator(cfg, atlas=atlas)


def _texture_list(tmp_path, n=3):
    """A texture-database list file naming ``n`` small PPM images."""
    from flowgen_torch.utils.flow_io import write_ppm

    rng = np.random.default_rng(0)
    paths = []
    for i in range(n):
        path = tmp_path / f"tex{i}.ppm"
        write_ppm(str(path), rng.integers(0, 256, (120 + 40 * i, 160, 3),
                                          dtype=np.uint8))
        paths.append(str(path))
    lst = tmp_path / "list.txt"
    lst.write_text("\n".join(paths) + "\n")
    return str(lst)


@pytest.mark.parametrize("kw", [
    dict(mode=9, warp_bank_impl="xla"),
    dict(mode=9, warp_bank_impl="xla", photometric_augment=True),
    dict(mode=9, warp_bank_impl="xla", render_impl="windowed"),
    dict(mode=9, warp_bank_impl="xla", texture_dbases=("list.txt",)),
    dict(mode=9, warp_bank_impl="xla", compute_inverse_flow=True,
         emit_masks=True),
])
def test_out_of_slice_configs_raise(kw, tmp_path):
    """The configurations the port once refused (mode 9's "xla" bank
    stream, alone, with photometric jitter, windowed, with a TextureDB,
    with inverse flow and masks) now render, with the JAX package's output
    keys, shapes and types."""
    from flowgen_torch.pipeline.generator import generate_batch

    if "texture_dbases" in kw:
        kw = {**kw, "texture_dbases": (_texture_list(tmp_path),)}
    cfg = flowgen_torch.DataGenConfig(batch_size=1, width=128, height=96, **kw)
    out = generate_batch(0, 0, flowgen_torch.atlas_for_config(cfg), cfg,
                         device="cpu")
    masks = {"occlusion", "motion_boundary"} if cfg.emit_masks else set()
    flow1 = {"flow1"} if cfg.compute_inverse_flow else set()
    assert set(out) == {"image0", "image1", "flow0"} | flow1 | masks
    for k, v in out.items():
        if k in masks:
            assert v.shape == (1, 96, 128) and v.dtype == torch.bool
            continue
        c = 3 if k.startswith("image") else 2
        assert v.shape == (1, 96, 128, c) and v.dtype == torch.float32
        assert bool(torch.isfinite(v).all())


@pytest.mark.parametrize("kw,tsplit", [
    (dict(mode=11), 1),
    (dict(mode=13), 1),
    (dict(mode=11, width=256), 2),
    (dict(mode=13, width=256, compute_inverse_flow=True, emit_masks=True), 2),
    (dict(mode=7, compute_inverse_flow=True), 1),
    (dict(mode=7, emit_masks=True, layout="nchw"), 1),
])
def test_slice_configs_render(kw, tsplit):
    """Configurations the slice covers give the JAX package's output keys,
    shapes and types."""
    from flowgen_torch.ops.scene import resample_params
    from flowgen_torch.pipeline.generator import generate_batch

    cfg = flowgen_torch.DataGenConfig(**{"batch_size": 1, "width": 128,
                                         "height": 96, **kw})
    assert resample_params(cfg.mode_spec, 96, cfg.width)[6] == tsplit
    atlas = flowgen_torch.procedural_atlas(2, height=96, width=cfg.width)
    out = generate_batch(0, 0, atlas, cfg, device="cpu")
    want = {"image0", "image1", "flow0"}
    if cfg.compute_inverse_flow:
        want.add("flow1")
    if cfg.emit_masks:
        want |= {"occlusion", "motion_boundary"}
    assert set(out) == want
    nchw = cfg.layout == "nchw"
    for k in want:
        v = out[k]
        if k in ("occlusion", "motion_boundary"):
            assert v.shape == (1, 96, cfg.width) and v.dtype == torch.bool
        else:
            c = 3 if k.startswith("image") else 2
            shape = (1, c, 96, cfg.width) if nchw else (1, 96, cfg.width, c)
            assert v.shape == shape and bool(torch.isfinite(v).all())


@pytest.mark.parametrize("kw", [
    dict(mode=7, render_impl="windowed"),
    dict(mode=7, windowed=False),
    dict(mode=7, use_pallas="never"),
    dict(mode=7, height=90, use_antialiasing=False),
    dict(mode=1, width=120, compute_inverse_flow=True, emit_masks=True),
    dict(mode=9, height=90),
])
def test_windowed_configs_render(kw):
    """Frames not (8, 128)-aligned and the settings that ask for it render
    through the windowed renderer, with the JAX package's output keys,
    shapes and types."""
    from flowgen_torch.pipeline.generator import generate_batch, use_fused_path

    cfg = flowgen_torch.DataGenConfig(**{"batch_size": 1, "width": 128,
                                         "height": 96, **kw})
    assert not use_fused_path(cfg, "cuda")
    atlas = flowgen_torch.procedural_atlas(2, height=cfg.height,
                                           width=cfg.width)
    out = generate_batch(0, 0, atlas, cfg, device="cpu")
    want = {"image0", "image1", "flow0"}
    if cfg.compute_inverse_flow:
        want.add("flow1")
    if cfg.emit_masks:
        want |= {"occlusion", "motion_boundary"}
    assert set(out) == want
    for k in want:
        v = out[k]
        if k in ("occlusion", "motion_boundary"):
            assert v.shape == (1, cfg.height, cfg.width) and v.dtype == torch.bool
        else:
            c = 3 if k.startswith("image") else 2
            assert v.shape == (1, cfg.height, cfg.width, c)
            assert bool(torch.isfinite(v).all())


def test_texture_db_atlas_raises(tmp_path):
    """A list file that is missing, or that names no image, raises, as the
    reference's texture collection does at start-up."""
    cfg = flowgen_torch.DataGenConfig(
        mode=7, texture_dbases=(str(tmp_path / "missing.txt"),))
    with pytest.raises(FileNotFoundError):
        flowgen_torch.atlas_for_config(cfg)
    empty = tmp_path / "empty.txt"
    empty.write_text("\n\n")
    cfg = flowgen_torch.DataGenConfig(mode=7, texture_dbases=(str(empty),))
    with pytest.raises(ValueError, match="No texture paths"):
        flowgen_torch.atlas_for_config(cfg)


def test_all_modules_listed():
    names = {m.name for m in pkgutil.walk_packages(
        flowgen_torch.__path__, "flowgen_torch.")}
    for want in ("flowgen_torch.config", "flowgen_torch.random.streams",
                 "flowgen_torch.params.sampler", "flowgen_torch.ops.scene",
                 "flowgen_torch.compose.fused",
                 "flowgen_torch.pipeline.generator", "flowgen_torch.interop",
                 "flowgen_torch.ops.photometric",
                 "flowgen_torch.texture_io.native",
                 "flowgen_torch.pipeline.sharding",
                 "flowgen_torch.utils.profiling",
                 "flowgen_torch.reference_check.oracle"):
        assert want in names
