"""The port's texture databases against the JAX package on the CPU.

The native loader's sources are byte-for-byte copies of the JAX package's,
and the port's build of them decodes PPM, PNG, BMP and baseline and
progressive JPEG files written by the test byte-for-byte as a build of the
JAX package's sources with its Makefile's flags does (made here in a
temporary directory, so nothing is built into ``flowgen/``). The
``TextureDB`` of a list file, ``build_texture_db``, the object slabs (plain
and with the quadrant copies) and the background slabs with per-source
reflect periods are byte-equal to the JAX package's (a canonical-size, a
small and a large source, the sources of ``tests/test_native_fov.py``); the
slab packer refuses a database whose padded slabs exceed the card's free
memory. The
windowed renderer with a database is held to the JAX package's jitted step
(128x96, B=2) under the gates of ``tools/check_pallas_tpu.py``, and
``Generator`` from a list file to ``generate_batch`` on the same database.
The renders through the scene kernel are in ``test_torch_native_fov.py``."""

import functools
import os
import re
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flowgen
import flowgen_torch
from flowgen import texture_io as jtex
from flowgen.ops.pallas_scene import prepare_bg_slabs_db as j_bg_db
from flowgen.ops.pallas_scene import prepare_obj_slabs as j_obj
from flowgen.pipeline.generator import generate_batch as j_generate
from flowgen.random.streams import root_key as j_root
from flowgen_torch import texture_io as ttex
from flowgen_torch.interop import texture_db_from_numpy
from flowgen_torch.ops.scene import prepare_bg_slabs_db, prepare_obj_slabs
from flowgen_torch.pipeline.generator import (Generator, db_slab_bytes,
                                              make_slab_packer)
from flowgen_torch.pipeline.generator import generate_batch as t_generate
from flowgen_torch.texture_io import native

torch.set_num_threads(1)

W, H = 128, 96
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
J_NATIVE = os.path.join(ROOT, "flowgen", "texture_io", "native")


def _natives(seed=0):
    rng = np.random.default_rng(seed)

    def tex(h, w):
        base = rng.integers(0, 255, (h // 8 + 1, w // 8 + 1, 3), np.uint8)
        return np.kron(base, np.ones((8, 8, 1), np.uint8))[:h, :w]

    # canonical-sized, small (whole-image fallback), large (tighter view)
    return [tex(2 * H, 2 * W), tex(150, 170), tex(400, 520)]


@pytest.fixture(scope="module")
def dbs():
    natives = _natives()
    return (natives, jtex.build_texture_db(natives, height=H, width=W),
            ttex.build_texture_db(natives, height=H, width=W))


def test_loader_sources_are_copies():
    for f in ("loader.cpp", "jpeg.cpp", "jpeg.h"):
        with open(os.path.join(J_NATIVE, f), "rb") as a, open(
                os.path.join(native.HERE, f), "rb") as b:
            assert a.read() == b.read(), f


def _makefile_flags():
    text = open(os.path.join(J_NATIVE, "Makefile")).read()
    get = lambda k: re.search(rf"^{k} \?= (.*)$", text, re.M).group(1).split()
    return get("CXXFLAGS"), get("LDFLAGS")


def _write_textures(tmp_path):
    from PIL import Image

    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[0:67, 0:93].astype(np.float32)
    smooth = np.stack(
        [128 + 90 * np.sin(xx / 19), 128 + 90 * np.cos(yy / 13),
         128 + 60 * np.sin((xx + yy) / 29)], axis=-1,
    ).clip(0, 255).astype(np.uint8)
    paths = []

    def save(name, img, **kw):
        p = str(tmp_path / name)
        Image.fromarray(img).save(p, **kw)
        paths.append(p)

    save("a.ppm", rng.integers(0, 255, (37, 53, 3), dtype=np.uint8))
    save("b.png", rng.integers(0, 255, (38, 54, 3), dtype=np.uint8))
    save("c.bmp", rng.integers(0, 255, (39, 55, 3), dtype=np.uint8))
    save("d.jpg", smooth, quality=92)
    save("e.jpg", smooth, quality=90, progressive=True)
    save("f.jpg", smooth[..., 0], quality=90, progressive=True,
         subsampling=0)
    return paths


def test_native_loader_matches_the_jax_packages_build(tmp_path):
    """The JAX package's loader, built from its own sources with its
    Makefile's flags (the port's flags), decodes every file the test
    writes byte for byte as the port's build does."""
    import ctypes

    cxx, ld = _makefile_flags()
    assert cxx == native.CXX_FLAGS and ld == native.LD_FLAGS
    lib_path = str(tmp_path / "libjax_loader.so")
    subprocess.run(
        ["g++", *cxx, os.path.join(J_NATIVE, "loader.cpp"),
         os.path.join(J_NATIVE, "jpeg.cpp"), "-o", lib_path, *ld],
        check=True, capture_output=True, timeout=300)
    jlib = ctypes.CDLL(lib_path)
    paths = _write_textures(tmp_path)
    for oh, ow in ((67, 93), (48, 64)):
        got, ok = native.load_images_native(paths, oh, ow)
        assert ok.all()
        want = np.empty_like(got)
        jok = np.zeros(len(paths), np.uint8)
        arr = (ctypes.c_char_p * len(paths))(*[p.encode() for p in paths])
        rc = jlib.fg_load_images(
            arr, len(paths), oh, ow,
            want.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)), 4,
            jok.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)))
        assert rc == 0 and jok.all()
        np.testing.assert_array_equal(got, want)


def test_load_images_falls_back_per_file(tmp_path):
    """A file the loader cannot decode (TIFF) goes through PIL alone; the
    rest keep the loader's decode."""
    from PIL import Image

    paths = _write_textures(tmp_path)[:3]
    img = np.random.default_rng(1).integers(0, 255, (32, 32, 3), np.uint8)
    tiff = str(tmp_path / "odd.tiff")
    Image.fromarray(img).save(tiff)
    paths.insert(1, tiff)
    _, ok = native.load_images_native(paths, 32, 32)
    assert ok.tolist() == [True, False, True, True]
    out = ttex.load_images(paths, height=16, width=16)
    np.testing.assert_array_equal(
        out[1], jtex.load_images([tiff], height=16, width=16,
                                 use_native=False)[0])
    np.testing.assert_array_equal(
        out[[0, 2, 3]], native.load_images_native(
            [paths[i] for i in (0, 2, 3)], 32, 32)[0])


def test_texture_db_from_list_file_byte_equal(tmp_path, dbs):
    from PIL import Image

    natives, jdb, tdb = dbs
    for f in jdb._fields:
        np.testing.assert_array_equal(getattr(tdb, f), getattr(jdb, f),
                                      err_msg=f)
    paths = []
    for i, img in enumerate(natives):
        p = str(tmp_path / f"src{i}.png")
        Image.fromarray(img).save(p)
        paths.append(p)
    lf = tmp_path / "db.txt"
    lf.write_text("\n".join(paths) + "\n")
    jl = jtex.load_texture_db([str(lf)], height=H, width=W, native_fov=True)
    tl = ttex.load_texture_db([str(lf)], height=H, width=W, native_fov=True)
    for f in jl._fields:
        np.testing.assert_array_equal(getattr(tl, f), getattr(jl, f),
                                      err_msg=f)
        np.testing.assert_array_equal(getattr(tl, f), getattr(tdb, f),
                                      err_msg=f)
    conv = texture_db_from_numpy(jl)
    for f in jl._fields:
        np.testing.assert_array_equal(getattr(conv, f), getattr(jl, f))


@pytest.mark.parametrize("quadrant", [False, True])
def test_obj_slabs_byte_equal(dbs, quadrant):
    _, jdb, tdb = dbs
    want = np.asarray(j_obj(jnp.asarray(jdb.obj_tex), quadrant=quadrant))
    got = prepare_obj_slabs(torch.from_numpy(tdb.obj_tex), quadrant=quadrant)
    np.testing.assert_array_equal(got.numpy(), want)


def test_bg_slabs_db_byte_equal(dbs):
    _, jdb, tdb = dbs
    want = np.asarray(j_bg_db(jdb.sources, jdb.sizes))
    got = prepare_bg_slabs_db(torch.from_numpy(tdb.sources),
                              torch.from_numpy(tdb.sizes))
    assert got.shape == want.shape == (3, 912, 1152)
    np.testing.assert_array_equal(got.numpy(), want)


def test_slab_packer_refuses_a_db_larger_than_the_free_memory(dbs,
                                                                monkeypatch):
    """The packer counts the padded slabs' bytes and raises, naming them and
    the largest source, before it moves anything to the card; on the CPU it
    packs whatever it is given."""
    _, _, tdb = dbs
    need = db_slab_bytes(tdb)
    assert tdb.sources.shape == (3, 400, 520, 3)
    assert need == 3 * 912 * 1152 * 4 + 3 * 400 * 520 * 7
    cfg = flowgen_torch.DataGenConfig(mode=7, batch_size=2, width=W, height=H)
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda d: (need - 1, 0))
    monkeypatch.setattr(torch.cuda, "memory_reserved", lambda d: 0)
    monkeypatch.setattr(torch.cuda, "memory_allocated", lambda d: 0)
    with pytest.raises(MemoryError, match="400x520"):
        make_slab_packer(cfg, torch.device("cuda"))(tdb)
    monkeypatch.setattr(torch.cuda, "memory_reserved", lambda d: 1)
    assert make_slab_packer(cfg, torch.device("cpu"))(tdb)[1].shape == (
        3, 912, 1152)


def _gates(got, want):
    for k in range(2):
        d = np.abs(got[k] - want[k])
        assert (d >= 1).mean() < 0.01 and (d >= 2).mean() < 1e-4
    d = np.abs(got[2] - want[2])
    assert np.median(d) < 1e-4 and (d > 0.01).mean() < 1e-3


def test_windowed_renderer_with_db_matches_jax(dbs):
    """The windowed renderer samples the database's canonical array, as in
    the JAX package."""
    _, jdb, tdb = dbs
    kw = dict(mode=7, batch_size=2, width=W, height=H,
              render_impl="windowed")
    jc = flowgen.DataGenConfig(**kw)
    want = jax.jit(functools.partial(j_generate, cfg=jc))(j_root(0), 1, jdb)
    tc = flowgen_torch.DataGenConfig(**kw)
    got = t_generate(0, 1, tdb, tc, device="cpu")
    _gates([got[k].numpy() for k in ("image0", "image1", "flow0")],
           [np.asarray(want[k]) for k in ("image0", "image1", "flow0")])
    canon = t_generate(0, 1, tdb.canonical, tc, device="cpu")
    for k in got:
        assert torch.equal(got[k], canon[k])


def test_generator_from_list_file(tmp_path, dbs):
    """``Generator`` with ``texture_dbases`` reads the list file into a
    TextureDB (native field of view by default) and renders it as
    ``generate_batch`` renders the same database, photometric stage on."""
    from PIL import Image

    natives, _, tdb = dbs
    paths = []
    for i, img in enumerate(natives):
        p = str(tmp_path / f"t{i}.bmp")
        Image.fromarray(img).save(p)
        paths.append(p)
    lf = tmp_path / "list.txt"
    lf.write_text("\n".join(paths))
    cfg = flowgen_torch.DataGenConfig(
        mode=7, batch_size=2, width=W, height=H, seed=3,
        texture_dbases=(str(lf),), photometric_augment=True)
    gen = Generator(cfg, device="cpu")
    assert isinstance(gen._atlas, ttex.TextureDB)
    first = gen.retrieve_batch()
    gen.stop()
    want = t_generate(3, 0, tdb, cfg, device="cpu")
    assert set(first) == set(want)
    for k in want:
        assert torch.equal(first[k], want[k]), k
