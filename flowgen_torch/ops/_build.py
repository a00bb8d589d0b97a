"""Build and bind the port's CUDA kernels.

Each kernel source in ``flowgen_torch/csrc`` is compiled at first use by
``nvcc`` into a shared library with a plain C interface and loaded with
``ctypes``. Libraries are cached under ``build/kernels`` at the repository
root (override with ``FLOWGEN_TORCH_BUILD_DIR``), keyed by a hash of the
sources and flags, so an edit rebuilds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
    # The reference values come from XLA:CPU, which never contracts a*b + c
    # into an FMA and divides / square-roots exactly.
    "-fmad=false", "-prec-div=true", "-prec-sqrt=true", "-ftz=false",
    "-Xptxas", "-v",
]

# Per library name: the .cu source and the headers it includes.
LIBRARIES = {
    "flowgen_scene": ("scene.cu", ("coverage.cuh", "resample.cuh", "warp.cuh")),
    "flowgen_fields": ("fields.cu", ()),
    "flowgen_window": ("window.cu", ("coverage.cuh",)),
    "flowgen_resample": ("resample.cu", ("resample.cuh", "coverage.cuh")),
    "flowgen_photometric": ("photometric.cu", ()),
}

_loaded = {}
BUILD_INFO = {}   # name -> {"seconds": float, "log": str, "path": str}


def build_dir() -> Path:
    env = os.environ.get("FLOWGEN_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    return CSRC.parent.parent / "build" / "kernels"


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build on a machine "
                       "with the CUDA toolkit")


def _target(name: str) -> Path:
    src, hdrs = LIBRARIES[name]
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in (src,) + hdrs:
        h.update((CSRC / f).read_bytes())
    return build_dir() / f"lib{name}_{h.hexdigest()[:16]}.so"


def _start(name: str):
    """Start nvcc for one library unless it is built: (target, tmp, process
    or None, start time)."""
    t0 = time.time()
    target = _target(name)
    if target.exists():
        return target, None, None, t0
    target.parent.mkdir(parents=True, exist_ok=True)
    src, _ = LIBRARIES[name]
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / src)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return target, tmp, proc, t0


def _finish(name: str, started) -> Path:
    target, tmp, proc, t0 = started
    log = ""
    if proc is not None:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        os.replace(tmp, target)
    BUILD_INFO[name] = {"seconds": time.time() - t0, "log": log,
                        "path": str(target)}
    return target


def build(name: str) -> Path:
    """Compile one library with ``nvcc`` unless it is already built; record
    the seconds it took and the compiler's log in ``BUILD_INFO``."""
    if name in BUILD_INFO:
        return Path(BUILD_INFO[name]["path"])
    return _finish(name, _start(name))


def build_all():
    """Compile every library, one ``nvcc`` process per source, all started
    together."""
    todo = [n for n in LIBRARIES if n not in BUILD_INFO]
    started = {n: _start(n) for n in todo}
    for n in todo:
        _finish(n, started[n])


def _load(name: str):
    if name not in _loaded:
        _loaded[name] = ctypes.CDLL(str(build(name)))
    return _loaded[name]


def load_scene_library():
    lib = _load("flowgen_scene")
    fn = lib.flowgen_scene_render
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 17 + [ctypes.c_int] * 25 + [
            ctypes.c_void_p
        ]
        fn.restype = ctypes.c_int
    return lib


def load_fields_library():
    lib = _load("flowgen_fields")
    if lib.flowgen_coarse_solve.argtypes is None:
        lib.flowgen_coarse_solve.argtypes = (
            [ctypes.c_void_p] + [ctypes.c_longlong] * 4 + [ctypes.c_int]
            + [ctypes.c_void_p] * 2 + [ctypes.c_longlong]
            + [ctypes.c_int] * 5 + [ctypes.c_void_p])
        lib.flowgen_coarse_solve.restype = ctypes.c_int
        lib.flowgen_coarse_scratch_floats.argtypes = [ctypes.c_int] * 4
        lib.flowgen_coarse_scratch_floats.restype = ctypes.c_longlong
        for up in (lib.flowgen_upsample4, lib.flowgen_upsample2):
            up.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3 + [
                ctypes.c_void_p]
            up.restype = ctypes.c_int
        lib.flowgen_noop.argtypes = [ctypes.c_void_p]
        lib.flowgen_noop.restype = ctypes.c_int
        lib.flowgen_hwarp_rows.argtypes = [ctypes.c_void_p] * 3 + [
            ctypes.c_int] * 6 + [ctypes.c_void_p]
        lib.flowgen_hwarp_rows.restype = ctypes.c_int
        lib.flowgen_elementary_field.argtypes = [ctypes.c_void_p] * 2 + [
            ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_void_p]
        lib.flowgen_elementary_field.restype = ctypes.c_int
    return lib


def load_window_library():
    lib = _load("flowgen_window")
    if lib.flowgen_object_window.argtypes is None:
        lib.flowgen_object_window.argtypes = [ctypes.c_void_p] * 7 + [
            ctypes.c_int] * 16 + [ctypes.c_float] * 2 + [ctypes.c_void_p]
        lib.flowgen_object_window.restype = ctypes.c_int
        lib.flowgen_polygon_coverage.argtypes = [ctypes.c_void_p] * 6 + [
            ctypes.c_int] * 4 + [ctypes.c_void_p]
        lib.flowgen_polygon_coverage.restype = ctypes.c_int
    return lib


def load_resample_library():
    lib = _load("flowgen_resample")
    fn = lib.flowgen_affine_resample
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] + [ctypes.c_float] * 6 + [
            ctypes.c_void_p] + [ctypes.c_int] * 9 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def load_photometric_library():
    lib = _load("flowgen_photometric")
    fn = lib.flowgen_photometric
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 2 + [
            ctypes.c_float] * 9 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib
