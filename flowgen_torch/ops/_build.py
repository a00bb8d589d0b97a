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
    "flowgen_scene": ("scene.cu", ("coverage.cuh", "resample.cuh")),
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


def build(name: str) -> Path:
    """Compile one library with ``nvcc`` unless it is already built; record
    the seconds it took and the compiler's log in ``BUILD_INFO``."""
    if name in BUILD_INFO:
        return Path(BUILD_INFO[name]["path"])
    t0 = time.time()
    target = _target(name)
    log = ""
    if not target.exists():
        target.parent.mkdir(parents=True, exist_ok=True)
        src, _ = LIBRARIES[name]
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / src)]
        r = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                           text=True)
        log = r.stdout
        if r.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        os.replace(tmp, target)
    BUILD_INFO[name] = {"seconds": time.time() - t0, "log": log,
                        "path": str(target)}
    return target


def _load(name: str):
    if name not in _loaded:
        _loaded[name] = ctypes.CDLL(str(build(name)))
    return _loaded[name]


def load_scene_library():
    lib = _load("flowgen_scene")
    fn = lib.flowgen_scene_render
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 17 + [
            ctypes.c_void_p
        ]
        fn.restype = ctypes.c_int
    return lib
