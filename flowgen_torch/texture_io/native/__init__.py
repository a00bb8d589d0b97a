"""The native texture loader: a C++ thread pool that decodes texture files
(JPEG baseline and progressive, PNG, binary PPM/PGM, 24/32-bit BMP) and
bilinearly resizes them into one packed (N, H, W, 3) uint8 atlas.

``loader.cpp``, ``jpeg.cpp`` and ``jpeg.h`` are byte-for-byte copies of the
JAX package's sources (``flowgen/texture_io/native``). At first use they are
compiled with ``g++`` (``-O3 -fPIC -std=c++17``, linked with zlib and
pthreads) into the port's build directory (``ops/_build.py:build_dir``,
``build/kernels`` by default), keyed by a hash of the sources and flags,
and bound with ``ctypes``. A failed build raises with the compiler's log;
a file the loader cannot decode is marked in the per-file ``ok`` flags for
the caller to decode otherwise.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import time
from pathlib import Path
from typing import List

import numpy as np

HERE = Path(__file__).resolve().parent
SOURCES = ("loader.cpp", "jpeg.cpp")
HEADERS = ("jpeg.h",)
CXX_FLAGS = ["-O3", "-fPIC", "-std=c++17", "-Wall"]
LD_FLAGS = ["-shared", "-lz", "-lpthread"]

_lib = None
BUILD_INFO = {}   # {"seconds": float, "log": str, "path": str} once built


def _target() -> Path:
    from ...ops._build import build_dir

    h = hashlib.sha256(" ".join(CXX_FLAGS + LD_FLAGS).encode())
    for f in SOURCES + HEADERS:
        h.update((HERE / f).read_bytes())
    return build_dir() / f"libflowgen_host_{h.hexdigest()[:16]}.so"


def start_build():
    """Start ``g++`` for the loader unless it is built: (target, tmp,
    process or None, start time), for :func:`finish_build`."""
    t0 = time.time()
    target = _target()
    if target.exists():
        return target, None, None, t0
    target.parent.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    cmd = [os.environ.get("CXX", "g++"), *CXX_FLAGS,
           *[str(HERE / f) for f in SOURCES], "-o", str(tmp), *LD_FLAGS]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return target, tmp, proc, t0


def finish_build(started) -> Path:
    """Wait for :func:`start_build`'s compiler; raise with its log if it
    failed."""
    target, tmp, proc, t0 = started
    log = ""
    if proc is not None:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed for the native texture loader:\n"
                               f"{log}")
        os.replace(tmp, target)
    BUILD_INFO.update(seconds=time.time() - t0, log=log, path=str(target))
    return target


def build() -> Path:
    """Compile the loader unless it is already built."""
    if BUILD_INFO:
        return Path(BUILD_INFO["path"])
    return finish_build(start_build())


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        lib.fg_load_images.restype = ctypes.c_int
        lib.fg_load_images.argtypes = [
            ctypes.POINTER(ctypes.c_char_p),  # paths
            ctypes.c_int,                     # n paths
            ctypes.c_int,                     # out_h
            ctypes.c_int,                     # out_w
            ctypes.POINTER(ctypes.c_ubyte),   # out buffer (n, h, w, 3)
            ctypes.c_int,                     # n threads
            ctypes.POINTER(ctypes.c_ubyte),   # per-file ok flags
        ]
        _lib = lib
    return _lib


def native_loader_available() -> bool:
    """True once the loader is built and loaded (the JAX package's
    ``native_loader_available``). The port has no silent fallback: where
    the JAX package returns False after a failed build, this raises with
    the compiler's log (:func:`finish_build`), so it never returns False."""
    _load()
    return True


def load_images_native(paths: List[str], out_h: int, out_w: int):
    """Threaded native decode of ``paths`` into a packed (N, out_h, out_w, 3)
    uint8 atlas. Returns ``(atlas, ok)``, ``ok`` a per-file bool mask: False
    slots were not decoded (a format the loader does not read, such as
    TIFF) and are left for the caller."""
    lib = _load()
    n = len(paths)
    out = np.empty((n, out_h, out_w, 3), np.uint8)
    ok = np.zeros(n, np.uint8)
    arr = (ctypes.c_char_p * n)(*[os.fsencode(p) for p in paths])
    threads = min(16, max(1, os.cpu_count() or 1))
    rc = lib.fg_load_images(
        arr, n, out_h, out_w,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)), threads,
        ok.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
    )
    if rc < 0:
        raise ValueError(f"native loader: invalid arguments ({n} paths, "
                         f"{out_h}x{out_w})")
    return out, ok.astype(bool)
