"""Flow and image file IO.

The reference's only output paths are debug dumps: PGM masks
(writeMasksToFiles, src/caffe/DataGenerator.cpp:429-447) and the commented-out
standalone program saving image pairs as PPM and flow as PFM
(cpp:2844-2863, via CImg save_pnm/save_pfm). This module provides those
formats plus the Middlebury ``.flo`` format commonly used for optical-flow
ground truth — all NumPy-only."""

from __future__ import annotations

import struct

import numpy as np

_FLO_MAGIC = 202021.25


def write_flo(path: str, flow: np.ndarray) -> None:
    """Middlebury .flo: magic, width, height, interleaved (u, v) float32."""
    flow = np.asarray(flow, np.float32)
    assert flow.ndim == 3 and flow.shape[2] == 2, flow.shape
    h, w = flow.shape[:2]
    with open(path, "wb") as f:
        f.write(struct.pack("<fii", _FLO_MAGIC, w, h))
        f.write(flow.tobytes())


def read_flo(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        magic, w, h = struct.unpack("<fii", f.read(12))
        if abs(magic - _FLO_MAGIC) > 1e-3:
            raise ValueError(f"bad .flo magic {magic}")
        data = np.frombuffer(f.read(w * h * 2 * 4), np.float32)
    return data.reshape(h, w, 2).copy()


def write_pfm(path: str, data: np.ndarray, scale: float = 1.0) -> None:
    """PFM (the reference's flow dump format via CImg save_pfm): 'PF' for
    3-channel, 'Pf' for 1-channel; negative scale = little-endian; rows
    bottom-to-top."""
    data = np.asarray(data, np.float32)
    if data.ndim == 2:
        header = b"Pf"
    elif data.ndim == 3 and data.shape[2] == 3:
        header = b"PF"
    elif data.ndim == 3 and data.shape[2] == 2:
        # pad 2-channel flow to 3 channels, like common PFM flow dumps
        data = np.concatenate([data, np.zeros_like(data[..., :1])], axis=-1)
        header = b"PF"
    else:
        raise ValueError(f"unsupported PFM shape {data.shape}")
    h, w = data.shape[:2]
    with open(path, "wb") as f:
        f.write(header + b"\n")
        f.write(f"{w} {h}\n".encode())
        f.write(f"{-abs(scale)}\n".encode())
        f.write(np.flipud(data).tobytes())


def read_pfm(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        header = f.readline().strip()
        color = header == b"PF"
        w, h = map(int, f.readline().split())
        scale = float(f.readline())
        count = w * h * (3 if color else 1)
        data = np.frombuffer(f.read(count * 4), np.float32)
        if scale > 0:  # big-endian
            data = data.byteswap()
    shape = (h, w, 3) if color else (h, w)
    return np.flipud(data.reshape(shape)).copy()


def write_ppm(path: str, img: np.ndarray) -> None:
    """Binary PPM (the reference's image dump format via CImg save_pnm)."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        img = np.clip(np.round(img), 0, 255).astype(np.uint8)
    h, w = img.shape[:2]
    with open(path, "wb") as f:
        f.write(f"P6\n{w} {h}\n255\n".encode())
        f.write(img.tobytes())


def read_ppm(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        assert f.readline().strip() == b"P6"
        line = f.readline()
        while line.startswith(b"#"):
            line = f.readline()
        w, h = map(int, line.split())
        maxval = int(f.readline())
        data = np.frombuffer(f.read(w * h * 3), np.uint8)
    return data.reshape(h, w, 3).copy()


def write_pgm(path: str, img: np.ndarray) -> None:
    """Binary PGM (the reference's mask dump format, cpp:429-447)."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        img = np.clip(np.round(img), 0, 255).astype(np.uint8)
    h, w = img.shape[:2]
    with open(path, "wb") as f:
        f.write(f"P5\n{w} {h}\n255\n".encode())
        f.write(img.tobytes())


def flow_to_color(flow: np.ndarray, max_mag: float | None = None) -> np.ndarray:
    """Standard HSV flow visualization (hue = direction, value = magnitude)."""
    fx, fy = flow[..., 0], flow[..., 1]
    mag = np.hypot(fx, fy)
    ang = np.arctan2(fy, fx)
    if max_mag is None:
        max_mag = max(float(mag.max()), 1e-6)
    h = (ang / np.pi + 1.0) / 2.0
    v = np.clip(mag / max_mag, 0, 1)
    i = np.floor(h * 6.0).astype(int) % 6
    f = h * 6.0 - np.floor(h * 6.0)
    p = np.zeros_like(v)
    q = v * (1 - f)
    t = v * f
    r = np.choose(i, [v, q, p, p, t, v])
    g = np.choose(i, [t, v, v, q, p, p])
    b = np.choose(i, [p, p, t, v, v, q])
    return (np.stack([r, g, b], -1) * 255).astype(np.uint8)
