"""Texture banks for the PyTorch port (port of ``flowgen/texture_io``).

A texture database is a list file of image paths, one per line (the
reference's ``texture_dbases``). :func:`load_texture_db` reads it into a
canonical atlas (T, 2H, 2W, 3) uint8, every source resized to the largest
crop any mode requests, or, with ``native_fov`` (the configuration's
``native_texture_fov``, on by default), into a :class:`TextureDB` that keeps
each source's native size, so the backgrounds' crop geometry follows it as
in the reference. Decoding goes through the native loader
(``texture_io/native``, built with ``g++`` at first use) or PIL, imported
only when used. :func:`procedural_atlas` is the bank used when no database
is configured: band-limited coloured noise made with numpy from a seed.

The sources, the resizes and every array here are numpy, byte for byte the
JAX package's; the renderers move them to the device.
"""

from __future__ import annotations

from typing import Iterable, NamedTuple, Sequence

import numpy as np

from ..config import DataGenConfig
from . import native
from .native import load_images_native, native_loader_available


class TextureDB(NamedTuple):
    """Texture bank keeping the sources' native sizes.

    * ``canonical`` (T, 2H, 2W, 3) u8: the sources resized to the canonical
      grid; the windowed renderer samples it.
    * ``sources`` (T, maxH, maxW, 3) u8: the native images, zero-padded.
    * ``sizes`` (T, 2) i32: native (h, w) per source.
    * ``obj_tex`` (T, H, W, 3) u8: each source's object texture, its centre
      crop, or its whole-image resize when it is smaller than the frame.

    The scene kernel's path reads ``obj_tex``, ``sources`` and ``sizes``; a
    plain (T, 2H, 2W, 3) array is accepted everywhere too and behaves as an
    all-canonical database.
    """

    canonical: np.ndarray
    sources: np.ndarray
    sizes: np.ndarray
    obj_tex: np.ndarray


def _decode_pil(path: str, out_h: int, out_w: int) -> np.ndarray:
    from PIL import Image

    with Image.open(path) as im:
        im = im.convert("RGB").resize((out_w, out_h), Image.BILINEAR)
        return np.asarray(im, dtype=np.uint8)


def load_texture_db(
    list_files: Sequence[str],
    *,
    height: int = 384,
    width: int = 512,
    use_native: bool = True,
    native_fov: bool = False,
):
    """Load every texture named by the list files: a canonical atlas
    (T, 2*height, 2*width, 3) uint8 (RGB), or with ``native_fov`` a
    :class:`TextureDB`. A missing list file raises, as does one naming no
    image. Channels stay RGB; ``DataGenConfig.channel_order`` swaps them at
    the output."""
    paths = []
    for lf in list_files:
        with open(lf, "r") as f:
            for line in f:
                line = line.strip()
                if line:
                    paths.append(line)
    if not paths:
        raise ValueError(f"No texture paths found in {list_files!r}")
    return load_images(
        paths, height=height, width=width, use_native=use_native,
        native_fov=native_fov,
    )


def load_images(
    paths: Iterable[str], *, height: int = 384, width: int = 512,
    use_native: bool = True, native_fov: bool = False,
):
    """Decode ``paths``: into the canonical atlas through the native loader
    (PIL for the files it cannot read; ``use_native=False`` for PIL
    throughout), or with ``native_fov`` into a :class:`TextureDB` of the
    native images (PIL)."""
    paths = list(paths)
    oh, ow = 2 * height, 2 * width
    if not native_fov:
        if use_native:
            out, ok = native.load_images_native(paths, oh, ow)
            # Only the files the loader cannot decode (TIFF, 12-bit JPEG,
            # ...) go through PIL.
            for i in np.flatnonzero(~ok):
                out[i] = _decode_pil(paths[i], oh, ow)
            return out
        imgs = [_decode_pil(p, oh, ow) for p in paths]
        total_mb = sum(i.nbytes for i in imgs) / (1024 * 1024)
        print(
            f"Loaded {len(imgs)} textures with a total size of "
            f"{total_mb:.0f} MB."
        )
        return np.stack(imgs)

    from PIL import Image

    natives = []
    for p in paths:
        with Image.open(p) as im:
            natives.append(np.asarray(im.convert("RGB"), dtype=np.uint8))
    return build_texture_db(natives, height=height, width=width)


def resize_linear(img: np.ndarray, w: int, h: int) -> np.ndarray:
    """Point-sampled bilinear resize (CImg's interpolation 3), the
    reference's whole-image fallback for sources smaller than the frame,
    computed in float64 and rounded half to even."""
    oy, ox = np.mgrid[0:h, 0:w].astype(np.float64)
    u = (ox + 0.5) * img.shape[1] / w - 0.5
    v = (oy + 0.5) * img.shape[0] / h - 0.5
    x0 = np.clip(np.floor(u).astype(np.int64), 0, img.shape[1] - 1)
    y0 = np.clip(np.floor(v).astype(np.int64), 0, img.shape[0] - 1)
    x1 = np.minimum(x0 + 1, img.shape[1] - 1)
    y1 = np.minimum(y0 + 1, img.shape[0] - 1)
    fx = (u - np.floor(u))[..., None]
    fy = (v - np.floor(v))[..., None]
    im = img.astype(np.float64)
    out = (
        (im[y0, x0] * (1 - fx) + im[y0, x1] * fx) * (1 - fy)
        + (im[y1, x0] * (1 - fx) + im[y1, x1] * fx) * fy
    )
    return np.clip(np.round(out), 0, 255).astype(np.uint8)


def build_texture_db(natives, *, height: int, width: int) -> TextureDB:
    """Assemble a :class:`TextureDB` from native-resolution RGB uint8
    arrays: PIL's bilinear resize to the canonical grid, the centre crop (or
    :func:`resize_linear` of a small source) as the object texture."""
    from PIL import Image

    oh, ow = 2 * height, 2 * width
    max_h = max(i.shape[0] for i in natives)
    max_w = max(i.shape[1] for i in natives)
    T = len(natives)
    sources = np.zeros((T, max_h, max_w, 3), np.uint8)
    sizes = np.zeros((T, 2), np.int32)
    canonical = np.zeros((T, oh, ow, 3), np.uint8)
    obj_tex = np.zeros((T, height, width, 3), np.uint8)
    for t, img in enumerate(natives):
        h, w = img.shape[:2]
        sources[t, :h, :w] = img
        sizes[t] = (h, w)
        canonical[t] = np.asarray(
            Image.fromarray(img).resize((ow, oh), Image.BILINEAR), np.uint8)
        if h >= height and w >= width:
            y0, x0 = h // 2 - height // 2, w // 2 - width // 2
            obj_tex[t] = img[y0 : y0 + height, x0 : x0 + width]
        else:
            obj_tex[t] = resize_linear(img, width, height)
    total_mb = sources.nbytes / (1024 * 1024)
    print(
        f"Loaded {T} textures (native FOV) with a total size of "
        f"{total_mb:.0f} MB."
    )
    return TextureDB(
        canonical=canonical, sources=sources, sizes=sizes, obj_tex=obj_tex
    )


def procedural_atlas(
    n_textures: int = 32, *, height: int = 384, width: int = 512, seed: int = 0
) -> np.ndarray:
    """Synthetic texture bank (T, 2H, 2W, 3) uint8: band-limited coloured
    noise with random low-frequency structure, no files required."""
    rng = np.random.default_rng(seed)
    oh, ow = 2 * height, 2 * width
    out = np.empty((n_textures, oh, ow, 3), np.uint8)
    yy, xx = np.mgrid[0:oh, 0:ow].astype(np.float32)
    for t in range(n_textures):
        img = np.zeros((oh, ow, 3), np.float32)
        for _ in range(6):
            fx, fy = rng.uniform(0.002, 0.08, 2)
            ph = rng.uniform(0, 2 * np.pi, 2)
            amp = rng.uniform(20, 70)
            wave = np.sin(2 * np.pi * (fx * xx + fy * yy) + ph[0]) * np.cos(
                2 * np.pi * (fy * xx - fx * yy) + ph[1]
            )
            img += amp * wave[..., None] * rng.uniform(0.2, 1.0, 3)
        img += rng.uniform(60, 180, 3)
        out[t] = np.clip(img, 0, 255).astype(np.uint8)
    return out


def atlas_for_config(cfg: DataGenConfig):
    """The configuration's texture databases (a :class:`TextureDB` with
    ``native_texture_fov``, else the canonical atlas), or the procedural
    bank at its frame size when none is configured."""
    if cfg.texture_dbases:
        return load_texture_db(
            cfg.texture_dbases, height=cfg.height, width=cfg.width,
            native_fov=cfg.native_texture_fov,
        )
    return procedural_atlas(height=cfg.height, width=cfg.width)
