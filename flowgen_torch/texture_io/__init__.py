"""Texture banks for the PyTorch port.

The port's copy of the procedural texture bank of the JAX package
(``flowgen/texture_io/__init__.py``): band-limited coloured noise, made with
numpy from a seed, so both packages render from byte-identical atlases. Only
the procedural branch is ported; texture databases on disk (the
``TextureDB`` path and its native loader) are a later slice.
"""

from __future__ import annotations

import numpy as np

from ..config import DataGenConfig


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
    """The procedural bank at the config's frame size. Texture databases on
    disk are not ported yet (ROADMAP.md, port queue item 2)."""
    if cfg.texture_dbases:
        raise NotImplementedError(
            "texture_dbases / TextureDB is not ported yet "
            "(ROADMAP.md, port queue item 2: the TextureDB path)"
        )
    return procedural_atlas(height=cfg.height, width=cfg.width)
