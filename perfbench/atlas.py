"""The texture bank of a run, made on the device from the seed: a copy of
the port's procedural recipe (``texture_io.procedural_atlas``: six
band-limited coloured waves a texture on a random base colour) written as
a few large tensor operations over all textures at once, with its draws
from a ``torch.Generator`` on the device. The numpy recipe draws in another
order, so the two banks differ; the program and the reference both read
this one."""

from __future__ import annotations

import math

import torch

WAVES = 6


def procedural_atlas(n: int, height: int, width: int, seed: int,
                     device) -> torch.Tensor:
    """(n, height, width, 3) uint8 textures from ``seed``."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))

    def u(lo, hi, *shape):
        return torch.rand(shape, generator=g, device=device) * (hi - lo) + lo

    freq = u(0.002, 0.08, n, WAVES, 2)
    phase = u(0.0, 2 * math.pi, n, WAVES, 2)
    amp = u(20.0, 70.0, n, WAVES)
    tint = u(0.2, 1.0, n, WAVES, 3)
    base = u(60.0, 180.0, n, 3)
    yy = torch.arange(height, dtype=torch.float32, device=device)[:, None]
    xx = torch.arange(width, dtype=torch.float32, device=device)[None, :]
    img = base[:, None, None, :].expand(n, height, width, 3).clone()
    for w in range(WAVES):
        fx = freq[:, w, 0, None, None]
        fy = freq[:, w, 1, None, None]
        wave = (torch.sin(2 * math.pi * (fx * xx + fy * yy)
                          + phase[:, w, 0, None, None])
                * torch.cos(2 * math.pi * (fy * xx - fx * yy)
                            + phase[:, w, 1, None, None]))
        img += (amp[:, w, None, None] * wave)[..., None] \
            * tint[:, w, None, None, :]
    return torch.clamp(img, 0, 255).to(torch.uint8)
