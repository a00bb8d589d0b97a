"""FlyingChairs distribution shapers (port of ``flowgen/random/shapers.py``).

Stateless maps from raw standard-normal or uniform draws to the reference's
power-law shaped ranges (``DataGenerator::FlyingChairsRandom``,
DataGenerator.cpp:826-922). Every function takes its raw draws explicitly.
"""

from __future__ import annotations

import torch

from .._fp import div, f32


def base_gauss(a, b, x, normalize):
    """Map a (shaped) normal sample into [a, b]; out-of-range falls back to
    the midpoint (baseGauss, DataGenerator.cpp:828-831)."""
    mid = (b + a) / 2.0
    sample = div(x * (mid - a), normalize) + mid
    ok = (f32(a) <= sample) & (sample <= f32(b))
    return torch.where(ok, sample, torch.full_like(sample, mid))


def gaussian(a, b, n01):
    """Gaussian shaper, normaliser 3 (DataGenerator.cpp:873-879)."""
    return base_gauss(a, b, n01, 3.0)


def gaussian_sq(a, b, n01):
    """Signed-square shaper, normaliser 6 (DataGenerator.cpp:882-890)."""
    t = torch.sign(n01) * (n01 * n01)
    return base_gauss(a, b, t, 6.0)


def gaussian_cube(a, b, n01):
    """Cube shaper, normaliser 10 (DataGenerator.cpp:893-900)."""
    return base_gauss(a, b, (n01 * n01) * n01, 10.0)


def gaussian_4(a, b, n01):
    """Signed-4th-power shaper, normaliser 15 (DataGenerator.cpp:903-911)."""
    sq = n01 * n01
    t = torch.sign(n01) * (sq * sq)
    return base_gauss(a, b, t, 15.0)


def gaussian_mean_sigma_range(a, b, mean, sigma, n01):
    """Clamped-to-mean normal (DataGenerator.cpp:914-921)."""
    t = n01 * sigma + mean
    ok = (f32(a) <= t) & (t <= f32(b))
    return torch.where(ok, t, torch.full_like(t, mean))


def trigger(p, u01):
    """True with probability ``p`` given u ~ U[0,1) (cpp:846-849)."""
    return u01 < f32(p)


def choice(options, uint):
    """Uniform choice over a static tuple given an unbounded random int
    (cpp:852-861)."""
    opts = torch.as_tensor(options, device=uint.device)
    return opts[(uint % opts.shape[0]).long()]
