"""Float32 helpers that keep the port's arithmetic identical to the JAX
package's.

PyTorch evaluates ``scalar / tensor`` as ``reciprocal(tensor) * scalar`` on
every device, and ``tensor / scalar`` as a product with the reciprocal on
CUDA; both differ from a true division in the last bit. XLA divides. So every
division in the port goes through :func:`div`, which always divides two
tensors of the same device.
"""

from __future__ import annotations

import numpy as np
import torch


def f32(x) -> float:
    """A Python float rounded to float32, as JAX rounds a weakly typed
    constant before it meets a float32 array (comparisons included)."""
    return float(np.float32(x))


def div(a, b):
    """IEEE float32 ``a / b`` where either side may be a Python scalar."""
    if not torch.is_tensor(a):
        a = torch.full_like(b, a)
    elif not torch.is_tensor(b):
        b = torch.full_like(a, b)
    return torch.div(a, b)


def sqrt(x):
    """Correctly rounded float32 square root on any device: taken in float64
    and rounded once (exact, as float64 carries more than twice the bits)."""
    return torch.sqrt(x.double()).to(x.dtype)


def mod(a, b):
    """``jnp.mod`` for floats: the sign of the divisor, built on ``fmod``
    (``torch.remainder`` computes ``a - b * floor(a / b)`` instead)."""
    if not torch.is_tensor(b):
        b = torch.full_like(a, b)
    r = torch.fmod(a, b)
    fix = (r != 0) & ((r < 0) != (b < 0))
    return torch.where(fix, r + b, r)
