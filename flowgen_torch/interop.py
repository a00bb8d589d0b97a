"""State carried between the JAX package and the port, as numpy arrays.

``scene_from_numpy`` turns a JAX ``Scene`` whose leaves were converted with
``jax.tree.map(np.asarray, scene)`` (or any object with the same field
names) into the port's ``Scene``; ``slabs_from_numpy`` does the same for
packed texture slabs. Tests use them to feed both renderers the same scene,
separately from RNG parity. Nothing here imports JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from .params.blueprint import Background, Objects, Primitives, Scene

_TYPES = {"Background": Background, "Objects": Objects,
          "Primitives": Primitives, "Scene": Scene}


def _leaf(x, device):
    a = np.asarray(x)
    if a.dtype == np.bool_:
        return torch.from_numpy(a.copy()).to(device)
    if np.issubdtype(a.dtype, np.integer):
        return torch.from_numpy(a.astype(np.int32)).to(device)
    return torch.from_numpy(a.astype(np.float32)).to(device)


def _convert(rec, cls, device):
    vals = []
    for name in cls._fields:
        v = getattr(rec, name)
        sub = _TYPES.get(type(v).__name__)
        vals.append(_convert(v, sub, device) if sub is not None
                    else _leaf(v, device))
    return cls(*vals)


def scene_from_numpy(tree, device="cpu") -> Scene:
    """A batched scene record of numpy leaves -> the port's ``Scene``."""
    return _convert(tree, Scene, torch.device(device))


def slabs_from_numpy(slabs, device="cpu") -> torch.Tensor:
    """Packed int32 texture slabs (T, SH, SW) -> a tensor on ``device``."""
    return torch.from_numpy(np.asarray(slabs).astype(np.int32)).to(device)
