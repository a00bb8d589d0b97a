"""State carried between the JAX package and the port, as numpy arrays.

``scene_from_numpy`` turns a JAX ``Scene`` whose leaves were converted with
``jax.tree.map(np.asarray, scene)`` (or any object with the same field
names) into the port's ``Scene``; ``slabs_from_numpy`` does the same for
packed texture slabs, ``bank_from_numpy`` and ``aux_from_numpy`` for the
mode-9 warp bank and its warp planes, ``texture_db_from_numpy`` for a
texture database, ``flownet_params_from_flax`` for the FlowNetS trainer's
weights. Tests use them to feed both packages the same scene, bank,
textures and weights, separately from RNG parity. Nothing here imports
JAX.
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


def _f32_tensor(x, device):
    return torch.from_numpy(np.asarray(x).astype(np.float32)).to(device)


def bank_from_numpy(bank, device="cpu"):
    """A mode-9 warp bank with numpy ``flow`` / ``iflow`` (N, H, W, 2) ->
    the port's ``WarpBank``."""
    from .compose.render import WarpBank

    return WarpBank(flow=_f32_tensor(bank.flow, device),
                    iflow=_f32_tensor(bank.iflow, device))


def aux_from_numpy(aux, device="cpu"):
    """The scene kernel's warp planes ``(obj_aux, bg_aux)`` as numpy arrays
    -> the port's ``WarpAux`` on ``device``, its background bands derived
    from ``bg_aux``."""
    from .compose.render import WarpAux
    from .ops.scene import bg_band_starts

    obj_aux, bg_aux = (_f32_tensor(a, device) for a in aux)
    return WarpAux(obj_aux, bg_aux, bg_band_starts(bg_aux))


def texture_db_from_numpy(db):
    """The JAX package's ``TextureDB`` (numpy ``canonical``, ``sources``,
    ``sizes``, ``obj_tex``; any object with those fields) -> the port's
    ``texture_io.TextureDB``, its arrays copied as uint8 (sizes int32)."""
    from .texture_io import TextureDB

    return TextureDB(
        canonical=np.array(db.canonical, np.uint8),
        sources=np.array(db.sources, np.uint8),
        sizes=np.array(db.sizes, np.int32),
        obj_tex=np.array(db.obj_tex, np.uint8),
    )


def _flax_layers(params, prefix):
    names = [k for k in params if k.startswith(prefix + "_")]
    return [params[n] for n in sorted(names, key=lambda n: int(n.split("_")[1]))]


def flownet_params_from_flax(params) -> dict:
    """The JAX package's FlowNetS parameters (its flax ``params`` tree with
    numpy leaves: ``Conv_0`` .. ``Conv_14``, ``ConvTranspose_0`` .. ``_3``,
    each ``{"kernel", "bias"}``) as a ``state_dict`` of
    ``train/flownet.py:FlowNetS``. Convolutions are named in the order flax
    creates them: the ten encoder layers, then the five predictions
    (coarse to fine) between the four transposed convolutions. A conv
    kernel (kh, kw, cin, cout) becomes (cout, cin, kh, kw); a transposed
    conv kernel (kh, kw, cin, cout) becomes (cin, cout, kh, kw) flipped in
    both spatial axes; biases are as they are."""
    convs = _flax_layers(params, "Conv")
    ups = _flax_layers(params, "ConvTranspose")
    if len(convs) != 15 or len(ups) != 4:
        raise ValueError(f"expected 15 Conv and 4 ConvTranspose layers, got "
                         f"{len(convs)} and {len(ups)}")

    def t(a):
        return torch.from_numpy(np.array(a, dtype=np.float32))

    out = {}
    names = [f"enc.{i}" for i in range(10)] + [f"predict.{i}" for i in range(5)]
    for name, layer in zip(names, convs):
        out[name + ".weight"] = t(np.transpose(layer["kernel"], (3, 2, 0, 1)))
        out[name + ".bias"] = t(layer["bias"])
    for i, layer in enumerate(ups):
        k = np.transpose(layer["kernel"], (2, 3, 0, 1))[:, :, ::-1, ::-1]
        out[f"up.{i}.weight"] = t(k)
        out[f"up.{i}.bias"] = t(layer["bias"])
    return out
