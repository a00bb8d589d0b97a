"""The reference of rigid scenes: the modes whose objects move by affine
transforms alone. From the seed it draws the scenes of the requested global
sample indices (``scenes.py``, ``streams.py``), renders each with a
straightforward painter's algorithm (``render.py``), applies FlowNet's
photometric jitter when asked (``photometric.py``) and lays the outputs out
as the program's configuration says. A configuration without a
``reference`` key renders through this module.
"""

from __future__ import annotations

import torch

from . import photometric
from .render import render_scene
from .scenes import MODES, map_scene, sample_scene
from .streams import root_key, sample_key

# Settings of the program's configuration that the reference renders.
SUPPORTED = {"mode", "width", "height", "use_antialiasing", "prefetch",
             "photometric_augment", "channel_order", "layout", "batch_size",
             "seed"}


def check_supported(cfg: dict):
    """Raise for a configuration the reference cannot render: another
    setting than :data:`SUPPORTED`, or a mode that deforms objects."""
    extra = sorted(set(cfg) - SUPPORTED)
    if extra:
        raise ValueError(f"the reference does not render {extra}")
    if MODES[int(cfg.get("mode", 1))].warp_p > 0.0:
        raise ValueError("the reference draws rigid objects only")


def render_rows(seed: int, indices, cfg: dict, atlas, lowp=False) -> dict:
    """The outputs of global sample indices ``indices`` (a list of ints) of
    the stream of ``seed``: a dict of (n, H, W, C) float32 tensors on the
    atlas's device, keyed as the program's outputs. ``cfg`` holds the
    program's configuration values by name; ``atlas`` is the (T, SH, SW, 3)
    uint8 texture bank. ``lowp`` renders the control (``render_scene``)."""
    check_supported(cfg)
    H, W = int(cfg["height"]), int(cfg["width"])
    dev = atlas.device
    spec = MODES[int(cfg["mode"])]
    root = root_key(seed, dev)
    idx = torch.as_tensor(list(indices), dtype=torch.int64, device=dev)
    scenes = sample_scene(sample_key(root, idx), spec, width=W, height=H)
    rows = []
    for i in range(idx.shape[0]):
        one = map_scene(lambda t: t[i:i + 1], scenes)
        rows.append(render_scene(one, atlas, H, W,
                                 bool(cfg.get("use_antialiasing", True)),
                                 lowp))
    i0, i1, f0 = (torch.stack(t) for t in zip(*rows))
    if cfg.get("photometric_augment", False):
        i0, i1 = photometric.augment_batch(root, idx, i0, i1)
    if cfg.get("channel_order", "rgb") == "bgr":
        i0, i1 = i0.flip(-1), i1.flip(-1)
    out = {"image0": i0, "image1": i1, "flow0": f0}
    if cfg.get("layout", "nhwc") == "nchw":
        out = {k: v.movedim(-1, 1) for k, v in out.items()}
    return out
