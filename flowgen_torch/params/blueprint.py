"""Scene description records (port of ``flowgen/params/blueprint.py``).

Struct-of-tensors scenes of fixed capacity: ``MAX_OBJECTS`` object slots and
``MAX_COMPONENTS`` primitive slots per object, with validity masks. Every
leaf carries a leading batch dimension ``B``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class Background(NamedTuple):
    """Background blueprint (generateBackground, DataGenerator.cpp:2105-2143)."""

    motion: torch.Tensor       # (B,2,3)
    tex_id: torch.Tensor       # (B,) int32
    tex_rot_deg: torch.Tensor  # (B,) sampled in [-pi, pi], applied as degrees
    tex_zoom: torch.Tensor     # (B,)
    tex_shift: torch.Tensor    # (B,2)
    warp: torch.Tensor         # (B,) bool
    warp_slot: torch.Tensor    # (B,) int32


class Objects(NamedTuple):
    """Per-object state shared by all of an object's primitives. (B,K) leaves."""

    valid: torch.Tensor        # bool (B,K)
    tex_id: torch.Tensor       # int32 (B,K)
    motion: torch.Tensor       # f32 (B,K,2,3) incl. background conjugation
    motion_inv: torch.Tensor   # f32 (B,K,2,3)
    warp: torch.Tensor         # bool (B,K)
    warp_slot: torch.Tensor    # int32 (B,K)


class Primitives(NamedTuple):
    """Per-primitive geometry. (B,K,C) leaves."""

    valid: torch.Tensor        # bool (B,K,C)
    additive: torch.Tensor     # bool (B,K,C)
    is_poly: torch.Tensor      # bool (B,K,C)
    intrinsic: torch.Tensor    # f32 (B,K,C,2,3)
    ell_rx: torch.Tensor       # f32 (B,K,C)
    ell_ry: torch.Tensor       # f32 (B,K,C)
    edge_pts: torch.Tensor     # f32 (B,K,C,E,2)
    n_edges: torch.Tensor      # int32 (B,K,C)


class Scene(NamedTuple):
    """A batch of complete generation recipes."""

    background: Background
    objects: Objects
    prims: Primitives
    n_objects: torch.Tensor    # int32 (B,)


def map_scene(fn, scene):
    """Apply ``fn`` to every tensor leaf of a scene record."""
    if isinstance(scene, tuple) and hasattr(scene, "_fields"):
        return type(scene)(*(map_scene(fn, v) for v in scene))
    return fn(scene)
