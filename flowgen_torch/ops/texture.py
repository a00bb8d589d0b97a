"""Texture crop transforms (port of ``flowgen/ops/texture.py:169-237``).

The output -> source affine of Texture::getRandomizedCrop
(DataGenerator.cpp:87-109), including the reference's quirk of applying a
rotation sampled in radians as degrees.
"""

from __future__ import annotations

import math

import torch

from .._fp import div, f32
from . import affine


def _scalar_like(x, like):
    return x if torch.is_tensor(x) else torch.full_like(like, float(x))


def randomized_crop_transform(src_h, src_w, out_h, out_w, angle_deg, zoom,
                              shift_x, shift_y):
    """Output -> source affine of getRandomizedCrop for sources at least as
    large as the request: resize from the anchored crop box, rotation by
    ``angle_deg`` degrees about the source centre, integer shift."""
    zoom = zoom.to(torch.float32)
    box_w = div(float(out_w), zoom)
    box_h = div(float(out_h), zoom)
    z = torch.zeros_like(zoom)
    scale = torch.stack(
        [
            torch.stack([div(box_w, float(out_w)), z, z], -1),
            torch.stack([z, div(box_h, float(out_h)), z], -1),
        ],
        -2,
    )
    crop_origin = affine.translation(
        _scalar_like(src_w / 2.0 - out_w / 2.0, zoom),
        _scalar_like(src_h / 2.0 - out_h / 2.0, zoom),
    )
    ang = angle_deg * f32(math.pi / 180.0)
    rot = affine.conjugate_about(affine.rotation(ang), src_w / 2.0, src_h / 2.0)
    unshift = affine.translation(-shift_x, -shift_y)
    return affine.chain(scale, crop_origin, rot, unshift)


def randomized_crop_transform_native(src_h, src_w, out_h, out_w, angle_deg,
                                     zoom, shift_x, shift_y):
    """Per-source crop transform with the reference's small-source fallback
    (cpp:96-108): sources smaller than the request shift, rotate and resize
    the whole image (zoom ignored). Only Python-number source sizes are
    ported (the procedural and canonical atlases)."""
    crop_t = randomized_crop_transform(
        src_h, src_w, out_h, out_w, angle_deg, zoom, shift_x, shift_y
    )
    if src_w >= out_w and src_h >= out_h:
        return crop_t
    zoom = zoom.to(torch.float32)
    z = torch.zeros_like(zoom)
    sx = f32(src_w / out_w)
    sy = f32(src_h / out_h)
    scale = torch.stack(
        [torch.stack([sx + z, z, z], -1), torch.stack([z, sy + z, z], -1)], -2
    )
    ang = angle_deg * f32(math.pi / 180.0)
    rot = affine.conjugate_about(
        affine.rotation(ang), src_w / 2.0, src_h / 2.0
    )
    unshift = affine.translation(-shift_x, -shift_y)
    return affine.chain(scale, rot, unshift)
