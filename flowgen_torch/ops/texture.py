"""Texture sampling and crop transforms (port of ``flowgen/ops/texture.py``).

Bilinear gathers with the AGG reflect, clamp and zero wraps, the quad-packed
tables that hold each texel's 2x2 footprint in one row (``make_quad``), and
the output -> source affine of Texture::getRandomizedCrop
(DataGenerator.cpp:87-109), including the reference's quirk of applying a
rotation sampled in radians as degrees. The samplers take a leading batch:
an image (N, h, w, C) is sampled at coordinates (N, ...), each sample from
its own image.
"""

from __future__ import annotations

import math

import torch

from .._fp import div, f32, fma, mod
from . import affine


def _wrap_indices(i, n, mode):
    """Integer texel indices under AGG's reflect wrap (period 2n, second
    half mirrored) or clamped ("clamp", and "zero", whose caller masks)."""
    if mode == "reflect":
        period = 2 * n
        i = torch.remainder(i, period)
        return torch.where(i >= n, period - 1 - i, i)
    if mode in ("clamp", "zero"):
        return torch.clamp(i, 0, n - 1)
    raise ValueError(f"unknown wrap mode {mode}")


def _batch_rows(n_img, h, w, x):
    """Row offset of each sample's image in a flattened (N*h*w, C) stack."""
    base = torch.arange(n_img, device=x.device) * (h * w)
    return base.reshape((n_img,) + (1,) * (x.dim() - 1))


def _lerp(a, b, t, contract):
    """``a + (b - a) * t``; with ``contract`` the product and the sum round
    once (``_fp.fma``), as XLA:CPU contracts them inside a fused loop."""
    d = b - a
    return fma(d, t, a) if contract else a + d * t


def _bilerp(v00, v01, v10, v11, fx, fy, contract):
    top = _lerp(v00, v01, fx, contract)
    bot = _lerp(v10, v11, fx, contract)
    return _lerp(top, bot, fy, contract)


def sample_bilinear(img, x, y, wrap="reflect", contract=False):
    """Bilinear sample ``img`` (h, w, C), or (N, h, w, C) against
    coordinates (N, ...), at float coords (x, y), texel centres at integers.
    Returns x's shape with a trailing channel axis. ``contract``: each lerp
    as one FMA, the JAX package's bits where XLA compiles the sampler into a
    loop (the mode-9 "xla" stream)."""
    h, w = img.shape[-3], img.shape[-2]
    base = _batch_rows(img.shape[0], h, w, x) if img.dim() == 4 else 0
    return sample_bilinear_flat(img.reshape(-1, img.shape[-1]), base, h, w,
                                x, y, wrap, contract=contract)


def sample_bilinear_flat(flat, base, h, w, x, y, wrap="reflect",
                         scrub_nan=False, contract=False):
    """:func:`sample_bilinear` against a stack of (h, w) images flattened to
    (N*h*w, C), each sample's image selected by its row offset ``base``;
    ``scrub_nan`` replaces NaN texels by 0 before the lerp."""
    x0f = torch.floor(x)
    y0f = torch.floor(y)
    fx = (x - x0f)[..., None]
    fy = (y - y0f)[..., None]
    x0 = x0f.to(torch.int64)
    y0 = y0f.to(torch.int64)
    xi0 = _wrap_indices(x0, w, wrap)
    xi1 = _wrap_indices(x0 + 1, w, wrap)
    yi0 = _wrap_indices(y0, h, wrap)
    yi1 = _wrap_indices(y0 + 1, h, wrap)

    def tap(yi, xi):
        v = flat[base + yi * w + xi]
        return torch.nan_to_num(v) if scrub_nan else v

    out = _bilerp(tap(yi0, xi0), tap(yi0, xi1), tap(yi1, xi0), tap(yi1, xi1),
                  fx, fy, contract)
    if wrap == "zero":
        ok = (x >= 0) & (x <= w - 1) & (y >= 0) & (y <= h - 1)
        out = torch.where(ok[..., None], out, torch.zeros_like(out))
    return out


def make_quad(img):
    """Pack each texel's 2x2 bilinear footprint into one row: (..., h, w, C)
    -> (..., h, w, 4C) as [p00 | p01 | p10 | p11], edge neighbours clamped
    (which coincides with reflect at the boundary)."""
    right = torch.cat([img[..., :, 1:, :], img[..., :, -1:, :]], dim=-2)
    down = torch.cat([img[..., 1:, :, :], img[..., -1:, :, :]], dim=-3)
    downright = torch.cat([right[..., 1:, :, :], right[..., -1:, :, :]], dim=-3)
    return torch.cat([img, right, down, downright], dim=-1)


def _reflect_fold_coord(x, n):
    """Fold a continuous coordinate into [0, n-1] under AGG reflect wrap so
    that in-range bilinear with edge-clamped neighbours is exactly
    reflect-bilinear; in-range coordinates pass through untouched."""
    period = 2.0 * n
    u = mod(x + 0.5, period)
    xr = torch.where(u < n, u - 0.5, (period - u) - 0.5)
    in_range = (x >= 0) & (x <= n - 1)
    return torch.where(in_range, x, torch.clamp(xr, 0.0, n - 1.0))


def sample_bilinear_quad(quad, x, y, wrap="reflect", channels=3,
                         contract=False):
    """Bilinear sample from one quad-packed table (h, w, 4c), or a stack
    (N, h, w, 4c) against coordinates (N, ...): one row gather per sample
    point. ``contract`` as in :func:`sample_bilinear`."""
    h, w = quad.shape[-3], quad.shape[-2]
    base = _batch_rows(quad.shape[0], h, w, x) if quad.dim() == 4 else 0
    return sample_bilinear_quad_flat(quad.reshape(-1, 4 * channels), base, h,
                                     w, x, y, wrap=wrap, channels=channels,
                                     contract=contract)


def sample_bilinear_quad_flat(flat, base, h, w, x, y, wrap="reflect",
                              channels=3, row_stride=None, contract=False):
    """Bilinear sample from quad-packed tables (``make_quad``), one row
    gather per sample point (the JAX package's ``sample_bilinear_quad`` and
    ``sample_bilinear_quad_flat``): a stack of (h, w, 4c) tables flattened
    to (T*h*w, 4c), each sample's texture selected by its row offset
    ``base`` (broadcastable to x). ``row_stride`` (default ``w``) reads an
    (h, w) crop of a wider table."""
    if wrap == "reflect":
        x = _reflect_fold_coord(x, w)
        y = _reflect_fold_coord(y, h)
    x0f = torch.floor(x)
    y0f = torch.floor(y)
    fx = (x - x0f)[..., None]
    fy = (y - y0f)[..., None]
    clamp_wrap = "clamp" if wrap == "reflect" else wrap
    xi = _wrap_indices(x0f.to(torch.int64), w, clamp_wrap)
    yi = _wrap_indices(y0f.to(torch.int64), h, clamp_wrap)
    stride = w if row_stride is None else row_stride
    rows = flat[base + yi * stride + xi].to(torch.float32)
    out = _bilerp(*(rows[..., i * channels : (i + 1) * channels]
                    for i in range(4)), fx, fy, contract)
    if wrap == "zero":
        ok = (x >= 0) & (x <= w - 1) & (y >= 0) & (y <= h - 1)
        out = torch.where(ok[..., None], out, torch.zeros_like(out))
    return out


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
    the whole image (zoom ignored). ``src_h`` / ``src_w`` are Python numbers
    (an atlas) or per-sample integer tensors (a TextureDB's native sizes);
    tensors select between the two chains elementwise, in float32 as the
    JAX package's traced sizes do."""
    per_sample = torch.is_tensor(src_h) or torch.is_tensor(src_w)
    if per_sample:
        src_h = torch.as_tensor(src_h, device=zoom.device).to(torch.float32)
        src_w = torch.as_tensor(src_w, device=zoom.device).to(torch.float32)
    crop_t = randomized_crop_transform(
        src_h, src_w, out_h, out_w, angle_deg, zoom, shift_x, shift_y
    )
    if not per_sample and src_w >= out_w and src_h >= out_h:
        return crop_t
    zoom = zoom.to(torch.float32)
    z = torch.zeros_like(zoom)
    if per_sample:
        sx = div(src_w, float(out_w))
        sy = div(src_h, float(out_h))
    else:
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
    resize_t = affine.chain(scale, rot, unshift)
    if not per_sample:
        return resize_t
    big = ((src_w >= out_w) & (src_h >= out_h))[..., None, None]
    return torch.where(big, crop_t, resize_t)


# ---------------------------------------------------------------------------
# The standalone warps: one image, one op at a time
# ---------------------------------------------------------------------------


def affine_warp(img, transform, px, py, wrap="reflect"):
    """Backward warp ``out(p) = img(transform^-1 (p))`` of one image ``img``
    (h, w, C) at pixel coordinates ``px``, ``py`` (any shape), as
    getTransformedTexture (DataGenerator.cpp:168-231) inverts its matrix
    for the destination -> source map. ``transform`` (2, 3). Returns px's
    shape with a trailing channel axis."""
    inv = affine.invert(torch.as_tensor(transform, dtype=torch.float32,
                                        device=img.device))
    sx, sy = affine.apply_xy(inv, px, py)
    return sample_bilinear(img, sx, sy, wrap=wrap)


def randomized_crop(src, out_h: int, out_w: int, angle_deg, zoom, shift_x,
                    shift_y):
    """Texture::getRandomizedCrop (DataGenerator.cpp:87-109) of one source
    ``src`` (h, w, C) at least as large as the (out_h, out_w) output: the
    shift -> rotate -> crop -> resize chain as one output -> source affine
    (:func:`randomized_crop_transform`), one reflect-wrapped bilinear
    gather. Returns (out_h, out_w, C) float32."""
    dev = src.device
    zoom = torch.as_tensor(zoom, dtype=torch.float32, device=dev)
    t = randomized_crop_transform(
        src.shape[0], src.shape[1], out_h, out_w,
        torch.as_tensor(angle_deg, dtype=torch.float32, device=dev), zoom,
        torch.as_tensor(shift_x, dtype=torch.float32, device=dev),
        torch.as_tensor(shift_y, dtype=torch.float32, device=dev))
    yy, xx = torch.meshgrid(
        torch.arange(out_h, dtype=torch.float32, device=dev),
        torch.arange(out_w, dtype=torch.float32, device=dev), indexing="ij")
    sx, sy = affine.apply_xy(t, xx, yy)
    return sample_bilinear(src.to(torch.float32), sx, sy, wrap="reflect")


def warp_by_flow(img, iflow, wrap="zero"):
    """applyWarpFieldToTexture (DataGenerator.cpp:237-252): ``out(x, y) =
    img(x + iflow_x, y + iflow_y)``, zero outside (``wrap``), for one image
    (h, w, C) and its inverse flow (h, w, 2); a NaN flow entry (a flagged
    bank pixel) counts as zero displacement."""
    h, w = img.shape[0], img.shape[1]
    yy, xx = torch.meshgrid(
        torch.arange(h, dtype=torch.float32, device=img.device),
        torch.arange(w, dtype=torch.float32, device=img.device),
        indexing="ij")
    dx = torch.nan_to_num(iflow[..., 0])
    dy = torch.nan_to_num(iflow[..., 1])
    return sample_bilinear(img, xx + dx, yy + dy, wrap=wrap)
