"""The reference renderer: a straightforward painter's-algorithm render of a
scene, one sample and one object at a time.

For each sample: the background's two frames (a crop of its texture, the
second through the background's motion) and its affine flow; then every
valid object in ascending id, each frame on the window that its screen
bounding box covers (plus the antialiasing feather): exact-area coverage of
its primitives combined in slot order, the object texture (the frame-sized
centre crop of its source) blended in by coverage, its flow where it covers
at least half a pixel. Outside that window an object contributes nothing
(its coverage rounds away), so this equals evaluating every object over the
whole frame. Textures are read from the raw (T, SH, SW, 3) uint8 atlas:
bilinear taps with the reflect wrap folded into the coordinate and the
neighbour clamped at the texture's edge. Only rigid objects are drawn: a
mode that deforms objects is refused.
"""

from __future__ import annotations

import math

import torch

from . import affine, raster
from .fp import div, f32, mod
from .scenes import Scene

AA_MARGIN = 2.0


def _apply(m, x, y):
    """``m`` (2, 3) applied to coordinate grids, each product rounded on
    its own: ``(m00 x + m01 y) + m02``."""
    return (m[0, 0] * x + m[0, 1] * y + m[0, 2],
            m[1, 0] * x + m[1, 1] * y + m[1, 2])


def _fold(x, n):
    """A coordinate folded into [0, n - 1] under the reflect wrap (period
    2n, second half mirrored); in-range coordinates pass unchanged."""
    period = 2.0 * n
    u = mod(x + 0.5, period)
    xr = torch.where(u < n, u - 0.5, (period - u) - 0.5)
    in_range = (x >= 0) & (x <= n - 1)
    return torch.where(in_range, x, torch.clamp(xr, 0.0, n - 1.0))


def sample_reflect(tex, y0, x0, h, w, x, y):
    """Bilinear sample of the (h, w) region at (y0, x0) of one texture
    ``tex`` (SH, SW, 3) uint8, reflect-wrapped over that region, at float
    coordinates ``x``, ``y`` (texel centres at integers). Float32 (..., 3)."""
    SH, SW = tex.shape[:2]
    x = _fold(x, w)
    y = _fold(y, h)
    x0f = torch.floor(x)
    y0f = torch.floor(y)
    fx = (x - x0f)[..., None]
    fy = (y - y0f)[..., None]
    xi = torch.clamp(x0f.to(torch.int64), 0, w - 1) + x0
    yi = torch.clamp(y0f.to(torch.int64), 0, h - 1) + y0
    xn = torch.clamp(xi + 1, max=SW - 1)
    yn = torch.clamp(yi + 1, max=SH - 1)
    t = tex.to(torch.float32)
    v00, v01, v10, v11 = t[yi, xi], t[yi, xn], t[yn, xi], t[yn, xn]
    top = v00 + (v01 - v00) * fx
    bot = v10 + (v11 - v10) * fx
    return top + (bot - top) * fy


def crop_transform(src_h, src_w, out_h, out_w, angle_deg, zoom, shift_x,
                   shift_y):
    """Output -> source affine of the reference's randomized crop
    (Texture::getRandomizedCrop, DataGenerator.cpp:87-109) for a source at
    least as large as the request: resize from the anchored crop box, a
    rotation by ``angle_deg`` read as degrees about the source centre, an
    integer shift."""
    zoom = zoom.to(torch.float32)
    box_w = div(float(out_w), zoom)
    box_h = div(float(out_h), zoom)
    z = torch.zeros_like(zoom)
    scale = torch.stack([
        torch.stack([div(box_w, float(out_w)), z, z], -1),
        torch.stack([z, div(box_h, float(out_h)), z], -1)], -2)
    origin = affine.translation(torch.full_like(zoom, src_w / 2.0 - out_w / 2.0),
                                torch.full_like(zoom, src_h / 2.0 - out_h / 2.0))
    ang = angle_deg * f32(math.pi / 180.0)
    rot = affine.conjugate_about(affine.rotation(ang), src_w / 2.0, src_h / 2.0)
    unshift = affine.translation(-shift_x, -shift_y)
    return affine.chain(scale, origin, rot, unshift)


def _exact(t):
    return t


def lower_precision(t):
    """``t`` carried in bfloat16: the control's rounding."""
    return t.to(torch.bfloat16).to(torch.float32)


def _background(bg, tex, H, W, q=_exact):
    """The background's frames (H, W, 3) and forward flow (H, W, 2); every
    per-pixel value passes through ``q``."""
    SH, SW = tex.shape[:2]
    dev = tex.device
    ix, iy = raster.pixel_grid(W, H, 0.0, device=dev)
    cx, cy = W / 2.0, H / 2.0
    crop_t = crop_transform(SH, SW, 2 * H, 2 * W, bg.tex_rot_deg,
                            bg.tex_zoom, bg.tex_shift[0], bg.tex_shift[1])
    pixmot = affine.conjugate_about(bg.motion, cx, cy)
    big_inv = affine.invert(affine.conjugate_about(bg.motion, float(W),
                                                   float(H)))
    qx, qy = ix + cx, iy + cy
    sx, sy = _apply(crop_t, qx, qy)
    f0 = sample_reflect(tex, 0, 0, SH, SW, q(sx), q(sy))
    bx, by = _apply(big_inv, qx, qy)
    sx, sy = _apply(crop_t, q(bx), q(by))
    f1 = sample_reflect(tex, 0, 0, SH, SW, q(sx), q(sy))
    fqx, fqy = _apply(pixmot, ix, iy)
    flow = q(torch.stack([fqx - ix, fqy - iy], -1))
    return torch.round(q(f0)), torch.round(q(f1)), flow


def _bbox(prims, k, tr):
    """Screen bbox (x_lo, y_lo, x_hi, y_hi) of object ``k``'s valid
    primitives under their transforms ``tr`` (C, 2, 3), as Python floats."""
    lo, hi = [], []
    for c in range(prims.valid.shape[1]):
        if not bool(prims.valid[k, c]):
            continue
        if bool(prims.is_poly[k, c]):
            n = int(prims.n_edges[k, c])
            pts = affine.apply(tr[c], prims.edge_pts[k, c, :max(n, 1)])
            lo.append(pts.amin(0))
            hi.append(pts.amax(0))
        else:
            lin = tr[c, :, :2]
            ex = lin[:, 0] * prims.ell_rx[k, c]
            ey = lin[:, 1] * prims.ell_ry[k, c]
            ext = torch.sqrt(ex * ex + ey * ey)
            lo.append(tr[c, :, 2] - ext)
            hi.append(tr[c, :, 2] + ext)
    if not lo:
        return None
    lo = torch.stack(lo).amin(0).tolist()
    hi = torch.stack(hi).amax(0).tolist()
    return lo[0], lo[1], hi[0], hi[1]


def _window(box, H, W):
    """Integer pixel window (y0, y1, x0, x1) of a bbox plus the feather,
    clipped to the frame, or None when it misses the frame."""
    if box is None:
        return None
    x0 = max(0, math.floor(box[0] - AA_MARGIN))
    y0 = max(0, math.floor(box[1] - AA_MARGIN))
    x1 = min(W, math.ceil(box[2] + AA_MARGIN) + 1)
    y1 = min(H, math.ceil(box[3] + AA_MARGIN) + 1)
    if x0 >= x1 or y0 >= y1:
        return None
    return y0, y1, x0, x1


def _coverage(prims, k, tr, px, py):
    """Composite coverage (aa, inside) of object ``k`` at pixel centres
    ``px``, ``py`` (h, w): its primitives in slot order, each added
    (screen union) or subtracted."""
    aa_acc = torch.zeros_like(px)
    in_acc = torch.zeros(px.shape, dtype=torch.bool, device=px.device)
    for c in range(prims.valid.shape[1]):
        if not bool(prims.valid[k, c]):
            continue
        if bool(prims.is_poly[k, c]):
            pts = affine.apply(tr[c], prims.edge_pts[k, c])
            aa, inside = raster.polygon_coverage(
                pts, int(prims.n_edges[k, c]), px, py)
        else:
            aa, inside = raster.ellipse_coverage(
                tr[c], prims.ell_rx[k, c], prims.ell_ry[k, c], px, py)
        if bool(prims.additive[k, c]):
            aa_acc, in_acc = raster.combine_additive(aa_acc, in_acc, aa, inside)
        else:
            aa_acc, in_acc = raster.combine_subtractive(aa_acc, in_acc, aa,
                                                        inside)
    return aa_acc, in_acc


def render_scene(scene: Scene, atlas, H, W, use_aa=True, lowp=False):
    """Render sample 0 of ``scene`` (leaves with a batch axis of one):
    (image0, image1, flow0), images (H, W, 3) float32 in [0, 255], flow
    (H, W, 2) in pixels. ``atlas`` is the (T, SH, SW, 3) uint8 texture bank
    on the device to render on. ``lowp`` carries every per-pixel value
    (sampling coordinates, coverage, texels, blends, flow) in bfloat16: the
    control, which the check has to refuse."""
    q = lower_precision if lowp else _exact
    T, SH, SW = atlas.shape[:3]
    bg = type(scene.background)(*(t[0] for t in scene.background))
    objs = type(scene.objects)(*(t[0] for t in scene.objects))
    prims = type(scene.prims)(*(t[0] for t in scene.prims))
    frame0, frame1, flow0 = _background(bg, atlas[int(bg.tex_id) % T], H, W,
                                        q)
    cy0, cx0 = (SH - H) // 2, (SW - W) // 2
    for k in range(objs.valid.shape[0]):
        if not bool(objs.valid[k]):
            continue
        tex = atlas[int(objs.tex_id[k]) % T]
        motion, motion_inv = objs.motion[k], objs.motion_inv[k]
        tr0 = prims.intrinsic[k]
        tr1 = affine.compose(tr0, motion[None])
        for fr, tr in ((0, tr0), (1, tr1)):
            win = _window(_bbox(prims, k, tr), H, W)
            if win is None:
                continue
            y0, y1, x0, x1 = win
            ys = torch.arange(y0, y1, dtype=torch.float32, device=atlas.device)
            xs = torch.arange(x0, x1, dtype=torch.float32, device=atlas.device)
            py, px = torch.meshgrid(ys, xs, indexing="ij")
            aa, inside = _coverage(prims, k, tr, px + 0.5, py + 0.5)
            m = q(aa if use_aa else inside.to(torch.float32))[..., None]
            if fr == 0:
                texels = tex[cy0 + py.long(), cx0 + px.long()].to(torch.float32)
                frame0[y0:y1, x0:x1] = torch.round(
                    q(frame0[y0:y1, x0:x1] * (1.0 - m) + texels * m))
                mx, my = _apply(motion, px, py)
                fl = q(torch.stack([mx - px, my - py], -1))
                flow0[y0:y1, x0:x1] = torch.where(inside[..., None], fl,
                                                  flow0[y0:y1, x0:x1])
            else:
                sx, sy = _apply(motion_inv, px, py)
                texels = sample_reflect(tex, cy0, cx0, H, W, q(sx), q(sy))
                frame1[y0:y1, x0:x1] = torch.round(
                    q(frame1[y0:y1, x0:x1] * (1.0 - m) + q(texels) * m))
    return frame0, frame1, flow0
