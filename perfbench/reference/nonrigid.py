"""The reference of nonrigid scenes (mode 9, "7 + nonrigid deformations"):
the scenes and the painter's render of ``rigid``, plus the warp-field
bank's deformations, as the scene kernel's content defines them.

For the bank epoch of each compared row (``step // warp_bank_reuse_steps``)
it builds the bank (``warpbank.py``), once per epoch, and renders:

- **flow0**: the background's affine flow, plus, where the background
  deforms, twice its bank slot's forward field at the moved position's
  half-resolution coordinates ``(m + W/2 + 0.5)/2 - 0.5``, where the moved
  position lies inside the 2W x 2H texture; over a deforming object's
  binary mask its affine flow plus the slot's forward field at the moved
  position, where that lies inside the frame. The forward field is read by
  the two-pass split of the affine (``sx = A x + B w + C`` on rows ``w``,
  then rows at ``v = c x + d y + f``), each tap clamped to the crop;
- **frame 1 of a deforming object**: its coverage and its affine-resampled
  texture, rounded to u8, form a layer over the whole plane; the layer is
  displaced by the slot's planes, a row pass at ``x + gdisp(w, x)`` on each
  layer row ``w`` (the texture rounded to u8 again after it), then a column
  pass at ``y + iflow_y(y, x)``; the displaced coverage is the blend mask
  (with antialiasing off, the displaced binary mask at 1 - 0.5/255 and
  above) and the displaced texture is blended in, ``round(f (1 - m) + t
  m)``. The planes off the crop read the big field around it;
- **frame 1 of a deforming background**: the background's frame 1 over
  the whole plane, rounded to u8, displaced the same way by twice the
  slot's planes x2-upscaled about the crop's centre, rounded.

Departures of the scene kernel from this content, which the comparison
leaves to the image limit (none moves ``flow0``): its windows bound the
displacement, an object's frame-1 tiles to 48 px beyond its box
(``compose/render.py:WARP_MARGIN``), the layer it displaces to 56 rows and
64 columns around a tile and inside the frame (``ops/scene.py:WARP_EY``,
``WARP_EX``), the background's to 96 rows and 128 columns around the frame
and 96 rows around a tile (``BG_EY``, ``BG_EX``); a read outside reads 0.
Its displacement reads see bands of 3 tiles (objects) and 4 (background)
of 128 lanes, and the forward field's two passes bands sized from the
mode's motion envelope. It computes a background tile's positions
relative to the window's origin, which rounds them in the last bit where
that origin is off the frame. Its textures are its two-pass resample,
which differs by a level here and there (``rigid``).

Refused: the ``"xla"`` bank stream, ``warp_oob="nan"``, inverse flow,
masks, the windowed renderer, and frames the scene kernel does not take.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import affine, photometric
from .render import (AA_MARGIN, _apply, _background, _bbox, _coverage,
                     _exact, _window, crop_transform, lower_precision,
                     sample_reflect)
from .scenes import MODES, map_scene, sample_scene
from .streams import root_key, sample_key
from .warpbank import Epoch, n_slots

IN_THR = float(np.float32(1.0 - 0.5 / 255.0))
SUPPORTED = {"mode", "width", "height", "use_antialiasing", "prefetch",
             "photometric_augment", "channel_order", "layout", "batch_size",
             "seed", "warp_fields_per_batch", "warp_bank_reuse_steps",
             "warp_bank_impl", "warp_oob", "render_impl",
             "compute_inverse_flow", "emit_masks"}
# A setting the reference takes only at one value.
ONLY = {"warp_bank_impl": "pallas", "warp_oob": "zero", "render_impl": "fused",
        "compute_inverse_flow": False, "emit_masks": False}


def check_supported(cfg: dict):
    """Raise for a configuration this reference does not restate."""
    extra = sorted(set(cfg) - SUPPORTED)
    if extra:
        raise ValueError(f"the reference does not render {extra}")
    for k, v in ONLY.items():
        if k in cfg and cfg[k] != v:
            raise ValueError(f"the reference renders {k}={v!r} only, "
                             f"not {cfg[k]!r}")
    H, W = int(cfg["height"]), int(cfg["width"])
    if H % 8 or W % 128:
        raise ValueError(f"{W}x{H} frames are not the scene kernel's "
                         "(multiples of (8, 128))")
    if MODES[int(cfg.get("mode", 1))].warp_p > 0.0:
        missing = {"warp_fields_per_batch", "warp_bank_reuse_steps"} - set(cfg)
        if missing:
            raise ValueError(f"a deforming mode needs {sorted(missing)} "
                             "stated")
        if (3 * max(W, H)) % 256:
            raise ValueError(f"the bank of {W}x{H} frames is not restated")


def _split(m):
    """Two-pass coefficients (A, B, C, c, d, f) of an affine (2, 3), in
    float32: ``B = b/d``, ``A = a - B c``, ``C = e - B f``."""
    a, b, e, c, d, f = (np.float32(v) for v in m.reshape(-1).tolist())
    B = b / d
    return tuple(float(v) for v in (a - B * c, B, e - B * f, c, d, f))


def field_at(plane, co, px, py, q=_exact):
    """A crop's plane (H, W) read at the two-pass split ``co`` of an affine
    at integer pixels ``px``, ``py``: rows ``w`` read at ``A x + B w + C``,
    then the rows ``floor(v)`` and the next at ``v = c x + d y + f``,
    every tap clamped to the plane."""
    H, W = plane.shape
    A, B, C, c, d, f = co
    v = torch.clamp(q(c * px + d * py + f), 0.0, H - 1.0)
    v0 = torch.floor(v)
    fy = v - v0

    def row(w):
        u = torch.clamp(q(A * px + B * w + C), 0.0, W - 1.0)
        u0 = torch.floor(u)
        t = u - u0
        i0 = u0.to(torch.int64)
        wi = w.to(torch.int64)
        p0, p1 = plane[wi, i0], plane[wi, torch.clamp(i0 + 1, max=W - 1)]
        return p0 + (p1 - p0) * t

    t0 = row(v0)
    t1 = row(torch.clamp(v0 + 1.0, max=H - 1.0))
    return q(t0 + (t1 - t0) * fy)


def _grid(rows, cols):
    py, px = torch.meshgrid(rows.to(torch.float32), cols.to(torch.float32),
                            indexing="ij")
    return px, py


def displace(vd, gd_at, layer_at, H, W, q=_exact):
    """The separable displacement of a layer onto the (H, W) frame.
    ``vd`` (H, W): the column pass's displacement; ``gd_at(rows)`` the row
    pass's (len(rows), W) on layer rows ``rows``; ``layer_at(rows, cols)``
    a dict of (len(rows), len(cols)) planes over those rows and columns,
    its keys ending in ``_u8`` rounded to u8 after the row pass. Returns
    the displaced planes by key."""
    dev = vd.device
    y = torch.arange(H, dtype=torch.float32, device=dev)[:, None]
    x = torch.arange(W, dtype=torch.float32, device=dev)[None, :]
    v = q(y + vd)
    r_lo, r_hi = math.floor(float(v.min())), math.floor(float(v.max())) + 1
    rows = torch.arange(r_lo, r_hi + 1, device=dev)
    u = q(x + gd_at(rows))
    c_lo, c_hi = math.floor(float(u.min())), math.floor(float(u.max())) + 1
    layer = layer_at(rows, torch.arange(c_lo, c_hi + 1, device=dev))
    u0 = torch.floor(u)
    fx = u - u0
    i0 = (u0 - c_lo).to(torch.int64)
    v0 = torch.floor(v)
    fy = v - v0
    j0 = (v0 - r_lo).to(torch.int64)
    out = {}
    for k, plane in layer.items():
        p0, p1 = torch.gather(plane, 1, i0), torch.gather(plane, 1, i0 + 1)
        tmp = q(p0 + (p1 - p0) * fx)
        if k.endswith("_u8"):
            tmp = torch.round(tmp)
        r0, r1 = torch.gather(tmp, 0, j0), torch.gather(tmp, 0, j0 + 1)
        out[k] = q(r0 + (r1 - r0) * fy)
    return out


def _rgb(planes):
    return torch.stack([planes[f"{c}_u8"] for c in "rgb"], -1)


def _as_layer(rgb, **more):
    out = {f"{c}_u8": rgb[..., i] for i, c in enumerate("rgb")}
    out.update(more)
    return out


def _warped_background(bg, tex, H, W, epoch, q):
    """Frame 1 (H, W, 3) of a deforming background: its plain frame 1 over
    the plane, displaced by its slot's x2-upscaled planes, rounded."""
    SH, SW = tex.shape[:2]
    dev = tex.device
    slot = int(bg.warp_slot)
    crop_t = crop_transform(SH, SW, 2 * H, 2 * W, bg.tex_rot_deg,
                            bg.tex_zoom, bg.tex_shift[0], bg.tex_shift[1])
    big_inv = affine.invert(affine.conjugate_about(bg.motion, float(W),
                                                   float(H)))

    def layer(rows, cols):
        px, py = _grid(rows, cols)
        bx, by = _apply(big_inv, px + W / 2.0, py + H / 2.0)
        sx, sy = _apply(crop_t, q(bx), q(by))
        return _as_layer(torch.round(q(sample_reflect(tex, 0, 0, SH, SW,
                                                      q(sx), q(sy)))))

    frame_rows = torch.arange(H, device=dev)
    vd = epoch.bg_planes(slot, frame_rows)[1]
    warped = displace(vd, lambda rows: epoch.bg_planes(slot, rows)[0], layer,
                      H, W, q)
    return torch.round(q(_rgb(warped)))


def _bg_forward_flow(bg, H, W, epoch, q):
    """Twice the slot's forward field at the background's moved positions'
    half-resolution coordinates, zero where they leave the 2W x 2H texture:
    (H, W, 2)."""
    dev = bg.motion.device
    px, py = _grid(torch.arange(H, device=dev), torch.arange(W, device=dev))
    pix = affine.conjugate_about(bg.motion, W / 2.0, H / 2.0)
    half = torch.tensor([W / 2.0, H / 2.0], dtype=torch.float32, device=dev)
    faff = torch.cat([pix[:, :2] * 0.5,
                      ((pix[:, 2] + half + 0.5) * 0.5 - 0.5)[:, None]], -1)
    co = _split(faff)
    planes = epoch.obj_planes(int(bg.warp_slot))
    mx, my = _apply(pix, px, py)
    mx, my = mx + W / 2.0, my + H / 2.0
    inb = (mx >= 0) & (mx < 2.0 * W) & (my >= 0) & (my < 2.0 * H)
    wf = torch.stack([field_at(planes[2 + ch], co, px, py, q)
                      for ch in (0, 1)], -1)
    return torch.where(inb[..., None], 2.0 * wf, torch.zeros_like(wf))


def _box_window(box):
    """The integer window (y0, y1, x0, x1) of a bbox plus the feather, not
    clipped to the frame."""
    return (math.floor(box[1] - AA_MARGIN), math.ceil(box[3] + AA_MARGIN) + 1,
            math.floor(box[0] - AA_MARGIN), math.ceil(box[2] + AA_MARGIN) + 1)


def _warped_object(prims, k, tr1, motion_inv, tex, cy0, cx0, H, W, use_aa,
                   slot, epoch, q):
    """Frame 1 of deforming object ``k``: the displaced blend mask (H, W)
    and texture (H, W, 3), or None where it has no valid primitive."""
    box = _bbox(prims, k, tr1)
    if box is None:
        return None
    by0, by1, bx0, bx1 = _box_window(box)

    def layer(rows, cols):
        px, py = _grid(rows, cols)
        sx, sy = _apply(motion_inv, px, py)
        texels = torch.round(q(sample_reflect(tex, cy0, cx0, H, W, q(sx),
                                              q(sy))))
        aa = torch.zeros_like(px)
        inside = torch.zeros_like(px)
        r0, r1 = max(by0, int(rows[0])), min(by1, int(rows[-1]) + 1)
        c0, c1 = max(bx0, int(cols[0])), min(bx1, int(cols[-1]) + 1)
        if r0 < r1 and c0 < c1:
            ry = slice(r0 - int(rows[0]), r1 - int(rows[0]))
            cx = slice(c0 - int(cols[0]), c1 - int(cols[0]))
            a, i = _coverage(prims, k, tr1, px[ry, cx] + 0.5, py[ry, cx] + 0.5)
            aa[ry, cx] = q(a)
            inside[ry, cx] = i.to(torch.float32)
        return _as_layer(texels, aa=aa, inside=inside)

    planes = epoch.obj_planes(slot)
    warped = displace(planes[1], lambda rows: epoch.obj_planes(slot, rows)[0],
                      layer, H, W, q)
    if use_aa:
        m = warped["aa"]
    else:
        m = (warped["inside"] >= IN_THR).to(torch.float32)
    return m, _rgb(warped)


def render_scene(scene, atlas, H, W, use_aa=True, lowp=False, epoch=None):
    """Render sample 0 of ``scene`` (leaves with a batch axis of one) with
    the deformations of bank ``epoch`` (None: nothing deforms):
    (image0, image1, flow0) as ``render.render_scene`` lays them out."""
    q = lower_precision if lowp else _exact
    T, SH, SW = atlas.shape[:3]
    bg = type(scene.background)(*(t[0] for t in scene.background))
    objs = type(scene.objects)(*(t[0] for t in scene.objects))
    prims = type(scene.prims)(*(t[0] for t in scene.prims))
    bg_tex = atlas[int(bg.tex_id) % T]
    frame0, frame1, flow0 = _background(bg, bg_tex, H, W, q)
    if epoch is not None and bool(bg.warp):
        frame1 = _warped_background(bg, bg_tex, H, W, epoch, q)
        flow0 = q(flow0 + _bg_forward_flow(bg, H, W, epoch, q))
    cy0, cx0 = (SH - H) // 2, (SW - W) // 2
    dev = atlas.device
    for k in range(objs.valid.shape[0]):
        if not bool(objs.valid[k]):
            continue
        tex = atlas[int(objs.tex_id[k]) % T]
        motion, motion_inv = objs.motion[k], objs.motion_inv[k]
        warps = epoch is not None and bool(objs.warp[k])
        slot = int(objs.warp_slot[k])
        tr0 = prims.intrinsic[k]
        tr1 = affine.compose(tr0, motion[None])
        win = _window(_bbox(prims, k, tr0), H, W)
        if win is not None:
            y0, y1, x0, x1 = win
            px, py = _grid(torch.arange(y0, y1, device=dev),
                           torch.arange(x0, x1, device=dev))
            aa, inside = _coverage(prims, k, tr0, px + 0.5, py + 0.5)
            m = q(aa if use_aa else inside.to(torch.float32))[..., None]
            texels = tex[cy0 + py.long(), cx0 + px.long()].to(torch.float32)
            frame0[y0:y1, x0:x1] = torch.round(
                q(frame0[y0:y1, x0:x1] * (1.0 - m) + texels * m))
            mx, my = _apply(motion, px, py)
            fl = q(torch.stack([mx - px, my - py], -1))
            if warps:
                inb = (mx >= 0) & (mx < W) & (my >= 0) & (my < H)
                co = _split(motion)
                planes = epoch.obj_planes(slot)
                wf = torch.stack([field_at(planes[2 + ch], co, px, py, q)
                                  for ch in (0, 1)], -1)
                fl = q(fl + torch.where(inb[..., None], wf,
                                        torch.zeros_like(wf)))
            flow0[y0:y1, x0:x1] = torch.where(inside[..., None], fl,
                                              flow0[y0:y1, x0:x1])
        if warps:
            got = _warped_object(prims, k, tr1, motion_inv, tex, cy0, cx0, H,
                                 W, use_aa, slot, epoch, q)
            if got is not None:
                m, texels = got
                frame1 = torch.round(q(frame1 * (1.0 - m[..., None])
                                       + texels * m[..., None]))
            continue
        win = _window(_bbox(prims, k, tr1), H, W)
        if win is None:
            continue
        y0, y1, x0, x1 = win
        px, py = _grid(torch.arange(y0, y1, device=dev),
                       torch.arange(x0, x1, device=dev))
        aa, inside = _coverage(prims, k, tr1, px + 0.5, py + 0.5)
        m = q(aa if use_aa else inside.to(torch.float32))[..., None]
        sx, sy = _apply(motion_inv, px, py)
        texels = sample_reflect(tex, cy0, cx0, H, W, q(sx), q(sy))
        frame1[y0:y1, x0:x1] = torch.round(
            q(frame1[y0:y1, x0:x1] * (1.0 - m) + q(texels) * m))
    return frame0, frame1, flow0


def render_rows(seed: int, indices, cfg: dict, atlas, lowp=False) -> dict:
    """The outputs of global sample indices ``indices`` of the stream of
    ``seed``, as ``rigid.render_rows`` returns them; each bank epoch the
    rows fall in is built once. ``lowp`` carries every per-pixel value, the
    bank's included, in bfloat16: the control."""
    check_supported(cfg)
    H, W = int(cfg["height"]), int(cfg["width"])
    dev = atlas.device
    spec = MODES[int(cfg["mode"])]
    warp = spec.warp_p > 0.0
    slots = n_slots(W, H, int(cfg["warp_fields_per_batch"])) if warp else 1
    root = root_key(seed, dev)
    idx = torch.as_tensor(list(indices), dtype=torch.int64, device=dev)
    scenes = sample_scene(sample_key(root, idx), spec, width=W, height=H,
                          n_warp_slots=slots)
    per = int(cfg["batch_size"]) * max(int(cfg.get("warp_bank_reuse_steps",
                                                   1)), 1)
    q = lower_precision if lowp else _exact
    rows = [None] * idx.shape[0]
    deforms = (scenes.background.warp
               | (scenes.objects.warp & scenes.objects.valid).any(-1)).tolist()
    for e in sorted({int(i) // per for i in idx.tolist()}):
        mine = [j for j, i in enumerate(idx.tolist()) if int(i) // per == e]
        need = warp and any(deforms[j] for j in mine)
        epoch = (Epoch(root, e, W, H, int(cfg["warp_fields_per_batch"]), q)
                 if need else None)
        for j in mine:
            one = map_scene(lambda t: t[j:j + 1], scenes)
            rows[j] = render_scene(one, atlas, H, W,
                                   bool(cfg.get("use_antialiasing", True)),
                                   lowp, epoch)
        del epoch
    i0, i1, f0 = (torch.stack(t) for t in zip(*rows))
    if cfg.get("photometric_augment", False):
        i0, i1 = photometric.augment_batch(root, idx, i0, i1)
    if cfg.get("channel_order", "rgb") == "bgr":
        i0, i1 = i0.flip(-1), i1.flip(-1)
    out = {"image0": i0, "image1": i1, "flow0": f0}
    if cfg.get("layout", "nhwc") == "nchw":
        out = {k: v.movedim(-1, 1) for k, v in out.items()}
    return out
