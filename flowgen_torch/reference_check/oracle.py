"""Scalar NumPy oracle renderer.

An independent re-implementation of the reference's *render semantics*
(src/caffe/DataGenerator.cpp: MovingObject rendering, RenderCore compositing,
flow synthesis) that follows the reference's literal order of operations —
materialize the 2Wx2H background texture, warp whole textures, rasterize masks,
blit in ascending-ID order, evaluate flow per pixel through getPointFlow —
instead of the TPU renderer's composed-affine / windowed formulation.

It consumes the same ``Scene`` blueprint pytree as the TPU renderer, so
agreement between the two validates the TPU path's algebraic restructurings
(background conjugation identity, windowing, quad gathers) against a direct
transcription of the semantics. Used by tests/test_oracle.py; NumPy-only, no
performance goals.
"""

from __future__ import annotations

import numpy as np


# ---------------------------------------------------------------------------
# Scalar helpers
# ---------------------------------------------------------------------------


def apply_affine(t, pts):
    """t: (2,3); pts: (N,2)."""
    return pts @ np.asarray(t)[:, :2].T + np.asarray(t)[:, 2]


def invert_affine(t):
    t = np.asarray(t)
    l = t[:, :2]
    li = np.linalg.inv(l)
    return np.concatenate([li, (-li @ t[:, 2])[:, None]], axis=1)


def compose_affine(a, b):
    """Apply a then b (AGG postfix order)."""
    a, b = np.asarray(a), np.asarray(b)
    l = b[:, :2] @ a[:, :2]
    t = b[:, :2] @ a[:, 2] + b[:, 2]
    return np.concatenate([l, t[:, None]], axis=1)


def reflect_index(i, n):
    period = 2 * n
    i = np.remainder(i, period)
    return np.where(i >= n, period - 1 - i, i)


def bilinear(img, x, y, wrap="reflect"):
    h, w = img.shape[:2]
    x0 = np.floor(x).astype(np.int64)
    y0 = np.floor(y).astype(np.int64)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]

    def wi(i, n):
        if wrap == "reflect":
            return reflect_index(i, n)
        return np.clip(i, 0, n - 1)

    v00 = img[wi(y0, h), wi(x0, w)]
    v01 = img[wi(y0, h), wi(x0 + 1, w)]
    v10 = img[wi(y0 + 1, h), wi(x0, w)]
    v11 = img[wi(y0 + 1, h), wi(x0 + 1, w)]
    out = (v00 * (1 - fx) + v01 * fx) * (1 - fy) + (v10 * (1 - fx) + v11 * fx) * fy
    if wrap == "zero":
        ok = (x >= 0) & (x <= w - 1) & (y >= 0) & (y <= h - 1)
        out = np.where(ok[..., None], out, 0.0)
    return out


def polygon_inside(pts, px, py):
    """Nonzero-winding inside test at sample points (AGG default fill rule)."""
    wn = np.zeros(px.shape, np.int64)
    n = len(pts)
    for i in range(n):
        a = pts[i]
        b = pts[(i + 1) % n]
        d = b - a
        cross = d[0] * (py - a[1]) - d[1] * (px - a[0])
        wn += ((a[1] <= py) & (b[1] > py) & (cross > 0)).astype(np.int64)
        wn -= ((b[1] <= py) & (a[1] > py) & (cross < 0)).astype(np.int64)
    return wn != 0


def polygon_aa(pts, px, py):
    """Exact-area AA coverage + >=50%-area binary mask — AGG's scanline_u8
    accumulation with gamma_none (AA) / gamma_threshold(0.5) (binary),
    MovingObjectBase::draw cpp:351-368. Per edge, Green's theorem with the
    edge clipped to each unit cell's row slab; cells are centered at (px, py).
    """
    area = np.zeros(px.shape)
    n = len(pts)
    xlo = px - 0.5
    ylo = py - 0.5
    for i in range(n):
        a = pts[i]
        b = pts[(i + 1) % n]
        dx = float(b[0] - a[0])
        dy = float(b[1] - a[1])
        inv_dy = 1.0 / dy if abs(dy) > 1e-12 else 0.0
        inv_dx = 1.0 / dx if abs(dx) > 1e-12 else 0.0
        r0 = (ylo - a[1]) * inv_dy
        r1 = (ylo + 1.0 - a[1]) * inv_dy
        ta = np.clip(np.minimum(r0, r1), 0.0, 1.0)
        tb = np.clip(np.maximum(r0, r1), 0.0, 1.0)
        s0 = (xlo - a[0]) * inv_dx
        s1 = (xlo + 1.0 - a[0]) * inv_dx
        p = np.clip(np.minimum(s0, s1), ta, tb)
        q = np.clip(np.maximum(s0, s1), ta, tb)

        def g(t):
            return np.clip(a[0] + t * dx - xlo, 0.0, 1.0)

        integral = (
            g(ta) * (p - ta) + 0.5 * (g(p) + g(q)) * (q - p) + g(tb) * (tb - q)
        )
        area += dy * integral
    area = np.abs(area)
    return np.clip(area, 0.0, 1.0), area >= 0.5


def ellipse_polygon(rx, ry, steps=100):
    """agg::ellipse flattening; the reference uses 100 steps (cpp:1080)."""
    ang = np.linspace(0, 2 * np.pi, steps, endpoint=False)
    return np.stack([rx * np.cos(ang), ry * np.sin(ang)], -1)


# ---------------------------------------------------------------------------
# Reference-order rendering
# ---------------------------------------------------------------------------


def randomized_crop(src, out_h, out_w, angle_deg, zoom, sx, sy):
    """Literal shift -> rotate -> crop -> resize chain of
    Texture::getRandomizedCrop (cpp:87-109), each stage materialized,
    including the small-source whole-image-resize fallback (cpp:104-108)."""
    h, w = src.shape[:2]
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    # shift by (sx, sy) (content moves +s => source coord -s), mirror boundary
    shifted = bilinear(src, xx - sx, yy - sy, wrap="reflect")
    # rotate about center by angle_deg degrees
    a = np.deg2rad(angle_deg)
    cx, cy = w / 2.0, h / 2.0
    rx = np.cos(a) * (xx - cx) - np.sin(a) * (yy - cy) + cx
    ry = np.sin(a) * (xx - cx) + np.cos(a) * (yy - cy) + cy
    rotated = bilinear(shifted, rx, ry, wrap="reflect")
    oy, ox = np.mgrid[0:out_h, 0:out_w].astype(np.float64)
    if not (w >= out_w and h >= out_h):
        # Fallback: resize the whole rotated image to (out_w, out_h).
        u = (ox + 0.5) * w / out_w - 0.5
        v = (oy + 0.5) * h / out_h - 0.5
        return bilinear(rotated, u, v, wrap="reflect")
    # crop box anchored at centered start, size out/zoom (cpp:99-102)
    bx0 = w / 2.0 - out_w / 2.0
    by0 = h / 2.0 - out_h / 2.0
    bw = out_w / zoom
    bh = out_h / zoom
    u = bx0 + (ox + 0.5) * bw / out_w - 0.5
    v = by0 + (oy + 0.5) * bh / out_h - 0.5
    return bilinear(rotated, u, v, wrap="reflect")


def warp_by_field(img, field, channels=True):
    """applyWarpFieldToTexture (cpp:237-252): out(x,y) = img(x + f.x, y + f.y)
    bilinearly, zero outside. NaN field entries (flagged out-of-bounds warp
    pixels) sample as zero displacement."""
    h, w = img.shape[:2]
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    fx = np.nan_to_num(field[..., 0])
    fy = np.nan_to_num(field[..., 1])
    a = img if channels else img[..., None]
    out = bilinear(a, xx + fx, yy + fy, wrap="zero")
    return out if channels else out[..., 0]


def _upscale2_field(field, out_h, out_w, scrub=True):
    """The MODE-9 background field: the WxH crop resized x2 with magnitudes
    x2 (cpp:1194-1202). Sampling convention matches the TPU renderer's
    implicit form (value at big coord q = 2*field((q+0.5)/2 - 0.5)); CImg's
    literal resize convention is within half a source texel of this.
    ``scrub=False`` keeps flagged (NaN) pixels, which the resize then
    propagates — warp_oob="nan" semantics."""
    yy, xx = np.mgrid[0:out_h, 0:out_w].astype(np.float64)
    return 2.0 * bilinear(
        np.nan_to_num(field) if scrub else field,
        (xx + 0.5) / 2.0 - 0.5, (yy + 0.5) / 2.0 - 0.5,
        wrap="clamp",
    )


def render_scene_oracle(scene_np, atlas_np, width, height, use_aa=True,
                        warp_bank=None, obj_tex_np=None, return_ids=False,
                        compute_inverse=False, warp_oob="zero"):
    """Render one scene (numpy-converted Scene pytree, no batch dim) the
    reference way. Returns (image0, image1, flow0) float arrays; with
    ``compute_inverse`` also flow1 (the frame1->frame0 flow): ownership via
    the frame-1 index image and the inverse motion affine
    (computeFlowImage(inverse=true), DataGenerator.cpp:801-818). The
    reference pipeline never computes flow1 (inverse=false only,
    cpp:1226) and its unexercised inverse branch would add the FORWARD
    warp field (cpp:403-405); the framework's contract — matched here —
    is the inverse affine masked by the displaced binary mask, with no
    field term (compose/render.py frame-1 branch).

    ``warp_bank``: optional dict {"flow": (N,H,W,2), "iflow": ...} numpy for
    MODE 9; nonrigid semantics follow the reference literally — frame-1 u8
    masks and the affine-warped texture are bilinearly resampled through the
    inverse field per COMPONENT (renderMasks cpp:370-386, applied before the
    composite algebra), and flow adds the forward field sampled at the moved
    position (getPointFlow cpp:388-407).

    ``atlas_np`` may be a LIST of native-resolution images (heterogeneous
    shapes — the crop chain then exercises per-source geometry including the
    small-source fallback); ``obj_tex_np`` optionally supplies materialized
    object textures (TextureDB.obj_tex) instead of the canonical center crop.
    """
    W, H = width, height
    bg = scene_np["background"]
    objs = scene_np["objects"]
    prims = scene_np["prims"]
    T = len(atlas_np)
    atlas_np = [np.asarray(a).astype(np.float64) for a in atlas_np]
    bg_warp = warp_bank is not None and bool(bg["warp"])

    # --- Background object (MovingObjectBackground, cpp:654-718) ---
    src = atlas_np[int(bg["tex_id"]) % T]
    big0 = randomized_crop(
        src, 2 * H, 2 * W, float(bg["tex_rot_deg"]), float(bg["tex_zoom"]),
        float(bg["tex_shift"][0]), float(bg["tex_shift"][1]),
    )
    # intrinsic = translate(W, H); warp big texture by intr^-1 * motion * intr
    intr = np.array([[1.0, 0, W], [0, 1, H]])
    m_total = compose_affine(compose_affine(invert_affine(intr), bg["motion"]), intr)
    m_inv = invert_affine(m_total)
    yy, xx = np.mgrid[0 : 2 * H, 0 : 2 * W].astype(np.float64)
    sx_c = m_inv[0, 0] * xx + m_inv[0, 1] * yy + m_inv[0, 2]
    sy_c = m_inv[1, 0] * xx + m_inv[1, 1] * yy + m_inv[1, 2]
    big1 = bilinear(big0, sx_c, sy_c, wrap="reflect")
    if bg_warp:
        slot = int(bg["warp_slot"])
        bgf_big = _upscale2_field(warp_bank["flow"][slot], 2 * H, 2 * W,
                                  scrub=(warp_oob != "nan"))
        bgi_big = _upscale2_field(warp_bank["iflow"][slot], 2 * H, 2 * W)
        # renderTransformedTexture then applyWarpFieldToTexture (cpp:341-346):
        # the affine-warped big texture is resampled through the inverse field.
        big1 = warp_by_field(big1, bgi_big)
    # center crop (cpp:680-681)
    frame0 = np.round(big0[H // 2 : H // 2 + H, W // 2 : W // 2 + W]).astype(np.float64)
    frame1 = np.round(big1[H // 2 : H // 2 + H, W // 2 : W // 2 + W]).astype(np.float64)

    # Background flow via getPointFlow's conjugation (cpp:692-712).
    iyy, ixx = np.mgrid[0:H, 0:W].astype(np.float64)
    qx = ixx + W / 2.0
    qy = iyy + H / 2.0
    px1 = m_total[0, 0] * qx + m_total[0, 1] * qy + m_total[0, 2]
    py1 = m_total[1, 0] * qx + m_total[1, 1] * qy + m_total[1, 2]
    flow = np.stack([px1 - qx, py1 - qy], -1)
    iflow = None
    if compute_inverse:
        ipx1 = m_inv[0, 0] * qx + m_inv[0, 1] * qy + m_inv[0, 2]
        ipy1 = m_inv[1, 0] * qx + m_inv[1, 1] * qy + m_inv[1, 2]
        iflow = np.stack([ipx1 - qx, ipy1 - qy], -1)
    if bg_warp:
        # Forward field at the moved position, in big coords, gated on
        # landing inside the 2Wx2H field (cpp:714-717).
        inb = (px1 >= 0) & (px1 < 2 * W) & (py1 >= 0) & (py1 < 2 * H)
        add = bilinear(bgf_big, px1, py1, wrap="zero")
        flow[..., 0] += np.where(inb, add[..., 0], 0.0)
        flow[..., 1] += np.where(inb, add[..., 1], 0.0)

    # --- Foreground objects, ascending id (cpp:1216-1226) ---
    K = objs["valid"].shape[0]
    cyy, cxx = iyy + 0.5, ixx + 0.5
    ids0 = np.ones((H, W), np.int32)   # background id 1 (layer cpp:202)
    ids1 = np.ones((H, W), np.int32)
    for k in range(K):
        if not objs["valid"][k]:
            continue
        motion = objs["motion"][k]
        k_warp = warp_bank is not None and bool(objs["warp"][k])
        if k_warp:
            slot = int(objs["warp_slot"][k])
            # warp_oob="nan": keep the reference's signaling NaNs in the
            # forward field; the flow sample below then poisons exactly the
            # pixels whose bilinear footprint touches a flagged field pixel.
            wf = warp_bank["flow"][slot].astype(np.float64)
            if warp_oob != "nan":
                wf = np.nan_to_num(wf)
            wi = np.nan_to_num(warp_bank["iflow"][slot]).astype(np.float64)
        tid = int(objs["tex_id"][k]) % T
        if obj_tex_np is not None:
            tex0 = np.asarray(obj_tex_np[tid]).astype(np.float64)
        else:
            tex0 = _center_crop(atlas_np[tid], H, W)
        # masks via component algebra; MODE 9 warps each component's frame-1
        # masks BEFORE combining (components run base renderMasks themselves,
        # cpp:370-386, before Composite::renderMasks merges them).
        aa0 = np.zeros((H, W))
        in0 = np.zeros((H, W), bool)
        aa1 = np.zeros((H, W))
        in1 = np.zeros((H, W), bool)
        for c in range(prims["valid"].shape[1]):
            if not prims["valid"][k, c]:
                continue
            intr_c = prims["intrinsic"][k, c]
            tr1 = compose_affine(intr_c, motion)
            if prims["is_poly"][k, c]:
                local = prims["edge_pts"][k, c]
            else:
                local = ellipse_polygon(
                    prims["ell_rx"][k, c], prims["ell_ry"][k, c]
                )
            c_aa0, c_in0 = polygon_aa(apply_affine(intr_c, local), cxx, cyy)
            c_aa1, c_in1 = polygon_aa(apply_affine(tr1, local), cxx, cyy)
            if k_warp:
                # u8-mask resampling through the inverse field; the binary
                # mask stays "fully covering" only where the interpolated
                # 0/255 mask remains 255 (blit tests ==255, cpp:765-773).
                c_aa1 = warp_by_field(c_aa1, wi, channels=False)
                c_in1 = (
                    warp_by_field(c_in1.astype(np.float64), wi, channels=False)
                    >= 1.0 - 0.5 / 255.0
                )
            if prims["additive"][k, c]:
                aa0 = 1 - (1 - aa0) * (1 - c_aa0)
                in0 = in0 | c_in0
                aa1 = 1 - (1 - aa1) * (1 - c_aa1)
                in1 = in1 | c_in1
            else:
                aa0 = aa0 * (1 - c_aa0)
                in0 = in0 & ~c_in0
                aa1 = aa1 * (1 - c_aa1)
                in1 = in1 & ~c_in1

        # frame-1 texture: backward warp of tex0 by the motion (cpp:337-348),
        # then through the inverse field for deforming objects (cpp:341-346).
        minv = invert_affine(motion)
        tx = minv[0, 0] * ixx + minv[0, 1] * iyy + minv[0, 2]
        ty = minv[1, 0] * ixx + minv[1, 1] * iyy + minv[1, 2]
        tex1 = bilinear(tex0, tx, ty, wrap="reflect")
        if k_warp:
            tex1 = warp_by_field(tex1, wi)

        m0 = aa0 if use_aa else in0.astype(np.float64)
        m1 = aa1 if use_aa else in1.astype(np.float64)
        frame0 = np.round(frame0 * (1 - m0[..., None]) + tex0 * m0[..., None])
        frame1 = np.round(frame1 * (1 - m1[..., None]) + tex1 * m1[..., None])

        # flow where frame-0 mask fully covers (cpp:762-818)
        ox = motion[0, 0] * ixx + motion[0, 1] * iyy + motion[0, 2] - ixx
        oy = motion[1, 0] * ixx + motion[1, 1] * iyy + motion[1, 2] - iyy
        if k_warp:
            # Extra field sampled at the moved position, inside the frame
            # (getPointFlow, cpp:398-406).
            mx, my = ox + ixx, oy + iyy
            inb = (mx >= 0) & (mx < W) & (my >= 0) & (my < H)
            add = bilinear(wf, mx, my, wrap="zero")
            ox = ox + np.where(inb, add[..., 0], 0.0)
            oy = oy + np.where(inb, add[..., 1], 0.0)
        flow[..., 0] = np.where(in0, ox, flow[..., 0])
        flow[..., 1] = np.where(in0, oy, flow[..., 1])
        if compute_inverse:
            iox = minv[0, 0] * ixx + minv[0, 1] * iyy + minv[0, 2] - ixx
            ioy = minv[1, 0] * ixx + minv[1, 1] * iyy + minv[1, 2] - iyy
            iflow[..., 0] = np.where(in1, iox, iflow[..., 0])
            iflow[..., 1] = np.where(in1, ioy, iflow[..., 1])
        ids0 = np.where(in0, 10 + k, ids0)   # fg ids 10+i (layer cpp:210)
        ids1 = np.where(in1, 10 + k, ids1)

    out = [frame0, frame1, flow]
    if compute_inverse:
        out.append(iflow)
    if return_ids:
        out += [ids0, ids1]
    return tuple(out)


def _center_crop(src, h, w):
    sh, sw = src.shape[:2]
    y0 = (sh - h) // 2
    x0 = (sw - w) // 2
    return src[y0 : y0 + h, x0 : x0 + w]


def scene_to_numpy(scene):
    """Convert one Scene pytree (no batch dim) into nested dicts of numpy."""
    return {
        "background": {f: np.asarray(getattr(scene.background, f))
                       for f in scene.background._fields},
        "objects": {f: np.asarray(getattr(scene.objects, f))
                    for f in scene.objects._fields},
        "prims": {f: np.asarray(getattr(scene.prims, f))
                  for f in scene.prims._fields},
        "n_objects": int(scene.n_objects),
    }
