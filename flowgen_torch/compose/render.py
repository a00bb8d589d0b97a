"""The windowed renderer (port of ``flowgen/compose/render.py``), and the
per-object screen geometry that the fused path shares with it.

The renderer takes frames the scene kernel cannot (any size, not only
multiples of (8, 128)) and the settings that ask for it. Per sample: the
background's two frames and flow planes (``background_pass``); then every
on-screen object in painter's order evaluates coverage, blend and flow on a
window around its bounding box, of one of two static classes (192 x 256 or
the full frame). Outside the window the object contributes nothing, so the
result equals full-frame evaluation bit for bit.

The JAX package renders one sample at a time (``lax.map``) and walks its
objects in a ``fori_loop``. Here a batch is rendered by painter rank: rank r
is the r-th entry of each sample's compacted order, and the windows of one
rank lie in different samples, so one batched step per (rank, frame) keeps
painter's order per pixel. Each window carries its own origin, class and
tables. Non-deforming objects take ``ops/window.py:object_window`` (the CUDA
kernel on the card); deforming objects in mode 9, every object under
``emit_masks`` and ``use_pallas="never"`` take the composed branch, plain
tensor code as XLA in the JAX package, with ``ops/window.py:
polygon_coverage`` for polygons where the kernels are enabled. Which sample
takes which branch and window class is read to the host once per batch
(one device-to-host copy of a small table) to plan the batched steps.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from .._fp import f32, sqrt
from ..config import BACKGROUND_OBJ_ID, FOREGROUND_ID_BASE, DataGenConfig
from ..ops import affine, raster, window
from ..ops import texture as tex_mod
from ..params.blueprint import map_scene
from ..utils.profiling import span

# Static window classes for per-object evaluation: (height, width); ``None``
# is the full frame.
WINDOW_CLASSES = ((192, 256), None)
AA_MARGIN = 2.0          # AA feather reaches 0.5 px outside the outline
WARP_MARGIN = 48.0       # max |iflow| of composed warp fields (~40 px)
WARP_BINARY_THR = f32(1.0 - 0.5 / 255.0)


def _pallas_enabled(cfg: DataGenConfig, device) -> bool:
    """Whether the window kernels run: ``use_pallas="auto"`` means the
    kernels on a CUDA device and the plain composed branch on the CPU (as
    the JAX package keys its Pallas kernels off the backend); "always" runs
    the kernels' plain versions on the CPU."""
    if cfg.use_pallas == "always":
        return True
    if cfg.use_pallas == "never":
        return False
    return torch.device(device).type == "cuda"


class WarpBank(NamedTuple):
    """Bank of nonrigid deformation crops for mode 9: flow and iflow
    (N, H, W, 2), the JAX package's layout."""

    flow: torch.Tensor
    iflow: torch.Tensor


class RenderOutput(NamedTuple):
    """One rendered sample, the JAX package's field order: images (H, W, 3)
    float32 in [0, 255], flows (H, W, 2) in pixels, ``flow1`` under
    ``compute_inverse_flow`` and ``ids`` (2, H, W) int32 under
    ``emit_masks``, else None."""

    image0: torch.Tensor
    image1: torch.Tensor
    flow0: torch.Tensor
    flow1: Optional[torch.Tensor]
    ids: Optional[torch.Tensor] = None


class WarpAux(NamedTuple):
    """The scene kernel's warp planes of a bank epoch: ``obj`` and ``bg`` are
    the JAX package's ``(obj_aux, bg_aux)``; ``bg_band`` (N, n_bg_tiles,
    tile_w / 128) int32 holds the first source tile of each block's pass-1
    band in the background warp, which depends only on ``bg`` and so is
    derived once per epoch (``ops/scene.py:bg_band_starts``)."""

    obj: torch.Tensor
    bg: torch.Tensor
    bg_band: torch.Tensor


def _all_bboxes(prims, motions):
    """Union screen bboxes of every object's valid primitives for both
    frames, over all [..., K, C] slots. Exact for polygons (min/max of the
    transformed outline) and ellipses (affine ellipse extents).

    Returns ((lo0, hi0), (lo1, hi1)) with [..., K, 2] leaves (x, y)."""
    intr = prims.intrinsic                                  # [...,K,C,2,3]
    tr1 = affine.compose(intr, motions[..., None, :, :])

    def bbox(tr):
        pts = affine.apply(tr, prims.edge_pts)              # [...,K,C,E,2]
        pmin = pts.amin(dim=-2)
        pmax = pts.amax(dim=-2)
        center = tr[..., 2]
        lin = tr[..., :2]
        ex = lin[..., 0] * prims.ell_rx[..., None]
        ey = lin[..., 1] * prims.ell_ry[..., None]
        ext = sqrt(ex * ex + ey * ey)
        is_poly = prims.is_poly[..., None]
        lo = torch.where(is_poly, pmin, center - ext)
        hi = torch.where(is_poly, pmax, center + ext)
        valid = prims.valid[..., None]
        lo = torch.where(valid, lo, torch.full_like(lo, 1e9))
        hi = torch.where(valid, hi, torch.full_like(hi, -1e9))
        return lo.amin(dim=-2), hi.amax(dim=-2)

    return bbox(intr.expand(tr1.shape)), bbox(tr1)


def _offscreen(lo, hi, margin, H, W):
    """Bbox (+margin) misses the frame entirely. ``margin`` may be a Python
    number or a tensor broadcastable to [..., K]."""
    return (
        (hi[..., 0] < -margin)
        | (lo[..., 0] > W + margin)
        | (hi[..., 1] < -margin)
        | (lo[..., 1] > H + margin)
    )


# ---------------------------------------------------------------------------
# The windowed renderer
# ---------------------------------------------------------------------------


def prepare_atlas(atlas):
    """Pack a (T, SH, SW, 3) texture atlas into quad gather tables (T, SH,
    SW, 12) uint8 (``ops/texture.py:make_quad``)."""
    if atlas.dtype != torch.uint8:
        atlas = torch.clamp(torch.round(atlas.to(torch.float32)), 0, 255).to(
            torch.uint8)
    return tex_mod.make_quad(atlas).contiguous()


def _apply(m, x, y):
    """``affine.apply_xy`` with one (2, 3) transform per sample: ``m`` (n, 2,
    3) against coordinates (n or 1, ...)."""
    lead = (-1,) + (1,) * (x.dim() - 1)
    c = [[m[:, r, k].reshape(lead) for k in range(3)] for r in range(2)]
    return (c[0][0] * x + c[0][1] * y + c[0][2],
            c[1][0] * x + c[1][1] * y + c[1][2])


def _bilinear_flow_at(field, slots, x, y):
    """Sample bank crops ``field`` (N, H, W, 2) at float coords (n, ...), crop
    ``slots`` (n,) per sample, zero outside and NaN scrubbed before the
    lerp. Returns the two components."""
    N, h, w = field.shape[:3]
    v = tex_mod.sample_bilinear_flat(
        field.reshape(-1, 2), slots.to(torch.int64).reshape(
            (-1,) + (1,) * (x.dim() - 1)) * (h * w), h, w, x, y, wrap="zero",
        scrub_nan=True)
    return v[..., 0], v[..., 1]


def _size_classes(lo, hi, margin, classes):
    """Smallest window class whose size fits bbox + margin, per object;
    ``classes`` ends with ``None`` = full frame."""
    w = hi[..., 0] - lo[..., 0] + 2 * margin
    h = hi[..., 1] - lo[..., 1] + 2 * margin
    cls = torch.full(w.shape, len(classes) - 1, dtype=torch.int32,
                     device=w.device)
    for i in reversed(range(len(classes) - 1)):
        wh, ww = classes[i]
        cls = torch.where((w <= ww) & (h <= wh), torch.full_like(cls, i), cls)
    return cls


def _window_origin(bmin, bmax, wh, ww, H, W):
    """Window origin (y0, x0) centred on the bbox, rounded half to even and
    clipped into the frame."""
    cx = (bmin[..., 0] + bmax[..., 0]) * 0.5
    cy = (bmin[..., 1] + bmax[..., 1]) * 0.5
    x0 = torch.clamp(torch.round(cx - ww / 2.0).to(torch.int32), 0, W - ww)
    y0 = torch.clamp(torch.round(cy - wh / 2.0).to(torch.int32), 0, H - wh)
    return y0, x0


def background_pass(scenes, atlas_q, cfg: DataGenConfig, warp_bank=None):
    """Background frames and initial flow planes of a batch. ``atlas_q`` is
    quad-packed (T, SH, SW, 12). Returns (frame0, frame1) (B, H, W, 3),
    flow0 (B, H, W, 2) and flow1 (B, H, W, 2) or None."""
    with span("flowgen.background_pass"):
        H, W = cfg.height, cfg.width
        T, SH, SW = atlas_q.shape[:3]
        bg = scenes.background
        B = bg.motion.shape[0]
        dev = atlas_q.device
        has_warp = warp_bank is not None and cfg.mode_spec.warp_p > 0.0
        ix, iy = raster.pixel_grid(W, H, 0.0, device=dev)
        cx, cy = W / 2.0, H / 2.0
        flat = atlas_q.reshape(-1, 12)
        base = ((bg.tex_id % T).to(torch.int64) * (SH * SW)).reshape(B, 1, 1)

        def bg_sample(x, y):
            return tex_mod.sample_bilinear_quad_flat(flat, base, SH, SW, x, y,
                                                     wrap="reflect")

        crop_t = tex_mod.randomized_crop_transform(
            SH, SW, 2 * H, 2 * W, bg.tex_rot_deg, bg.tex_zoom,
            bg.tex_shift[:, 0], bg.tex_shift[:, 1])
        bg_pixel_motion = affine.conjugate_about(bg.motion, cx, cy)
        bg_big_inv = affine.invert(
            affine.conjugate_about(bg.motion, float(W), float(H)))
        qx, qy = ix + cx, iy + cy
        s0x, s0y = _apply(crop_t, qx[None], qy[None])
        frame0 = bg_sample(s0x, s0y)

        def big_field_at(field, x, y):
            # The background field is the crop resized x2 with magnitudes x2:
            # its value at big coord q is 2 * field((q + 0.5)/2 - 0.5).
            fx, fy = _bilinear_flow_at(field, bg.warp_slot,
                                       (x + 0.5) / 2.0 - 0.5,
                                       (y + 0.5) / 2.0 - 0.5)
            return 2.0 * fx, 2.0 * fy

        warp = bg.warp.reshape(B, 1, 1) if has_warp else None
        if has_warp:
            idx, idy = big_field_at(warp_bank.iflow, qx.expand(B, H, W),
                                    qy.expand(B, H, W))
            wq_x = torch.where(warp, qx + idx, qx)
            wq_y = torch.where(warp, qy + idy, qy)
        else:
            wq_x, wq_y = qx[None], qy[None]
        bx, by = _apply(bg_big_inv, wq_x, wq_y)
        s1x, s1y = _apply(crop_t, bx, by)
        frame1 = bg_sample(s1x, s1y)

        fqx, fqy = _apply(bg_pixel_motion, ix[None], iy[None])
        flow_x = fqx - ix
        flow_y = fqy - iy
        if has_warp:
            mx, my = fqx + cx, fqy + cy
            wfx, wfy = big_field_at(warp_bank.flow, mx, my)
            inb = warp & (mx >= 0) & (mx < 2 * W) & (my >= 0) & (my < 2 * H)
            flow_x = flow_x + torch.where(inb, wfx, torch.zeros_like(wfx))
            flow_y = flow_y + torch.where(inb, wfy, torch.zeros_like(wfy))
        flow0 = torch.stack([flow_x, flow_y], -1).contiguous()
        flow1 = None
        if cfg.compute_inverse_flow:
            iqx, iqy = _apply(affine.invert(bg_pixel_motion), ix[None],
                              iy[None])
            flow1 = torch.stack([iqx - ix, iqy - iy], -1).contiguous()
        return (torch.round(frame0).contiguous(),
                torch.round(frame1).contiguous(), flow0, flow1)


def background_flow(scene, cfg: DataGenConfig):
    """The background's affine flow planes of one scene (leaves without the
    batch axis), without the frames: ``(flow_x, flow_y, iflow_x,
    iflow_y)``, each (H, W), the inverse pair zero unless
    ``compute_inverse_flow``. The scene kernel evaluates the same
    expressions in its flow init from the pixel motion (``apply_xy_det``,
    each product rounded on its own)."""
    H, W = cfg.height, cfg.width
    ix, iy = raster.pixel_grid(W, H, 0.0, device=scene.background.motion.device)
    m = affine.conjugate_about(scene.background.motion, W / 2.0, H / 2.0)
    fqx, fqy = affine.apply_xy_det(m, ix, iy)
    flow_x, flow_y = fqx - ix, fqy - iy
    if cfg.compute_inverse_flow:
        iqx, iqy = affine.apply_xy_det(affine.invert(m), ix, iy)
        return flow_x, flow_y, iqx - ix, iqy - iy
    z = torch.zeros_like(flow_x)
    return flow_x, flow_y, z, z


def _object_kernel_inputs(prims, motion, flow_motion, frame, n_prims, x0, y0):
    """The window kernel's tables for one object per sample (``prims`` the
    objects' primitive rows, (n, C, ...)): edges (n, 4, C*E), meta (n, 3 +
    3C) int32, fmeta (n, 6 + 8C)."""
    intr = prims.intrinsic
    tr = intr if frame == 0 else affine.compose(intr, motion[:, None])
    pts = affine.apply(tr, prims.edge_pts)                  # (n,C,E,2)
    b = torch.roll(pts, -1, dims=2)
    n, C, E = pts.shape[:3]
    edges = torch.stack([pts[..., 0], pts[..., 1], b[..., 0], b[..., 1]],
                        dim=1).reshape(n, 4, C * E)
    meta = torch.cat([
        torch.stack([n_prims, x0, y0], -1).to(torch.int32),
        prims.additive.to(torch.int32), prims.is_poly.to(torch.int32),
        prims.n_edges.to(torch.int32)], dim=-1)
    inv = affine.invert(tr)
    ell = torch.cat([inv.reshape(n, C, 6), prims.ell_rx[..., None],
                     prims.ell_ry[..., None]], dim=-1).reshape(n, C * 8)
    fmeta = torch.cat([flow_motion.reshape(n, 6), ell], dim=-1)
    return (edges.contiguous(), meta.contiguous(),
            fmeta.to(torch.float32).contiguous())


def _frame_coverage(prims, tr_all, cx, cy, plan_c, use_pallas):
    """Composite coverage (aa, inside) of one object per sample over window
    grids (n, wh, ww), primitive slots in order: ``tr_all`` (n, C, 2, 3)
    the slots' screen transforms; ``plan_c`` per slot (live (n,) bool,
    polygon sample rows, ellipse sample rows)."""
    aa_acc = torch.zeros_like(cx)
    in_acc = torch.zeros(cx.shape, dtype=torch.bool, device=cx.device)
    for c, (live, polys, ells) in enumerate(plan_c):
        aa = torch.zeros_like(cx)
        inside = torch.zeros_like(in_acc)
        tr = tr_all[:, c]
        if polys is not None:
            pts = affine.apply(tr[polys], prims.edge_pts[polys, c])
            if use_pallas:
                a, i = window.polygon_coverage(pts, prims.n_edges[polys, c],
                                               cx[polys], cy[polys])
            else:
                a, i = raster.polygon_coverage(pts, cx[polys], cy[polys])
            aa[polys], inside[polys] = a, i
        if ells is not None:
            a, i = raster.ellipse_coverage(tr[ells], prims.ell_rx[ells, c],
                                           prims.ell_ry[ells, c], cx[ells],
                                           cy[ells])
            aa[ells], inside[ells] = a, i
        additive = prims.additive[:, c].reshape(-1, 1, 1)
        a_aa, a_in = raster.combine_additive(aa_acc, in_acc, aa, inside)
        s_aa, s_in = raster.combine_subtractive(aa_acc, in_acc, aa, inside)
        live = live.reshape(-1, 1, 1)
        aa_acc = torch.where(live, torch.where(additive, a_aa, s_aa), aa_acc)
        in_acc = torch.where(live, torch.where(additive, a_in, s_in), in_acc)
    return aa_acc, in_acc


class _Plan:
    """The batch's window steps, planned on the host from one read of a
    small per-(sample, rank, frame) table. All selections live in one index
    tensor on the device; each step holds slices of it."""

    def __init__(self, table, count, dev):
        self.steps = []
        chunks = []
        used = 0

        def put(rows):
            nonlocal used
            rows = np.asarray(rows, np.int64)
            chunks.append(rows)
            used += len(rows)
            return (used - len(rows), used)

        B = table.shape[0]
        for r in range(int(count.max()) if B else 0):
            for fr in (0, 1):
                t = table[:, r, fr]
                on = (t[:, 0] != 0) & (r < count)
                fused = np.nonzero(on & (t[:, 2] == 0))[0]
                if len(fused):
                    self.steps.append(("fused", r, fr, put(fused),
                                       int(t[fused, 1].max())))
                comp = np.nonzero(on & (t[:, 2] != 0))[0]
                for cls in sorted(set(t[comp, 1].tolist())):
                    rows = comp[t[comp, 1] == cls]
                    nps, bits = t[rows, 3], t[rows, 4]
                    per_c = []
                    for c in range(int(nps.max())):
                        live = nps > c
                        poly = live & ((bits >> c) & 1 != 0)
                        ell = live & ((bits >> c) & 1 == 0)
                        per_c.append((
                            put(live.astype(np.int64)),
                            put(np.nonzero(poly)[0]) if poly.any() else None,
                            put(np.nonzero(ell)[0]) if ell.any() else None))
                    self.steps.append(("composed", r, fr, put(rows), cls,
                                       per_c))
        self.index = torch.from_numpy(
            np.concatenate(chunks) if chunks else np.zeros(0, np.int64)).to(dev)

    def rows(self, span):
        return None if span is None else self.index[span[0]:span[1]]


def render_batch(scenes, atlas_q, cfg: DataGenConfig, warp_bank=None):
    """Render a batch of scenes: (image0, image1, flow0[, flow1][, ids]) with
    images (B, H, W, 3) float32 in [0, 255], flows (B, H, W, 2) and the id
    images (B, 2, H, W) int32 under ``emit_masks``. ``atlas_q`` is the
    quad-packed atlas of :func:`prepare_atlas`; mode 9 passes the crop bank
    (``warpfields/generator.py:make_warp_bank``)."""
    H, W = cfg.height, cfg.width
    T, SH, SW = atlas_q.shape[:3]
    dev = atlas_q.device
    use_pallas = _pallas_enabled(cfg, dev)
    has_warp = warp_bank is not None and cfg.mode_spec.warp_p > 0.0
    emit_ids = cfg.emit_masks
    # The window kernel carries no id plane: with emit_masks every object
    # takes the composed branch, which writes the painter's index images.
    use_kernel = use_pallas and not emit_ids

    frame0, frame1, flow0, flow1 = background_pass(scenes, atlas_q, cfg,
                                                   warp_bank)
    with span("flowgen.objects"):
        B = frame0.shape[0]
        ids = (torch.full((B, 2, H, W), BACKGROUND_OBJ_ID, dtype=torch.int32,
                          device=dev) if emit_ids else None)
        classes = tuple(
            c for c in (WINDOW_CLASSES if cfg.windowed else (None,))
            if c is None or (c[0] <= H and c[1] <= W))
        sizes = [c if c is not None else (H, W) for c in classes]

        prims, objs = scenes.prims, scenes.objects
        (lo0, hi0), (lo1, hi1) = _all_bboxes(prims, objs.motion)
        n_prims = prims.valid.sum(-1).to(torch.int32)
        warping = (objs.warp & objs.valid) if has_warp else torch.zeros_like(
            objs.valid)
        margin1 = AA_MARGIN + torch.where(warping, WARP_MARGIN, 0.0)
        on0 = objs.valid & ~_offscreen(lo0, hi0, AA_MARGIN, H, W)
        on1 = objs.valid & ~_offscreen(lo1, hi1, margin1, H, W)
        cls0 = _size_classes(lo0, hi0, AA_MARGIN, classes)
        cls1 = _size_classes(lo1, hi1, margin1, classes)
        process = on0 | on1
        # Compacted painter's order: on-screen objects first, ascending id.
        order = torch.argsort((~process).to(torch.int8), dim=-1, stable=True)
        count = process.sum(-1)

        def origin(lo, hi, cls):
            y0 = torch.zeros_like(cls)
            x0 = torch.zeros_like(cls)
            for i, (wh, ww) in enumerate(sizes):
                if (wh, ww) == (H, W):
                    continue
                yy, xx = _window_origin(lo, hi, wh, ww, H, W)
                y0 = torch.where(cls == i, yy, y0)
                x0 = torch.where(cls == i, xx, x0)
            return y0, x0

        org = (origin(lo0, hi0, cls0), origin(lo1, hi1, cls1))
        composed = warping if use_kernel else torch.ones_like(warping)
        shifts = torch.arange(prims.valid.shape[-1], device=dev)
        poly_bits = (prims.is_poly.to(torch.int32) << shifts).sum(-1)
        per_frame = [torch.stack([on.to(torch.int32), cls,
                                  composed.to(torch.int32), n_prims,
                                  poly_bits], -1)
                     for on, cls in ((on0, cls0), (on1, cls1))]
        table = torch.gather(torch.stack(per_frame, 2), 1,
                             order[..., None, None].expand(-1, -1, 2, 5))
        host = torch.cat([table.reshape(B, -1),
                          count[:, None].to(torch.int32)], 1).cpu().numpy()
        plan = _Plan(host[:, :-1].reshape(table.shape), host[:, -1], dev)

        # Objects texture from the deterministic centre crop of their source.
        crop = ((SH - H) // 2, (SW - W) // 2, H, W)
        size_tab = torch.tensor(sizes, dtype=torch.int32).to(dev)
        frames = (frame0, frame1)
        flows = (flow0, flow1)
        for step in plan.steps:
            kind, r, fr = step[:3]
            sel = plan.rows(step[3])
            k = order[sel, r]
            p = map_scene(lambda t: t[sel, k], prims)
            motion, motion_inv = objs.motion[sel, k], objs.motion_inv[sel, k]
            y0, x0 = org[fr][0][sel, k], org[fr][1][sel, k]
            tex = objs.tex_id[sel, k] % T
            emit_flow = fr == 0 or cfg.compute_inverse_flow
            if kind == "fused":
                edges, meta, fmeta = _object_kernel_inputs(
                    p, motion, motion if fr == 0 else motion_inv, fr,
                    n_prims[sel, k], x0, y0)
                dims = size_tab[(cls0, cls1)[fr][sel, k].long()]
                win = torch.stack([sel.to(torch.int32), dims[:, 0],
                                   dims[:, 1], tex.to(torch.int32)],
                                  -1).contiguous()
                window.object_window(edges, meta, fmeta, win, frames[fr],
                                     flows[fr], atlas_q, crop=crop,
                                     sampled=fr == 1,
                                     use_aa=cfg.use_antialiasing,
                                     emit_flow=emit_flow,
                                     max_hw=sizes[step[4]])
                continue
            wh, ww = sizes[step[4]]
            plan_c = [(plan.rows(live).bool(), plan.rows(polys),
                       plan.rows(ells)) for live, polys, ells in step[5]]
            tr_all = p.intrinsic if fr == 0 else affine.compose(
                p.intrinsic, motion[:, None])
            wpx, wpy = window.window_grids(y0, x0, wh, ww)
            aa, inside = _frame_coverage(p, tr_all, wpx + 0.5, wpy + 0.5,
                                         plan_c, use_pallas)
            bsel = sel[:, None, None]
            yy = (y0.long()[:, None]
                  + torch.arange(wh, device=dev))[:, :, None]
            xx = (x0.long()[:, None]
                  + torch.arange(ww, device=dev))[:, None, :]
            warp_s = warping[sel, k].reshape(-1, 1, 1)
            slot = objs.warp_slot[sel, k]
            if fr == 0:
                tex_w = window.crop_texture(atlas_q, tex, crop, wpx, wpy,
                                            False)
                m = aa if cfg.use_antialiasing else inside.to(torch.float32)
                frame0[bsel, yy, xx] = torch.round(
                    frame0[bsel, yy, xx] * (1.0 - m[..., None])
                    + tex_w * m[..., None])
                mvx, mvy = _apply(motion, wpx, wpy)
                ofx, ofy = mvx - wpx, mvy - wpy
                if has_warp:
                    wfx, wfy = _bilinear_flow_at(warp_bank.flow, slot, mvx,
                                                 mvy)
                    inb = ((mvx >= 0) & (mvx < W) & (mvy >= 0) & (mvy < H)
                           & warp_s)
                    ofx = ofx + torch.where(inb, wfx, torch.zeros_like(wfx))
                    ofy = ofy + torch.where(inb, wfy, torch.zeros_like(wfy))
                fl = flow0[bsel, yy, xx]
                flow0[bsel, yy, xx] = torch.where(
                    inside[..., None], torch.stack([ofx, ofy], -1), fl)
            else:
                sx, sy = _apply(motion_inv, wpx, wpy)
                if has_warp:
                    idx, idy = _bilinear_flow_at(warp_bank.iflow, slot, wpx,
                                                 wpy)
                    wsx, wsy = _apply(motion_inv, wpx + idx, wpy + idy)
                    sx = torch.where(warp_s, wsx, sx)
                    sy = torch.where(warp_s, wsy, sy)
                    cov = torch.stack([aa, inside.to(torch.float32)], -1)
                    cov_w = tex_mod.sample_bilinear(
                        cov, wpx + idx - x0.to(torch.float32)[:, None, None],
                        wpy + idy - y0.to(torch.float32)[:, None, None],
                        wrap="zero")
                    aa = torch.where(warp_s, cov_w[..., 0], aa)
                    inside = torch.where(
                        warp_s, cov_w[..., 1] >= WARP_BINARY_THR, inside)
                tex_w = window.crop_texture(atlas_q, tex, crop, sx, sy, True)
                m = aa if cfg.use_antialiasing else inside.to(torch.float32)
                frame1[bsel, yy, xx] = torch.round(
                    frame1[bsel, yy, xx] * (1.0 - m[..., None])
                    + tex_w * m[..., None])
                if cfg.compute_inverse_flow:
                    imx, imy = _apply(motion_inv, wpx, wpy)
                    fl = flow1[bsel, yy, xx]
                    flow1[bsel, yy, xx] = torch.where(
                        inside[..., None],
                        torch.stack([imx - wpx, imy - wpy], -1), fl)
            if emit_ids:
                idw = ids[bsel, fr, yy, xx]
                ids[bsel, fr, yy, xx] = torch.where(
                    inside,
                    (FOREGROUND_ID_BASE + k).to(torch.int32)[:, None, None],
                    idw)

    out = [frame0, frame1, flow0]
    if cfg.compute_inverse_flow:
        out.append(flow1)
    if emit_ids:
        out.append(ids)
    return tuple(out)


def render_sample(scene, atlas_q, cfg: DataGenConfig, warp_bank=None
                  ) -> RenderOutput:
    """Render one scene (leaves without the batch axis): :func:`render_batch`
    on a batch of one. ``atlas_q`` is the quad-packed atlas of
    :func:`prepare_atlas`; mode 9 passes the crop bank."""
    out = [t[0] for t in render_batch(map_scene(lambda t: t[None], scene),
                                      atlas_q, cfg, warp_bank)]
    flow1 = out[3] if cfg.compute_inverse_flow else None
    ids = out[-1] if cfg.emit_masks else None
    return RenderOutput(out[0], out[1], out[2], flow1, ids)
