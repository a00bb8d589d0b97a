"""Fused batch rendering: the host precompute that feeds the scene kernel
(port of ``flowgen/compose/fused.py``).

Here (dense tensor code, batched over samples): per-object screen bboxes and
painter-order compaction, window-tile grids with ownership rectangles,
screen-space edge tables, ellipse inverse transforms, the per-tile frame-1
resample coefficients with the reflect fold composed in (for modes 11 and
13 after the quadrant factoring), the background metadata, and the masks
derived from the kernel's id images. In the kernel (``ops/scene.py``):
everything per pixel. The tables are contiguous tensors; the TPU-only
flattening to SMEM rows is not ported.
"""

from __future__ import annotations

import math
import warnings

import torch

from .._fp import div, f32, mod, sqrt
from ..config import MAX_COMPONENTS, MAX_EDGES, DataGenConfig
from ..ops import affine
from ..ops import resample as resamp
from ..ops import scene as ps
from ..params.blueprint import Scene
from ..utils.profiling import span
from . import render as render_mod

EDGE_POOL = ((MAX_COMPONENTS * MAX_EDGES + 127) // 128) * 128  # 896
MAX_TILES_AXIS = 3


def _cdiv(a, b):
    return (a + b - 1) // b


def _tile_grid(lo, hi, on, frame_dim, win, snap, margin):
    """Per-object tile grid along one axis: (anchor, n_tiles) int32 [..., K]."""
    cov_lo = torch.clamp(torch.floor(lo - margin), 0, frame_dim).to(torch.int32)
    cov_hi = torch.clamp(torch.ceil(hi + margin) + 1, 0, frame_dim).to(torch.int32)
    anchor = cov_lo & ~(snap - 1)
    n = torch.clamp(_cdiv(cov_hi - anchor, win), 1, MAX_TILES_AXIS)
    return anchor, torch.where(on, n, torch.zeros_like(n))


def _edge_table(tr, prims):
    """Screen-space edge endpoints of every primitive slot under transforms
    ``tr`` [..., K, C, 2, 3]: (..., K, 4, EDGE_POOL) f32, rows
    [ax, ay, bx, by]."""
    pts = affine.apply(tr, prims.edge_pts)               # [...,K,C,E,2]
    b = torch.roll(pts, -1, dims=-2)
    tab = torch.stack(
        [pts[..., 0], pts[..., 1], b[..., 0], b[..., 1]], dim=-3
    )                                                    # [...,K,4,C,E]
    tab = tab.reshape(tab.shape[:-2] + (-1,))
    pad = EDGE_POOL - tab.shape[-1]
    return torch.nn.functional.pad(tab, (0, pad))


def _ell_params(tr, prims):
    """Per-primitive ellipse params [..., K, C*8]: inverse transform (6),
    rx, ry."""
    inv = affine.invert(tr)
    out = torch.cat(
        [
            inv.reshape(inv.shape[:-2] + (6,)),
            prims.ell_rx[..., None],
            prims.ell_ry[..., None],
        ],
        dim=-1,
    )
    return out.reshape(out.shape[:-2] + (-1,))


def _ell_yext(tr, prims):
    """Per-primitive screen y-extent [..., K, C*2] = (ymin, ymax)."""
    cy = tr[..., 1, 2]
    a = tr[..., 1, 0] * prims.ell_rx
    b = tr[..., 1, 1] * prims.ell_ry
    hy = sqrt(a * a + b * b)
    out = torch.stack([cy - hy, cy + hy], dim=-1)
    return out.reshape(out.shape[:-2] + (-1,))


def _ell_radius(tr, prims):
    """Upper bound of each primitive's screen radius under ``tr``: the
    Frobenius norm of L diag(rx, ry), which bounds its largest semi-axis."""
    l = tr[..., :2]
    rx, ry = prims.ell_rx, prims.ell_ry
    a, b = l[..., 0, 0] * rx, l[..., 0, 1] * ry
    c, d = l[..., 1, 0] * rx, l[..., 1, 1] * ry
    return sqrt(a * a + b * b + c * c + d * d)


def _fold_coeffs(t, cx, cy, nx, ny, margin):
    """Two-pass coefficients for windows centred at (cx, cy) [..., T],
    sampling an (ny, nx) texture through ``t`` [..., 2, 3] with the AGG
    reflect wrap folded in (``jnp.mod`` fold of the JAX package's host
    precompute)."""
    m = t[..., None, :, :]
    scx = m[..., 0, 0] * cx + m[..., 0, 1] * cy + m[..., 0, 2]
    scy = m[..., 1, 0] * cx + m[..., 1, 1] * cy + m[..., 1, 2]

    def fold(s_c, n):
        r = mod(s_c, 2.0 * n)
        mirror = r >= n
        off = s_c - r
        sigma = torch.where(mirror, -1.0, 1.0).to(s_c.dtype)
        beta = torch.where(mirror, 2.0 * n - 1.0 + off, -off) + margin
        return sigma, beta

    sx, bx = fold(scx, nx)
    sy, by = fold(scy, ny)
    a = m[..., 0, 0] * sx
    bb = m[..., 0, 1] * sx
    e = m[..., 0, 2] * sx + bx
    c = m[..., 1, 0] * sy
    d = m[..., 1, 1] * sy
    f = m[..., 1, 2] * sy + by
    B_ = div(bb, d)
    A = a - B_ * c
    C_ = e - B_ * f
    return torch.stack([A, B_, C_, c, d, f], dim=-1)


def _quadrant_factor(minv, W, H):
    """Factor each frame-1 sampling affine [..., 2, 3] (output -> source) as
    quadrant times residual, so that the residual rotation stays within the
    two-pass resampler's 45-degree bound for any object rotation (modes 11
    and 13). q = round(theta / 90 deg); the 180-degree part is the point
    reflection p -> -1 - p, under which the reflect extension is invariant;
    the +-90-degree parts swap the coordinates and sample the rot90 slab
    copy. Returns (t_eff [..., 2, 3], rot90 [...] bool)."""
    theta = torch.atan2(minv[..., 1, 0], minv[..., 0, 0])
    q = torch.round(div(theta, f32(math.pi / 2))).to(torch.int32)
    mirror = (q == -1) | (q.abs() == 2)
    rot90 = q.abs() == 1
    tm = torch.where(
        mirror[..., None, None],
        torch.cat([-minv[..., :2], -minv[..., 2:] - 1.0], dim=-1),
        minv,
    )
    tq = torch.stack(
        [
            tm[..., 1, :],
            torch.cat([-tm[..., 0, :2], (W - 1.0) - tm[..., 0, 2:]], dim=-1),
        ],
        dim=-2,
    )
    return torch.where(rot90[..., None, None], tq, tm), rot90


def _span_requirements(t_eff, wh, ww, chunk, xchunk):
    """Actual two-pass requirements (row_span, xs_need, ys_need) of
    effective output -> source affines ``t_eff`` [..., 2, 3]."""
    a = t_eff[..., 0, 0]
    b = t_eff[..., 0, 1]
    c = t_eff[..., 1, 0]
    d = t_eff[..., 1, 1]
    d_safe = torch.where(d.abs() < f32(1e-9), torch.full_like(d, f32(1e-9)), d)
    B = div(b, d_safe)
    A = a - B * c
    span = c.abs() * ww + d.abs() * wh + 4.0 + 8.0
    xs_need = torch.ceil(div(A.abs() * 128.0 + B.abs() * chunk + 3.0, 128.0)) + 1.0
    ys_need = torch.ceil(div(c.abs() * xchunk + d.abs() * 128.0 + 3.0, 128.0)) + 1.0
    return span, xs_need, ys_need


def envelope_violations(scenes: Scene, cfg: DataGenConfig, bgm=None):
    """Count the scene elements of a batch whose actual frame-1 sampling
    affine needs a larger pass-1 row span or scan window than the kernel is
    sized for (zero for every built-in mode). Returns an int tensor."""
    H, W = cfg.height, cfg.width
    spec = cfg.mode_spec
    wh, ww = min(ps.WIN_H, H), min(ps.WIN_W, W)
    P, PBG, xs, ys, xsb, ysb, tsp, _, _ = ps.resample_params(spec, H, W)
    whs, wws = wh // tsp, ww // tsp
    chunk = float(min(resamp.PASS1_CHUNK, max(P, PBG)))
    xchunk = float(min(128, wws))
    objs = scenes.objects
    t_eff = objs.motion_inv
    if ps.quadrant_needed(spec):
        t_eff, _ = _quadrant_factor(t_eff, float(W), float(H))
    span, xsn, ysn = _span_requirements(t_eff, whs, wws, chunk, xchunk)
    bad = (span > P) | (xsn > xs) | (ysn > ys)
    _, (lo1, hi1) = render_mod._all_bboxes(scenes.prims, objs.motion)
    on1 = objs.valid & ~render_mod._offscreen(
        lo1, hi1, render_mod.AA_MARGIN + 1.0, H, W
    )
    n = (bad & on1).to(torch.int32).sum()
    if bgm is not None:
        t1 = bgm[:, 6:12].reshape(-1, 2, 3)
        span, xsn, ysn = _span_requirements(t1, wh, ww, chunk, xchunk)
        n = n + ((span > PBG) | (xsn > xsb) | (ysn > ysb)).to(torch.int32).sum()
    return n


_BUILTIN_MODES = frozenset(range(1, 14)) | frozenset(range(101, 114))


def _validate_enabled(cfg: DataGenConfig) -> bool:
    if cfg.validate_envelope == "always":
        return True
    if cfg.validate_envelope == "never":
        return False
    return cfg.mode not in _BUILTIN_MODES


def check_ellipse_bound(spec):
    """The ellipse row-block cull (``ps.ELL_CULL_M``) is exact only while
    every fat ellipse's screen radius keeps the 100-gon chord sagitta under
    one pixel. A mode whose ranges allow larger ellipses is refused."""
    r = ps.ellipse_radius_bound(spec)
    if not r < ps.ELL_R_MAX:
        raise ValueError(
            f"mode {spec.mode}: ellipses reach a screen radius of {r:.0f} px, "
            f"beyond the {ps.ELL_R_MAX:.0f} px the ellipse row cull "
            f"(ELL_CULL_M={ps.ELL_CULL_M}) is exact for"
        )


def prepare_scene_inputs(scene: Scene, cfg: DataGenConfig, n_textures: int,
                         quadrant: bool = False):
    """Build a batch's scene-kernel operands: (count (B,), order (B,K),
    omi (B,K,2,16), omf (B,K,2,88), tmi (B,K,2,9,8), tmf (B,K,2,9,8),
    edges (B,K,2,4,EP)). ``quadrant`` factors the frame-1 sampling affines
    (:func:`_quadrant_factor`) onto slabs with rot90 copies at [T:2T]."""
    check_ellipse_bound(cfg.mode_spec)
    H, W = cfg.height, cfg.width
    wh, ww = min(ps.WIN_H, H), min(ps.WIN_W, W)
    prims, objs = scene.prims, scene.objects
    B, K, C = prims.valid.shape
    dev = prims.valid.device

    (lo0, hi0), (lo1, hi1) = render_mod._all_bboxes(prims, objs.motion)
    n_prims = prims.valid.sum(-1).to(torch.int32)
    has_warp = cfg.mode_spec.warp_p > 0.0
    warp_k = (objs.warp & objs.valid) if has_warp else torch.zeros_like(objs.valid)
    margin0 = torch.full((B, K), render_mod.AA_MARGIN + 1.0, device=dev)
    margin1 = margin0 + torch.where(
        warp_k, torch.full_like(margin0, render_mod.WARP_MARGIN),
        torch.zeros_like(margin0),
    )
    on0 = objs.valid & ~render_mod._offscreen(lo0, hi0, render_mod.AA_MARGIN, H, W)
    on1 = objs.valid & ~render_mod._offscreen(lo1, hi1, margin1, H, W)
    process = on0 | on1
    order = torch.argsort((~process).to(torch.int8), dim=-1, stable=True).to(
        torch.int32
    )
    count = process.sum(-1).to(torch.int32)

    def tiles(lo, hi, on, margin):
        ay, nty = _tile_grid(lo[..., 1], hi[..., 1], on, H, wh, 8, margin)
        ax, ntx = _tile_grid(lo[..., 0], hi[..., 0], on, W, ww, 128, margin)
        t = torch.arange(ps.MAX_TILES, device=dev)
        ntx1 = torch.clamp(ntx, min=1)[..., None]
        ty = t // ntx1
        tx = t % ntx1
        oy0 = ay[..., None] + ty * wh
        ox0 = ax[..., None] + tx * ww
        y0 = torch.clamp(oy0, 0, H - wh)
        x0 = torch.clamp(ox0, 0, W - ww)
        z = torch.zeros_like(y0)
        tmi = torch.stack(
            [y0, x0, oy0, torch.clamp(oy0 + wh, max=H),
             ox0, torch.clamp(ox0 + ww, max=W), z, z], dim=-1,
        ).to(torch.int32)                                 # [B,K,T,8]
        return tmi, nty, ntx

    tmi0, nty0, ntx0 = tiles(lo0, hi0, on0, margin0)
    tmi1, nty1, ntx1 = tiles(lo1, hi1, on1, margin1)
    tmi = torch.stack([tmi0, tmi1], dim=2)                # [B,K,2,T,8]

    shifts = torch.arange(C, device=dev)
    add_bits = (prims.additive.to(torch.int32) << shifts).sum(-1)
    poly_bits = (prims.is_poly.to(torch.int32) << shifts).sum(-1)
    tex_id = objs.tex_id % n_textures
    zeros = torch.zeros_like(tex_id)
    warp_slot = objs.warp_slot.to(torch.int32)

    if quadrant:
        t_samp1, rot90_k = _quadrant_factor(objs.motion_inv, float(W), float(H))
        tex_id1 = tex_id + n_textures * rot90_k.to(tex_id.dtype)
        nx1 = torch.where(rot90_k, float(H), float(W))[..., None]
        ny1 = torch.where(rot90_k, float(W), float(H))[..., None]
    else:
        t_samp1 = objs.motion_inv
        tex_id1 = tex_id
        nx1 = torch.full((B, K, 1), float(W), device=dev)
        ny1 = torch.full((B, K, 1), float(H), device=dev)

    def omi_frame(on, nty, ntx, tex):
        cols = [
            on.to(torch.int32), nty, ntx, tex,
            n_prims, add_bits, poly_bits, warp_k.to(torch.int32),
        ]
        cols += [prims.n_edges[..., c].to(torch.int32) for c in range(C)]
        cols += [zeros] * (ps.OMI_SIZE - 1 - len(cols))
        cols += [warp_slot]
        return torch.stack([c.to(torch.int32) for c in cols], dim=-1)

    omi = torch.stack(
        [omi_frame(on0, nty0, ntx0, tex_id),
         omi_frame(on1, nty1, ntx1, tex_id1)], dim=2
    ).to(torch.int32)                                     # [B,K,2,16]

    intr = prims.intrinsic                                # [B,K,C,2,3]
    tr0 = intr
    tr1 = affine.compose(intr, objs.motion[..., None, :, :])

    # The ellipse row cull's radius bound, on the data as well: a violation
    # would zero valid coverage rows.
    fat = prims.valid & ~prims.is_poly
    r_max = torch.where(
        fat, torch.maximum(_ell_radius(tr0, prims), _ell_radius(tr1, prims)),
        torch.zeros_like(prims.ell_rx),
    )
    torch._assert_async(
        (r_max < ps.ELL_R_MAX).all(),
        "ellipse screen radius beyond the ELL_CULL_M row-cull bound",
    )

    def omf_frame(motion, tr, raw):
        mot = motion.reshape(B, K, 6)
        pad = torch.zeros((B, K, ps.OMF_ELL - 6), device=dev)
        ell = _ell_params(tr, prims)
        tail = torch.zeros((B, K, ps.OMF_RAW - ps.OMF_ELL - ell.shape[-1]),
                           device=dev)
        yext = _ell_yext(tr, prims)
        epad = torch.zeros((B, K, ps.OMF_SIZE - ps.OMF_EXT - yext.shape[-1]),
                           device=dev)
        return torch.cat([mot, pad, ell, tail, raw, yext, epad], dim=-1)

    raw1 = torch.cat([t_samp1.reshape(B, K, 6), nx1, ny1], dim=-1)
    omf = torch.stack(
        [omf_frame(objs.motion, tr0, torch.zeros_like(raw1)),
         omf_frame(objs.motion_inv, tr1, raw1)], dim=2
    ).to(torch.float32)                                   # [B,K,2,88]

    edges = torch.stack([_edge_table(tr0, prims), _edge_table(tr1, prims)],
                        dim=2).to(torch.float32)          # [B,K,2,4,EP]

    ctrx = tmi1[..., ps.TMI_X0].to(torch.float32) + ww / 2.0   # [B,K,T]
    ctry = tmi1[..., ps.TMI_Y0].to(torch.float32) + wh / 2.0
    coef1 = _fold_coeffs(t_samp1, ctrx, ctry, nx1, ny1, float(ps.SLAB_MARGIN))
    tmf1 = torch.nn.functional.pad(coef1, (0, ps.TMF_SIZE - 6))
    tmf = torch.stack([torch.zeros_like(tmf1), tmf1], dim=2)  # [B,K,2,T,8]

    return count, order, omi, omf, tmi, tmf.to(torch.float32), edges


def _bg_meta_payload(scene: Scene, cfg: DataGenConfig, src_h, src_w):
    """Per-sample background metadata (B, BGM_SIZE) f32: the raw output ->
    source affines of both frames, the source reflect periods, the
    background pixel motion, the forward-field sampling affine and the
    inverse pixel motion. ``src_h`` / ``src_w``: the background sources'
    size, two numbers, or each sample's source's native size, (B,) integer
    tensors (the TextureDB path)."""
    from ..ops import texture as tex_mod

    H, W = cfg.height, cfg.width
    bg = scene.background
    B = bg.motion.shape[0]
    dev = bg.motion.device
    crop_t = tex_mod.randomized_crop_transform_native(
        src_h, src_w, 2 * H, 2 * W,
        bg.tex_rot_deg, bg.tex_zoom, bg.tex_shift[:, 0], bg.tex_shift[:, 1],
    )
    center = affine.translation(W / 2.0, H / 2.0, like=bg.motion)
    t0 = affine.chain(center, crop_t)
    bg_big_inv = affine.invert(
        affine.conjugate_about(bg.motion, float(W), float(H))
    )
    t1 = affine.chain(center, bg_big_inv, crop_t)
    pixmot = affine.conjugate_about(bg.motion, W / 2.0, H / 2.0)
    flin = pixmot[..., :2] * 0.5
    half = torch.tensor([W / 2.0, H / 2.0], device=dev)
    ftr = (pixmot[..., 2] + half + 0.5) * 0.5 - 0.5
    faff = torch.cat([flin, ftr[..., None]], dim=-1)
    ipix = affine.invert(pixmot)
    zeros2 = torch.zeros((B, 2), device=dev)
    if torch.is_tensor(src_h):
        src = torch.stack([src_w, src_h], dim=-1).to(torch.float32)
    else:
        src = torch.tensor([float(src_w), float(src_h)], device=dev).expand(B, 2)
    return torch.cat(
        [
            t0.reshape(B, 6), t1.reshape(B, 6), src, zeros2,
            pixmot.reshape(B, 6), zeros2,
            faff.reshape(B, 6), zeros2,
            ipix.reshape(B, 6), zeros2,
        ],
        dim=-1,
    )


def check_fused(cfg: DataGenConfig):
    """The scene kernel's own conditions: frames of multiples of (8, 128)
    and a mode whose motion envelope fits its slabs. Other configurations
    render through the windowed renderer (``compose/render.py``)."""
    if not ps.fused_eligible(cfg.mode_spec, cfg.height, cfg.width):
        raise ValueError(
            f"mode {cfg.mode} at {cfg.width}x{cfg.height} does not fit the "
            "scene kernel (frames of multiples of (8, 128)); render it with "
            "the windowed renderer (render_impl='windowed')")


def _source_sizes(bg_tex, src_hw, tex_sizes):
    """Each sample's background source size (src_h, src_w): the two numbers
    ``src_hw``, or (B,) tensors gathered from the per-source native sizes
    ``tex_sizes`` (T, 2) (h, w) when given."""
    if tex_sizes is None:
        return src_hw[0], src_hw[1]
    sz = torch.as_tensor(tex_sizes, device=bg_tex.device)[bg_tex.long()]
    return sz[:, 0], sz[:, 1]


def scene_tables(scenes: Scene, cfg: DataGenConfig, slabs, bgslabs, src_hw,
                 tex_sizes=None, warp_aux=None):
    """A batch's scene-kernel inputs: ``(args, options)``, with ``args`` in
    :func:`ops.scene.scene_render`'s order and ``options`` its keyword
    arguments (``spec_key``, ``use_aa``, ``inverse_flow``, ``emit_masks``).
    ``src_hw``: the background sources' (height, width), the bg slabs'
    unpadded size. A TextureDB's sources keep their native sizes,
    ``tex_sizes`` (T, 2) (h, w) per source; each sample's background then
    gets its own reflect periods and crop geometry. ``slabs`` to
    ``tex_sizes`` are what ``pipeline/generator.py:make_slab_packer``
    returns. Nonrigid modes pass ``warp_aux``, the
    ``compose/render.py:WarpAux`` of ``warpfields/generator.py:
    make_bank_and_aux``. Quadrant modes take ``slabs`` with the rot90
    copies (``ops/scene.py:prepare_slabs``)."""
    with span("flowgen.precompute"):
        H, W = cfg.height, cfg.width
        quadrant = ps.quadrant_needed(cfg.mode_spec)
        n_tex = slabs.shape[0] // 2 if quadrant else slabs.shape[0]
        count, order, omi, omf, tmi, tmf, edges = prepare_scene_inputs(
            scenes, cfg, n_tex, quadrant=quadrant
        )
        bg = scenes.background
        bg_meta = torch.stack(
            [(bg.tex_id % bgslabs.shape[0]).to(torch.int32),
             bg.warp.to(torch.int32), bg.warp_slot.to(torch.int32)], dim=1,
        )
        bgm = _bg_meta_payload(
            scenes, cfg, *_source_sizes(bg_meta[:, 0], src_hw, tex_sizes))

        if _validate_enabled(cfg):
            viol = int(envelope_violations(scenes, cfg, bgm=bgm))
            if viol > 0:
                warnings.warn(
                    f"{viol} scene element(s) exceed mode {cfg.mode}'s "
                    "declared motion envelope; their fused resampling is "
                    "unreliable"
                )

        has_warp = cfg.mode_spec.warp_p > 0.0
        if has_warp and warp_aux is None:
            raise ValueError("mode %d deforms objects: pass warp_aux"
                             % cfg.mode)
        planes = tuple(warp_aux) if has_warp else (None, None, None)
        worklist, n_units = ps.build_worklists(count, order, omi)
        args = (bg_meta, omi, omf, tmi, tmf.contiguous(), bgm.contiguous(),
                edges.contiguous(), slabs, bgslabs, worklist,
                n_units) + planes
        options = dict(
            spec_key=ps.resample_params(cfg.mode_spec, H, W) + (H, W),
            use_aa=cfg.use_antialiasing,
            inverse_flow=cfg.compute_inverse_flow, emit_masks=cfg.emit_masks,
        )
        return args, options


def render_batch_fused(scenes: Scene, slabs, bgslabs, src_hw,
                       cfg: DataGenConfig, bg_only: bool = False,
                       warp_aux=None, tex_sizes=None):
    """Fused render of a batch: (image0, image1, flow0[, flow1][, occlusion,
    motion_boundary]) with images (B,H,W,3) float32 in [0, 255], flows
    (B,H,W,2) and masks (B,H,W) bool, ``flow1`` with
    ``cfg.compute_inverse_flow`` and the masks with ``cfg.emit_masks``.
    ``src_hw`` and ``tex_sizes`` as in :func:`scene_tables`. Nonrigid
    modes pass ``warp_aux`` (a ``compose/render.py:WarpAux``)."""
    check_fused(cfg)
    args, options = scene_tables(scenes, cfg, slabs, bgslabs, src_hw,
                                 tex_sizes, warp_aux)
    frames, flow, ids = ps.scene_render(*args, bg_only=bg_only, **options)

    def unpack(v):
        return torch.stack(resamp.unpack_rgb(v), dim=-1)

    with span("flowgen.unpack"):
        out = [unpack(frames[:, 0]), unpack(frames[:, 1]),
               flow[:, 0:2].permute(0, 2, 3, 1)]
        if cfg.compute_inverse_flow:
            out.append(flow[:, 2:4].permute(0, 2, 3, 1))
        if cfg.emit_masks:
            out += list(masks_from_ids(ids, flow[:, 0], flow[:, 1]))
    return tuple(out)


def masks_from_ids(ids, fx, fy):
    """Occlusion and motion-boundary masks from the painter's id images
    ``ids`` (B, 2, H, W) and the forward flow ``fx``, ``fy`` (B, H, W).
    ``occlusion``: frame-0 pixel p is occluded where p + f(p), rounded to
    the nearest pixel (half to even), leaves the frame or lands on another
    id in frame 1. ``motion_boundary``: 4-neighbourhood discontinuities of
    the frame-0 id image, edges replicated. Returns two (B, H, W) bool
    tensors. Plain tensor code on any device, as in the JAX package."""
    with span("flowgen.masks"):
        B, _, H, W = ids.shape
        ids0, ids1 = ids[:, 0], ids[:, 1]
        yy = torch.arange(H, dtype=torch.float32, device=ids.device)[:, None]
        xx = torch.arange(W, dtype=torch.float32, device=ids.device)[None, :]
        tx = torch.round(xx + fx).to(torch.int32)
        ty = torch.round(yy + fy).to(torch.int32)
        oob = (tx < 0) | (tx >= W) | (ty < 0) | (ty >= H)
        base = (torch.arange(B, device=ids.device) * (H * W))[:, None, None]
        flat = (base + torch.clamp(ty, 0, H - 1) * W
                + torch.clamp(tx, 0, W - 1)).long()
        occlusion = oob | (ids1.reshape(-1)[flat] != ids0)
        up = torch.cat([ids0[:, :1], ids0[:, :-1]], dim=1)
        down = torch.cat([ids0[:, 1:], ids0[:, -1:]], dim=1)
        left = torch.cat([ids0[:, :, :1], ids0[:, :, :-1]], dim=2)
        right = torch.cat([ids0[:, :, 1:], ids0[:, :, -1:]], dim=2)
        boundary = ((ids0 != up) | (ids0 != down) | (ids0 != left)
                    | (ids0 != right))
        return occlusion, boundary
