"""The scene renderer: host-side layout and sizing, the CUDA scene kernel's
wrapper, and its plain PyTorch version (port of
``flowgen/ops/pallas_scene.py``).

One call renders a whole batch: both background frames (randomized-crop
affine resample with a reflect fold chosen per static window tile, rounded
to u8, plus the affine background flow), then every (object, tile) work
unit of each frame in painter's order: exact-area coverage with the
composite screen algebra, the object texture (frame 0: the slab's identity
window; frame 1: the two-pass affine resample), ``round(f(1-m) + t m)``
blending, and the flow overwrite under the binary mask (frame 0, and frame
1 into the inverse-flow planes when asked). In mode 9 a deforming object's
frame 1 is evaluated on an expanded window and displaced through its bank
slot's warp planes, a deforming background's frame 1 likewise on an
extended grid, and the forward warp field adds to the flow at the moved
positions. Modes whose rotations pass 45 degrees (11, 13) sample frame 1
from rot90 slab copies (quadrant slabs, composed into the tables by
``compose/fused.py``) and, where the footprint needs it, over ``tsplit x
tsplit`` sub-windows, each folded at its own centre. With ``emit_masks``
each frame also gets its painter's id image.

``scene_render`` launches the hand-written CUDA kernel
(``csrc/scene.cu``, ``csrc/warp.cuh``) for CUDA tensors and runs
``scene_render_plain`` for CPU tensors. ``scene_render_plain`` restates the
JAX kernel's unit loop literally: windows, ownership rectangles, the staged
two-pass resample (pass 1 over all P rows, then pass 2), the frame-1
sub-windows and, in mode 9, the staged displacement warps with their banded
taps.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from . import resample as resamp
from .._fp import div, f32
from ..config import BACKGROUND_OBJ_ID as BG_ID
from ..config import FOREGROUND_ID_BASE as FG_ID_BASE
from ..utils.profiling import span

# Window tile size: one unit of object evaluation.
WIN_H = 192
WIN_W = 256
MAX_TILES_Y = 3
MAX_TILES_X = 3
MAX_TILES = MAX_TILES_Y * MAX_TILES_X
# Reflect-padded slab margin: must exceed half the source footprint diameter
# of one window tile (window diag * max inverse scale / 2).
SLAB_MARGIN = 256
WARP_D = 48
WARP_EY = 56
WARP_EX = 64
BG_EY = 96
BG_EX = 128
IN_THR = 1.0 - 0.5 / 255.0   # warped-binary threshold

# bgm layout (per sample, f32).
BGM_T0 = 0      # frame-0 output->source affine (2x3 row-major)
BGM_T1 = 6      # frame-1 (inverse big motion composed)
BGM_SRCW = 12   # source reflect periods
BGM_SRCH = 13
BGM_PIX = 16    # bg pixel motion (conjugated about the frame centre)
BGM_FAFF = 24   # forward-field sampling affine (mode 9)
BGM_IPIX = 32   # inverse bg pixel motion (inverse-flow init)
BGM_SIZE = 40

# objmeta_i layout (per object, per frame)
OMI_ON = 0
OMI_NTY = 1
OMI_NTX = 2
OMI_TEX = 3
OMI_NPRIMS = 4
OMI_ADD_BITS = 5
OMI_POLY_BITS = 6
OMI_WARP = 7
OMI_NEDGES = 8      # n_edges[0..6] at 8..14
OMI_SLOT = 15
OMI_SIZE = 16

# objmeta_f layout (per object, per frame)
OMF_MOTION = 0
OMF_ELL = 8         # + c*8: ellipse inverse transform (6), rx, ry
OMF_RAW = 64        # frame 1: raw residual texture affine (6) + periods
OMF_EXT = 72        # + c*2: ellipse screen y-extent [ymin, ymax]
OMF_SIZE = 88

# Ellipse row-block cull margin: cell half-diagonal (<= 0.71) + chord
# sagitta ((1 - cos(pi/100)) * r_screen < 1, i.e. r_screen < ELL_R_MAX)
# + slack. prepare_scene_inputs asserts the radius bound.
ELL_CULL_M = 2.0
ELL_R_MAX = 1.0 / (1.0 - math.cos(math.pi / 100))

# tilemeta layouts (per object, frame, tile slot)
TMI_Y0 = 0
TMI_X0 = 1
TMI_OY0 = 2
TMI_OY1 = 3
TMI_OX0 = 4
TMI_OX1 = 5
TMI_SIZE = 8
TMF_SIZE = 8


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def slab_shape(height: int, width: int):
    return (
        _round_up(height + 2 * SLAB_MARGIN, 8),
        _round_up(width + 2 * SLAB_MARGIN, 128),
    )


def _slab_of(img, hs: int, ws: int):
    s = resamp.reflect_pad(resamp.pack_rgb_i32(img), SLAB_MARGIN, SLAB_MARGIN)
    return resamp._edge_pad(s, hs, ws)


def _stack_quadrant(tex, height: int, width: int):
    """Packed slabs of ``tex`` (T, height, width, 3) and of their rot90(k=1)
    copies, padded to the larger of both orientations and stacked along T:
    slots [T:2T] hold the rotated sources (frame-1 texture ids of an odd
    quadrant point there). The 180-degree quadrant needs no copy: the
    reflect extension is invariant under the point reflection."""
    h0, w0 = slab_shape(height, width)
    h1, w1 = slab_shape(width, height)
    hs, ws = max(h0, h1), max(w0, w1)
    base = [_slab_of(im, hs, ws) for im in tex]
    rot = [_slab_of(torch.rot90(im, 1, (0, 1)), hs, ws) for im in tex]
    return torch.stack(base + rot)


def prepare_slabs(atlas, height: int, width: int, quadrant: bool = False):
    """(T, SH, SW, 3) atlas -> (T, SHs, SWs) int32 packed slabs of the
    frame-sized centre crops with SLAB_MARGIN reflected texels per side.
    ``quadrant`` adds the rot90 copies at slots [T:2T]
    (:func:`_stack_quadrant`)."""
    sh, sw = atlas.shape[1], atlas.shape[2]
    y0 = (sh - height) // 2
    x0 = (sw - width) // 2
    crops = atlas[:, y0 : y0 + height, x0 : x0 + width]
    if quadrant:
        return _stack_quadrant(crops, height, width)
    hs, ws = slab_shape(height, width)
    return torch.stack([_slab_of(im, hs, ws) for im in crops])


def prepare_bg_slabs(atlas):
    """(T, SH, SW, 3) atlas -> (T, SHb, SWb) int32 packed slabs of the FULL
    sources with SLAB_MARGIN reflected texels per side."""
    hs = _round_up(atlas.shape[1] + 2 * SLAB_MARGIN, 8)
    ws = _round_up(atlas.shape[2] + 2 * SLAB_MARGIN, 128)
    return torch.stack([_slab_of(im, hs, ws) for im in atlas])


def prepare_obj_slabs(obj_tex, quadrant: bool = False):
    """(T, H, W, 3) object textures (``TextureDB.obj_tex``: each source's
    centre crop, or its whole-image resize when it is small) -> packed
    reflect-padded slabs in the layout of :func:`prepare_slabs`, with the
    rot90 copies at [T:2T] when ``quadrant``."""
    height, width = obj_tex.shape[1], obj_tex.shape[2]
    if quadrant:
        return _stack_quadrant(obj_tex, height, width)
    hs, ws = slab_shape(height, width)
    return torch.stack([_slab_of(im, hs, ws) for im in obj_tex])


def prepare_bg_slabs_db(sources, sizes):
    """(T, maxH, maxW, 3) zero-padded native sources and their (T, 2)
    native (h, w) -> (T, SHb, SWb) int32 packed background slabs with
    PER-SOURCE reflect periods: slab[t, i, j] = src[t, reflect(i - M, h_t),
    reflect(j - M, w_t)] over the whole slab, so any position in it holds
    the source's AGG reflect extension at its native size."""
    T = sources.shape[0]
    hs, ws = slab_shape(sources.shape[1], sources.shape[2])
    dev = sources.device
    packed = resamp.pack_rgb_i32(sources)
    ys = torch.arange(hs, device=dev) - SLAB_MARGIN
    xs = torch.arange(ws, device=dev) - SLAB_MARGIN
    out = torch.empty((T, hs, ws), dtype=torch.int32, device=dev)
    for t, (h, w) in enumerate(torch.as_tensor(sizes).tolist()):
        yi = resamp._reflect_indices(ys, h)
        xi = resamp._reflect_indices(xs, w)
        out[t] = packed[t][yi][:, xi]
    return out


def bg_envelope(spec):
    """Static motion envelope (max rotation, max inverse scale) of the
    background texture chain."""
    crop_rot = math.pi * math.pi / 180.0
    inv_zoom = 1.0 / 0.8
    rot = crop_rot
    inv_s = inv_zoom
    if spec.bg_rot_p > 0:
        rot += max(abs(spec.bg_rot_range[0]), abs(spec.bg_rot_range[1]))
    if spec.bg_scale_p > 0:
        inv_s /= spec.bg_scale_range[0]
    return rot, inv_s


def mode_envelope(spec, height: int, width: int):
    """Static motion envelope of a mode's objects: (max |total rotation|,
    max inverse scale)."""
    rot = 0.0
    if spec.obj_rot_p > 0:
        rot += max(abs(spec.obj_rot_range[0]), abs(spec.obj_rot_range[1]))
    if spec.bg_rot_p > 0:
        rot += max(abs(spec.bg_rot_range[0]), abs(spec.bg_rot_range[1]))
    s_lo = 1.0
    if spec.obj_scale_p > 0:
        s_lo *= spec.obj_scale_range[0]
    if spec.bg_scale_p > 0:
        s_lo *= spec.bg_scale_range[0]
    return rot, 1.0 / s_lo


def ellipse_radius_bound(spec) -> float:
    """Largest screen radius a fat ellipse of ``spec`` can reach: the
    largest sampled radius times the largest total motion scale (intrinsic
    poses and composite parts never enlarge)."""
    s_hi = 1.0
    if spec.obj_scale_p > 0:
        s_hi *= spec.obj_scale_range[1]
    if spec.bg_scale_p > 0:
        s_hi *= spec.bg_scale_range[1]
    return spec.ellipse_radius_factor * spec.ellipse_scale_range[1] * s_hi


def quadrant_needed(spec) -> bool:
    """Does the mode's total-rotation envelope exceed the two-pass
    resampler's 45-deg conditioning bound (modes 11/13)?"""
    rot, _ = mode_envelope(spec, 0, 0)
    return rot >= math.pi / 4 - 1e-3


def fused_eligible(spec, height: int, width: int) -> bool:
    """Static check: can this mode run through the scene kernel?"""
    return (
        height % 8 == 0
        and width % 128 == 0
        and height >= 8
        and width >= 128
        and texture_split(spec, height, width) is not None
    )


def _scan_counts(rot: float, inv_s: float, rows: int, ww: int):
    a_max = inv_s / math.cos(rot)
    b_max = math.tan(rot)
    c_max = math.sin(rot) * inv_s
    d_max = inv_s
    xs = resamp.scan_tiles_pass1(a_max, b_max, min(resamp.PASS1_CHUNK, rows))
    ys = resamp.scan_tiles_pass2(c_max, d_max, min(128, ww))
    return xs, ys


def texture_split(spec, height: int, width: int):
    """Static frame-1 texture sub-tiling factor, or None if none fits the
    slab's reflect margin and height."""
    wh, ww = min(WIN_H, height), min(WIN_W, width)
    rot_o, inv_o = mode_envelope(spec, height, width)
    rot_o = min(rot_o, math.pi / 4)
    SH = _round_up(height + 2 * SLAB_MARGIN, 8)
    if quadrant_needed(spec):
        SH = max(SH, _round_up(width + 2 * SLAB_MARGIN, 8))
    for s in (1, 2):
        whs, wws = wh // s, ww // s
        if whs % 8 or wws % 128:
            continue
        radius = 0.5 * math.hypot(whs, wws) * inv_o
        Ps = resamp.max_row_span(whs, wws, rot_o + 1e-6, inv_o)
        if radius + 2.0 <= SLAB_MARGIN and Ps <= SH:
            return s
    return None


def _col_span(rot: float, inv_s: float, wwl: int, rows: int) -> int:
    """Static bound on the pass-1 source-column span of a staged row block
    (+4 lerp/floor slack, +129 for the 128-snap of the window start)."""
    a_max = inv_s / math.cos(rot)
    b_max = math.tan(rot)
    return _round_up(int(math.ceil(a_max * wwl + b_max * rows + 4)) + 129, 128)


def resample_params(spec, height: int, width: int):
    """Static (P_obj, P_bg, x_scan, y_scan, x_scan_bg, y_scan_bg, tsplit,
    cw_obj, cw_bg): pass-1 row spans, the TPU kernel's scan counts, the
    texture split and the staged column-window widths."""
    wh, ww = min(WIN_H, height), min(WIN_W, width)
    rot_o, inv_o = mode_envelope(spec, height, width)
    rot_o = min(rot_o, math.pi / 4)
    rot_b, inv_b = bg_envelope(spec)
    ts = texture_split(spec, height, width)
    if ts is None:
        raise ValueError(
            f"mode {spec.mode}'s motion envelope (inverse scale {inv_o:.2f})"
            f" does not fit the {SLAB_MARGIN}-px slab margin at any texture"
            f" sub-tiling of a {wh}x{ww} window"
        )
    P = resamp.max_row_span(wh // ts, ww // ts, rot_o + 1e-6, inv_o)
    PBG = resamp.max_row_span(wh, ww, rot_b + 1e-6, inv_b)
    xs, ys = _scan_counts(rot_o, inv_o, P, ww // ts)
    xsb, ysb = _scan_counts(rot_b, inv_b, PBG, ww)
    cwo = _col_span(rot_o, inv_o, ww // ts, P)
    cwb = _col_span(rot_b, inv_b, ww, PBG)
    return P, PBG, xs, ys, xsb, ysb, ts, cwo, cwb


def build_worklists(count, order, omi):
    """Painter-order (object, tile) unit lists per frame.

    Returns ``(worklist (B, 2*K*MAX_TILES) int32, n_units (B, 2) int32)``
    with entries ``k * MAX_TILES + t``: every painter position ``< count``
    whose frame OMI_ON flag is set, tiles ``0..nty*ntx-1`` in row-major
    order, valid units first (stable)."""
    B, K = order.shape
    dev = order.device
    t = torch.arange(MAX_TILES, device=dev)
    jidx = torch.arange(K, device=dev)
    ordl = order.long()
    wls, nws = [], []
    for f in (0, 1):
        om = omi[:, :, f]                                     # (B, K, 16)
        on = torch.gather(om[..., OMI_ON], 1, ordl) != 0
        nt = torch.gather(om[..., OMI_NTY] * om[..., OMI_NTX], 1, ordl)
        valid = (
            (jidx[None, :, None] < count[:, None, None])
            & on[..., None]
            & (t[None, None, :] < nt[..., None])
        ).reshape(B, -1)
        val = (ordl[..., None] * MAX_TILES + t).reshape(B, -1)
        pos = torch.argsort((~valid).to(torch.int8), dim=1, stable=True)
        wls.append(torch.gather(val, 1, pos))
        nws.append(valid.sum(1))
    wl = torch.cat(wls, dim=1).to(torch.int32)
    nw = torch.stack(nws, dim=1).to(torch.int32)
    return wl, nw


def scene_render(bg_meta, omi, omf, tmi, tmf, bgm, edges, slabs, bgslabs,
                 worklist, n_units, warp_aux=None, bgaux=None, bg_band=None,
                 *, spec_key, use_aa=True, bg_only=False, inverse_flow=False,
                 emit_masks=False):
    """Render a batch of scenes. Inputs (built by
    ``compose/fused.py:scene_tables``): ``bg_meta`` (B,3) [bg texture, bg
    warp flag, bg warp slot], ``omi`` (B,K,2,OMI_SIZE) i32, ``omf``
    (B,K,2,OMF_SIZE) f32, ``tmi`` (B,K,2,MAX_TILES,TMI_SIZE) i32, ``tmf``
    the same in f32, ``bgm`` (B,BGM_SIZE) f32, ``edges`` (B,K,2,4,EP) f32,
    ``slabs`` (T or 2T,SHs,SWs) i32 and ``bgslabs`` (T,SHb,SWb) i32 packed
    slabs, and the painter-order work lists of :func:`build_worklists`.
    Mode 9 passes the bank's warp planes ``warp_aux`` (N,4,H,W) and
    ``bgaux`` (N,2,H+2*BG_EY,W) and the bands :func:`bg_band_starts` derives
    from ``bgaux`` (the fields of ``compose/render.py:WarpAux``, built by
    ``warpfields/generator.py:make_bank_and_aux``).
    ``spec_key`` = (P, PBG, xs, ys, xsb, ysb, tsplit, cw_obj, cw_bg, H, W).
    ``bg_only`` renders the backgrounds and the flow init only;
    ``inverse_flow`` adds the frame-1 flow planes, ``emit_masks`` the id
    images.

    CUDA tensors launch the scene kernel (once per call, counted in
    ``scene_render.launches``); CPU tensors run :func:`scene_render_plain`.
    Returns (frames (B,2,H,W) int32 packed RGB, flow (B,2 or 4,H,W) f32,
    ids (B,2,H,W) int32 or None)."""
    with span("flowgen.scene_kernel"):
        if spec_key[6] > 1 and warp_aux is not None:
            raise ValueError("scene_render: texture sub-windows (tsplit > 1) "
                             "do not combine with the warp branch")
        if warp_aux is not None:
            _check_warp_planes(warp_aux, bgaux, spec_key[-2], spec_key[-1])
        kw = dict(spec_key=spec_key, use_aa=use_aa, bg_only=bg_only,
                  inverse_flow=inverse_flow, emit_masks=emit_masks)
        if slabs.device.type == "cpu":
            return scene_render_plain(
                bg_meta, omi, omf, tmi, tmf, bgm, edges, slabs, bgslabs,
                worklist, n_units, warp_aux, bgaux, bg_band, **kw)
        if slabs.device.type != "cuda":
            raise ValueError(
                f"scene_render: unsupported device {slabs.device}")
        return _scene_render_cuda(
            bg_meta, omi, omf, tmi, tmf, bgm, edges, slabs, bgslabs, worklist,
            n_units, warp_aux, bgaux, bg_band, **kw)


def _check_warp_planes(warp_aux, bgaux, H, W):
    N = warp_aux.shape[0]
    if tuple(warp_aux.shape) != (N, 4, H, W) or tuple(bgaux.shape) != (
            N, 2, H + 2 * BG_EY, W):
        raise ValueError(
            f"scene_render: warp planes {tuple(warp_aux.shape)} and "
            f"{tuple(bgaux.shape)} do not fit frames of {H}x{W}")


def bg_band_starts(bgaux):
    """The band the JAX kernel's background warp scans in pass 1
    (``_banded_tap_pair``, 4 tiles of 128 lanes from the tile of a block's
    smallest left tap): its first tile for every (bank slot, static
    background tile, 128-lane tile of it), int32 (N, n_bg_tiles, ww // 128),
    for background planes ``bgaux`` (N, 2, H + 2*BG_EY, W). A block is the
    tile's whB displaced rows by 128 lanes; its taps depend only on the
    slot's gdisp, so the bank producer derives the bands once per epoch and
    the kernel reads them."""
    H, W = bgaux.shape[2] - 2 * BG_EY, bgaux.shape[3]
    wh, ww = min(WIN_H, H), min(WIN_W, W)
    geo = _warp_geometry(H, W)
    whB, WB = geo["whB"], geo["WB"]
    n_src = WB // 128
    nscan = min(4, n_src)
    N = bgaux.shape[0]
    xs = torch.arange(ww, dtype=torch.float32, device=bgaux.device)
    out = []
    for (y0s, x0s) in _bg_tiles(H, W, wh, ww):
        u = (xs + float(x0s) + bgaux[:, 0, y0s : y0s + whB, x0s : x0s + ww]
             ) - float(-BG_EX)
        u0 = torch.floor(torch.clamp(u, 0.0, float(WB - 1))).to(torch.int32)
        m = u0.reshape(N, whB, ww // 128, 128).amin(dim=(1, 3))
        out.append(torch.clamp(torch.clamp(m >> 7, max=n_src - nscan), min=0))
    return torch.stack(out, dim=1).to(torch.int32).contiguous()


scene_render.launches = 0


def _scene_render_cuda(bg_meta, omi, omf, tmi, tmf, bgm, edges, slabs,
                       bgslabs, worklist, n_units, warp_aux, bgaux, bg_band, *,
                       spec_key, use_aa, bg_only, inverse_flow, emit_masks):
    from ._build import load_scene_library

    P, PBG, xs, ys, xsb, ysb, tsplit, cwo, cwb, H, W = spec_key
    B, K = omi.shape[0], omi.shape[1]
    EP = edges.shape[-1]
    dev = slabs.device
    ins = {
        "worklist": (worklist, torch.int32, (B, 2 * K * MAX_TILES)),
        "n_units": (n_units, torch.int32, (B, 2)),
        "bg_meta": (bg_meta, torch.int32, (B, 3)),
        "omi": (omi, torch.int32, (B, K, 2, OMI_SIZE)),
        "omf": (omf, torch.float32, (B, K, 2, OMF_SIZE)),
        "tmi": (tmi, torch.int32, (B, K, 2, MAX_TILES, TMI_SIZE)),
        "tmf": (tmf, torch.float32, (B, K, 2, MAX_TILES, TMF_SIZE)),
        "bgm": (bgm, torch.float32, (B, BGM_SIZE)),
        "edges": (edges, torch.float32, (B, K, 2, 4, EP)),
        "slabs": (slabs, torch.int32, None),
        "bgslabs": (bgslabs, torch.int32, None),
    }
    has_warp = warp_aux is not None
    if has_warp:
        if bg_band is None:
            raise ValueError("scene_render: mode 9 needs bg_band "
                             "(bg_band_starts of bgaux)")
        n_bg = len(_bg_tiles(H, W, min(WIN_H, H), min(WIN_W, W)))
        ins["warp_aux"] = (warp_aux, torch.float32, None)
        ins["bgaux"] = (bgaux, torch.float32, None)
        ins["bg_band"] = (bg_band, torch.int32, (
            warp_aux.shape[0], n_bg, min(WIN_W, W) // 128))
    args = {}
    for name, (t, dt, shape) in ins.items():
        if t.device != dev or t.dtype != dt:
            raise ValueError(f"scene_render: {name} must be {dt} on {dev}")
        if shape is not None and tuple(t.shape) != shape:
            raise ValueError(
                f"scene_render: {name} has shape {tuple(t.shape)}, want {shape}"
            )
        if not t.is_contiguous():
            raise ValueError(f"scene_render: {name} must be contiguous")
        args[name] = t
    if slabs.dim() != 3 or bgslabs.dim() != 3:
        raise ValueError("scene_render: slabs must be (T, SH, SW)")
    T, SHs, SWs = slabs.shape
    Tb, SHb, SWb = bgslabs.shape
    if H % 8 or W % 128 or EP < 7 * 120:
        raise ValueError("scene_render: frame dims must be multiples of (8, 128)")
    if tsplit not in (1, 2):
        raise ValueError(f"scene_render: unsupported texture split {tsplit}")
    frames = torch.empty((B, 2, H, W), dtype=torch.int32, device=dev)
    flow = torch.empty((B, 4 if inverse_flow else 2, H, W),
                       dtype=torch.float32, device=dev)
    ids = (torch.empty((B, 2, H, W), dtype=torch.int32, device=dev)
           if emit_masks else None)
    lib = load_scene_library()
    ptr = lambda t: ctypes.c_void_p(0 if t is None else t.data_ptr())
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.flowgen_scene_render(
        ptr(args["worklist"]), ptr(args["n_units"]), ptr(args["bg_meta"]),
        ptr(args["omi"]), ptr(args["omf"]), ptr(args["tmi"]),
        ptr(args["tmf"]), ptr(args["bgm"]), ptr(args["edges"]),
        ptr(args["slabs"]), ptr(args["bgslabs"]), ptr(warp_aux), ptr(bgaux),
        ptr(bg_band), ptr(frames), ptr(flow), ptr(ids),
        B, K, EP, H, W, T, SHs, SWs, Tb, SHb, SWb, P, PBG,
        min(cwo, SWs), min(cwb, SWb), xs, ys, xsb, ysb, tsplit,
        int(has_warp), int(bool(use_aa)), int(bool(bg_only)),
        int(bool(inverse_flow)), int(bool(emit_masks)),
        ctypes.c_void_p(stream),
    )
    if err != 0:
        raise RuntimeError(f"scene kernel launch failed: CUDA error {err}")
    scene_render.launches += 1
    return frames, flow, ids


# ---------------------------------------------------------------------------
# Plain PyTorch version
# ---------------------------------------------------------------------------

F32 = np.float32


def _pack3(r, g, b):
    return (
        (r.to(torch.int32) << 16) | (g.to(torch.int32) << 8) | b.to(torch.int32)
    )


def _bg_tiles(H, W, wh, ww):
    return [
        (min(ty * wh, H - wh), min(tx * ww, W - ww))
        for ty in range(-(-H // wh))
        for tx in range(-(-W // ww))
    ]


def _poly_area(er, base, ne, oy, ox, gh, gw, dev):
    """Exact-area accumulation of edge slots [base, base+ne) over a (gh, gw)
    window at frame origin (oy, ox): each edge visits only the 8-row blocks
    its y-span touches, edges left of the window are skipped, and
    contributions are added in edge order (the JAX kernel's
    ``_area_accumulate_blocked``)."""
    area = torch.zeros((gh, gw), dtype=torch.float32, device=dev)
    oyf, oxf = F32(oy), F32(ox)
    xlo = torch.arange(gw, dtype=torch.float32, device=dev) + float(oxf)
    nb = gh // 8
    for e in range(ne):
        ax, ay, bx, by = (F32(er[r][base + e]) for r in range(4))
        dx = bx - ax
        dy = by - ay
        inv_dy = F32(1.0) / dy if abs(dy) > F32(1e-12) else F32(0.0)
        inv_dx = F32(1.0) / dx if abs(dx) > F32(1e-12) else F32(0.0)
        rlo = int(np.floor(min(ay, by) - oyf)) - 1
        rhi = int(np.floor(max(ay, by) - oyf))
        rb0 = min(max(rlo, 0), gh) >> 3
        rb1 = (min(max(rhi, -1), gh - 1) >> 3) + 1
        rb1 = min(rb1, nb)
        if not max(ax, bx) >= oxf or rb0 >= rb1:
            continue
        s0 = (xlo - float(ax)) * float(inv_dx)
        s1 = (xlo + 1.0 - float(ax)) * float(inv_dx)
        smin = torch.minimum(s0, s1)[None]
        smax = torch.maximum(s0, s1)[None]
        hmid = (float(ax) - xlo)[None]
        hdx = float(F32(0.5) * dx)
        r0_, r1_ = rb0 * 8, rb1 * 8
        ylo = (torch.arange(r0_, r1_, dtype=torch.float32, device=dev)
               + float(oyf))[:, None]
        r0 = (ylo - float(ay)) * float(inv_dy)
        r1 = (ylo + 1.0 - float(ay)) * float(inv_dy)
        ta = torch.clamp(torch.minimum(r0, r1), 0.0, 1.0)
        tb = torch.clamp(torch.maximum(r0, r1), 0.0, 1.0)
        xta = float(ax) + ta * float(dx)
        xtb = float(ax) + tb * float(dx)
        p = torch.minimum(torch.maximum(smin, ta), tb)
        q = torch.minimum(torch.maximum(smax, ta), tb)
        ga = torch.clamp(xta - xlo, 0.0, 1.0)
        gb = torch.clamp(xtb - xlo, 0.0, 1.0)
        mid = hmid + (p + q) * hdx
        integral = ga * (p - ta) + mid * (q - p) + gb * (tb - q)
        area[r0_:r1_] = area[r0_:r1_] + float(dy) * integral
    return area


def _ellipse_area(of, c, oy, ox, gh, gw, dev):
    """Chord coverage of ellipse primitive c over the 8-row blocks of a
    (gh, gw) window within its screen y-extent +- ELL_CULL_M, as
    ``aa + 2 * inside`` (zero elsewhere)."""
    from .raster import ellipse_chord_coverage

    area = torch.zeros((gh, gw), dtype=torch.float32, device=dev)
    base = OMF_ELL + c * 8
    i00, i01, i02, i10, i11, i12, rx_e, ry_e = (F32(of[base + j]) for j in range(8))
    oyf, oxf = F32(oy), F32(ox)
    ymn = F32(of[OMF_EXT + 2 * c]) - F32(ELL_CULL_M)
    ymx = F32(of[OMF_EXT + 2 * c + 1]) + F32(ELL_CULL_M)
    rb0 = min(max(int(np.floor(ymn - oyf)) - 1, 0), gh) >> 3
    rb1 = (min(max(int(np.floor(ymx - oyf)), -1), gh - 1) >> 3) + 1
    rb1 = min(rb1, gh // 8)
    if rb0 >= rb1:
        return area
    r0_, r1_ = rb0 * 8, rb1 * 8
    cx = (torch.arange(gw, dtype=torch.float32, device=dev)
          + float(oxf + F32(0.5)))[None, :]
    cy = (torch.arange(r0_, r1_, dtype=torch.float32, device=dev)
          + float(oyf + F32(0.5)))[:, None]
    ux = div(float(i00) * cx + float(i01) * cy + float(i02), float(rx_e))
    uy = div(float(i10) * cx + float(i11) * cy + float(i12), float(ry_e))
    aa, ins = ellipse_chord_coverage(
        ux, uy, float(i00 / rx_e), float(i01 / rx_e), float(i10 / ry_e),
        float(i11 / ry_e),
    )
    area[r0_:r1_] = aa + torch.where(ins, 2.0, 0.0)
    return area


def _coverage_window(er, om, of, oy, ox, gh, gw, dev):
    """Composite coverage (aa, binary as 0/1 float) over a (gh, gw) window:
    per-primitive exact area, then the screen algebra in primitive order."""
    aa_acc = torch.zeros((gh, gw), dtype=torch.float32, device=dev)
    in_acc = torch.zeros_like(aa_acc)
    add_bits = int(om[OMI_ADD_BITS])
    poly_bits = int(om[OMI_POLY_BITS])
    for c in range(int(om[OMI_NPRIMS])):
        if (poly_bits >> c) & 1:
            area = _poly_area(er, c * 120, int(om[OMI_NEDGES + c]), oy, ox,
                              gh, gw, dev).abs()
            area_ref = torch.clamp(area, max=1.0) + torch.where(
                area >= 0.5, 2.0, 0.0
            )
        else:
            area_ref = _ellipse_area(of, c, oy, ox, gh, gw, dev)
        aa = area_ref - torch.where(area_ref >= 2.0, 2.0, 0.0)
        ins = (area_ref >= 2.0).to(torch.float32)
        if (add_bits >> c) & 1:
            aa_acc = 1.0 - (1.0 - aa_acc) * (1.0 - aa)
            in_acc = torch.maximum(in_acc, ins)
        else:
            aa_acc = aa_acc * (1.0 - aa)
            in_acc = in_acc * (1.0 - ins)
    return aa_acc, in_acc


def _warp_geometry(H, W):
    """Static mode-9 window geometry (the JAX kernel's): expanded-window
    size, its texture sub-tile origins, the background's extended grid
    and its tiles."""
    wh, ww = min(WIN_H, H), min(WIN_W, W)
    whE = min(wh + 2 * WARP_EY, H)
    wwE = min(ww + 2 * WARP_EX, W)
    HB, WB = H + 2 * BG_EY, W + 2 * BG_EX
    whB = min(wh + 2 * BG_EY, HB)
    ext_tiles = [
        (min(-BG_EY + ty * wh, H + BG_EY - wh),
         min(-BG_EX + tx * ww, W + BG_EX - ww))
        for ty in range(-(-HB // wh))
        for tx in range(-(-WB // ww))
    ]
    return {
        "whE": whE, "wwE": wwE, "HB": HB, "WB": WB, "whB": whB,
        "LYS": [0] if whE == wh else [0, whE - wh],
        "LXS": [0] if wwE == ww else [0, wwE - ww],
        "ext_tiles": ext_tiles,
        # Width of the JAX kernel's transposed packed-RGB scratch, shared by
        # the object and background warps.
        "rgb_lanes": max(_round_up(whE, 128), _round_up(whB, 128)),
    }


def _two_pass_split(mm):
    m00, m01, m02, m10, m11, m12 = (F32(v) for v in mm)
    B_ = m01 / m11
    return (m00 - B_ * m10, B_, m02 - B_ * m12, m10, m11, m12)


def _window_grid(y0, x0, wh, ww, dev):
    py = (torch.arange(wh, device=dev) + y0).to(torch.float32)[:, None]
    px = (torch.arange(ww, device=dev) + x0).to(torch.float32)[None, :]
    return px.expand(wh, ww), py.expand(wh, ww)


def scene_render_plain(bg_meta, omi, omf, tmi, tmf, bgm, edges, slabs,
                       bgslabs, worklist, n_units, warp_aux=None, bgaux=None,
                       bg_band=None, *, spec_key, use_aa=True, bg_only=False,
                       inverse_flow=False, emit_masks=False):
    """Plain PyTorch restatement of the scene kernel on any device: per
    sample, the background window tiles in static order, then each frame's
    work units in painter's order on (wh, ww) windows with ownership masks;
    with ``tsplit`` > 1 a frame-1 texture is resampled over ``tsplit x
    tsplit`` sub-windows, each folded at its own centre. Mode 9
    (``warp_aux`` given) follows the JAX kernel's warp branch literally:
    staged passes, expanded windows, banded taps. Same inputs and outputs as
    :func:`scene_render`; the kernel's precomputed ``bg_band`` is not read,
    as the staged passes find their bands themselves."""
    P, PBG, xs, ys, xsb, ysb, tsplit, cwo, cwb, H, W = spec_key
    has_warp = warp_aux is not None
    dev = slabs.device
    B, K = omi.shape[0], omi.shape[1]
    wh, ww = min(WIN_H, H), min(WIN_W, W)
    MAXW = K * MAX_TILES
    Pp = _round_up(max(P, PBG), 128)
    geo = _warp_geometry(H, W)
    tabs = [t.detach().cpu().numpy() for t in
            (bg_meta, omi, omf, tmi, tmf, bgm, worklist, n_units)]
    frames = torch.empty((B, 2, H, W), dtype=torch.int32, device=dev)
    flow = torch.empty((B, 4 if inverse_flow else 2, H, W),
                       dtype=torch.float32, device=dev)
    ids = (torch.empty((B, 2, H, W), dtype=torch.int32, device=dev)
           if emit_masks else None)
    pyF = torch.arange(H, dtype=torch.float32, device=dev)[:, None].expand(H, W)
    pxF = torch.arange(W, dtype=torch.float32, device=dev)[None, :].expand(H, W)
    py_w = torch.arange(wh, device=dev)[:, None]
    px_w = torch.arange(ww, device=dev)[None, :]

    def sample_plane(slot, ch, coeffs, y0, x0, xsc, ysc):
        # sample_plane_affine: warp plane ch of bank slot through an
        # output -> plane affine, min(P, H) staged rows.
        PF = min(P, H)
        w0 = resamp.pass1_row_start(coeffs, x0, y0, wh, ww, PF, H)
        rows = warp_aux[slot, ch, w0 : w0 + PF, :W]
        return resamp.resample_rows_f32(rows, w0, coeffs, x0, y0, wh, ww,
                                        xsc, ysc, Pp)

    def bg_window(bgm_b, btid, frame, oy, ox):
        base = BGM_T0 if frame == 0 else BGM_T1
        coeffs = resamp.fold_coeffs_scalar(
            bgm_b[base : base + 6], ox + ww / 2.0, oy + wh / 2.0,
            bgm_b[BGM_SRCW], bgm_b[BGM_SRCH], float(SLAB_MARGIN),
        )
        r, g, bl = resamp.two_pass_window(bgslabs[btid], coeffs, ox, oy, wh,
                                          ww, PBG, cwb)
        return _pack3(torch.round(r), torch.round(g), torch.round(bl))

    for b in range(B):
        bgmeta_b, omi_b, omf_b, tmi_b, tmf_b, bgm_b, wl_b, nw_b = (
            t[b] for t in tabs
        )
        btid = int(bgmeta_b[0])
        bg_warp = has_warp and int(bgmeta_b[1]) != 0
        bslot = int(bgmeta_b[2])
        accs = []
        for frame in (0, 1):
            acc = torch.empty((H, W), dtype=torch.int32, device=dev)
            if frame == 1 and bg_warp:
                # Plain frame 1 on the extended grid, then displaced per
                # output tile through the x2-upscaled field's planes.
                work = torch.zeros((geo["HB"], geo["WB"]), dtype=torch.int32,
                                   device=dev)
                for (eys, exs) in geo["ext_tiles"]:
                    work[eys + BG_EY : eys + BG_EY + wh,
                         exs + BG_EX : exs + BG_EX + ww] = bg_window(
                             bgm_b, btid, 1, eys, exs)
                whB = geo["whB"]
                for (y0s, x0s) in _bg_tiles(H, W, wh, ww):
                    gd = bgaux[bslot, 0, y0s : y0s + whB, x0s : x0s + ww]
                    vd = bgaux[bslot, 1, y0s + BG_EY : y0s + BG_EY + wh,
                               x0s : x0s + ww]
                    r, g, bl = resamp.displace_warp_rgb(
                        work[y0s : y0s + whB], gd, vd, x0s, y0s, -BG_EX,
                        y0s - BG_EY, wh, ww, whB, geo["WB"], geo["rgb_lanes"],
                        x_scan=4, y_scan=4,
                    )
                    acc[y0s : y0s + wh, x0s : x0s + ww] = _pack3(
                        torch.round(r), torch.round(g), torch.round(bl))
            else:
                for (y0s, x0s) in _bg_tiles(H, W, wh, ww):
                    acc[y0s : y0s + wh, x0s : x0s + ww] = bg_window(
                        bgm_b, btid, frame, y0s, x0s)
            accs.append(acc)
        planes = []
        for base_m in (BGM_PIX, BGM_IPIX) if inverse_flow else (BGM_PIX,):
            mq = [float(F32(v)) for v in bgm_b[base_m : base_m + 6]]
            planes += [(mq[0] * pxF + mq[1] * pyF + mq[2]) - pxF,
                       (mq[3] * pxF + mq[4] * pyF + mq[5]) - pyF]
        flw = torch.stack(planes)
        m = [float(F32(v)) for v in bgm_b[BGM_PIX : BGM_PIX + 6]]
        idb = torch.full((2, H, W), BG_ID, dtype=torch.int32, device=dev)
        if bg_warp:
            # Forward-field flow at the moved positions, x2 magnitude, where
            # they land inside the 2W x 2H big texture.
            faff = _two_pass_split(bgm_b[BGM_FAFF : BGM_FAFF + 6])
            for (y0s, x0s) in _bg_tiles(H, W, wh, ww):
                px, py = _window_grid(y0s, x0s, wh, ww, dev)
                mvx = m[0] * px + m[1] * py + m[2] + (W / 2.0)
                mvy = m[3] * px + m[4] * py + m[5] + (H / 2.0)
                inb = ((mvx >= 0) & (mvx < 2.0 * W) & (mvy >= 0)
                       & (mvy < 2.0 * H)).to(torch.float32)
                for ch in (0, 1):
                    wf = sample_plane(bslot, 2 + ch, faff, y0s, x0s, xsb, ysb)
                    win = flw[ch, y0s : y0s + wh, x0s : x0s + ww]
                    flw[ch, y0s : y0s + wh, x0s : x0s + ww] = (
                        win + 2.0 * wf * inb)
        if not bg_only:
            for frame in (0, 1):
                acc = accs[frame]
                for j in range(int(nw_b[frame])):
                    u = int(wl_b[frame * MAXW + j])
                    k, t = u // MAX_TILES, u % MAX_TILES
                    tm = tmi_b[k, frame, t]
                    y0, x0 = int(tm[TMI_Y0]) & ~7, int(tm[TMI_X0]) & ~127
                    om, of = omi_b[k, frame], omf_b[k, frame]
                    er = edges[b, k, frame].detach().cpu().numpy()
                    warping = has_warp and int(om[OMI_WARP]) != 0
                    slot = int(om[OMI_SLOT])
                    pyi, pxi = py_w + y0, px_w + x0
                    own = (
                        (pyi >= int(tm[TMI_OY0])) & (pyi < int(tm[TMI_OY1]))
                        & (pxi >= int(tm[TMI_OX0])) & (pxi < int(tm[TMI_OX1]))
                    ).to(torch.float32)
                    tid = int(om[OMI_TEX])
                    if frame == 1 and warping:
                        mm, tex, inw = _warp_unit(
                            er, om, of, slabs[tid], warp_aux[slot], y0, x0,
                            use_aa, P, cwo, H, W, geo, dev)
                        mm, mi = mm * own, inw * own
                    else:
                        cov_aa, cov_in = _coverage_window(
                            er, om, of, y0, x0, wh, ww, dev
                        )
                        mm = (cov_aa if use_aa else cov_in) * own
                        mi = cov_in * own
                        if frame == 0:
                            sy = (SLAB_MARGIN + y0) & ~7
                            sx = (SLAB_MARGIN + x0) & ~127
                            tex = resamp.unpack_rgb(
                                slabs[tid, sy : sy + wh, sx : sx + ww]
                            )
                        elif tsplit == 1:
                            tex = resamp.two_pass_window(
                                slabs[tid], tmf_b[k, 1, t, :6], x0, y0, wh,
                                ww, P, cwo,
                            )
                        else:
                            tex = _split_texture(slabs[tid], of, x0, y0, wh,
                                                 ww, tsplit, P, cwo, dev)
                    win = acc[y0 : y0 + wh, x0 : x0 + ww]
                    out = [
                        torch.round(f * (1.0 - mm) + tc * mm)
                        for f, tc in zip(resamp.unpack_rgb(win), tex)
                    ]
                    acc[y0 : y0 + wh, x0 : x0 + ww] = _pack3(*out)
                    if emit_masks:
                        # The painter's id image: the object's slot where
                        # the binary mask times ownership is 1.
                        mid = mi.to(torch.int32)
                        old = idb[frame, y0 : y0 + wh, x0 : x0 + ww]
                        idb[frame, y0 : y0 + wh, x0 : x0 + ww] = (
                            (FG_ID_BASE + k) * mid + old * (1 - mid))
                    if frame == 0 or inverse_flow:
                        # Frame 1's OMF_MOTION is the inverse motion.
                        fi = 2 * frame
                        pxw, pyw = _window_grid(y0, x0, wh, ww, dev)
                        mo = [float(F32(v)) for v in of[OMF_MOTION : OMF_MOTION + 6]]
                        mvx = mo[0] * pxw + mo[1] * pyw + mo[2]
                        mvy = mo[3] * pxw + mo[4] * pyw + mo[5]
                        ofl = (mvx - pxw, mvy - pyw)
                        for ch in (0, 1):
                            w_ = flw[fi + ch, y0 : y0 + wh, x0 : x0 + ww]
                            flw[fi + ch, y0 : y0 + wh, x0 : x0 + ww] = (
                                ofl[ch] * mi + w_ * (1.0 - mi))
                        if frame == 0 and warping:
                            # + forward field at the moved positions, inside
                            # the frame, under the same mask.
                            inb = ((mvx >= 0) & (mvx < W) & (mvy >= 0)
                                   & (mvy < H)).to(torch.float32) * mi
                            co = _two_pass_split(of[OMF_MOTION : OMF_MOTION + 6])
                            for ch in (0, 1):
                                wf = sample_plane(slot, 2 + ch, co, y0, x0,
                                                  xs, ys)
                                flw[ch, y0 : y0 + wh, x0 : x0 + ww] = (
                                    flw[ch, y0 : y0 + wh, x0 : x0 + ww]
                                    + wf * inb)
        frames[b, 0] = accs[0]
        frames[b, 1] = accs[1]
        flow[b] = flw
        if emit_masks:
            ids[b] = idb
    return frames, flow, ids


def _split_texture(slab, of, x0, y0, wh, ww, tsplit, P, cwo, dev):
    """Frame-1 texture of a unit over ``tsplit x tsplit`` sub-windows (the
    JAX kernel's ``tex_dma_f1`` with ``tsplit > 1``): each sub-window folds
    the raw residual affine (OMF_RAW) at its own centre with the source's
    reflect periods (OMF_RAW + 6, + 7) and is resampled on its own. Returns
    the three (wh, ww) planes."""
    whs, wws = wh // tsplit, ww // tsplit
    raw = of[OMF_RAW : OMF_RAW + 6]
    planes = [torch.empty((wh, ww), dtype=torch.float32, device=dev)
              for _ in range(3)]
    for sy in range(tsplit):
        for sx in range(tsplit):
            oy, ox = y0 + sy * whs, x0 + sx * wws
            coeffs = resamp.fold_coeffs_scalar(
                raw, ox + wws / 2.0, oy + whs / 2.0, of[OMF_RAW + 6],
                of[OMF_RAW + 7], float(SLAB_MARGIN),
            )
            sub = resamp.two_pass_window(slab, coeffs, ox, oy, whs, wws, P,
                                         cwo)
            for pl_, s_ in zip(planes, sub):
                pl_[sy * whs : sy * whs + whs, sx * wws : sx * wws + wws] = s_
    return planes


def _warp_unit(er, om, of, slab, aux, y0, x0, use_aa, P, cwo, H, W, geo, dev):
    """Frame 1 of a deforming object's unit (the JAX kernel's warping
    branch): coverage and the affine-resampled texture on the expanded
    window, each texture sub-tile folded at its own centre and rounded to
    u8, then all three displaced through the unit's inverse-field planes.
    Returns the blend mask, the texture planes and the warped binary mask
    of the (wh, ww) window, before ownership."""
    wh, ww = min(WIN_H, H), min(WIN_W, W)
    whE, wwE = geo["whE"], geo["wwE"]
    ey0 = min(max(y0 - WARP_EY, 0), H - whE) & ~7
    ex0 = min(max(x0 - WARP_EX, 0), W - wwE)
    gd = aux[0, ey0 : ey0 + whE, x0 : x0 + ww]
    vd = aux[1, y0 : y0 + wh, x0 : x0 + ww]
    cov_aa, cov_in = _coverage_window(er, om, of, ey0, ex0, whE, wwE, dev)
    mm = of[OMF_MOTION : OMF_MOTION + 6]
    texE = torch.zeros((whE, wwE), dtype=torch.int32, device=dev)
    for ly in geo["LYS"]:
        for lx in geo["LXS"]:
            oy, ox = ey0 + ly, ex0 + lx
            coeffs = resamp.fold_coeffs_scalar(
                mm, ox + ww / 2.0, oy + wh / 2.0, float(W), float(H),
                float(SLAB_MARGIN),
            )
            r, g, b = resamp.two_pass_window(slab, coeffs, ox, oy, wh, ww, P,
                                             cwo)
            texE[ly : ly + wh, lx : lx + ww] = _pack3(
                torch.round(r), torch.round(g), torch.round(b))

    def disp(src):
        return resamp.displace_warp(src, gd, vd, x0, y0, ex0, ey0, wh, ww,
                                    whE, wwE)

    inw = (disp(cov_in) >= f32(IN_THR)).to(torch.float32)
    m = disp(cov_aa) if use_aa else inw
    tex = resamp.displace_warp_rgb(texE, gd, vd, x0, y0, ex0, ey0, wh, ww,
                                   whE, wwE, geo["rgb_lanes"])
    return m, tex, inw
