"""The windowed renderer's two kernels and their plain PyTorch versions (the
port's counterpart of ``flowgen/ops/pallas_raster.py``).

* ``object_window``, one object's whole window pass (coverage over at most
  C primitives with the composite screen algebra, ``round(f (1 - m) + t
  m)``, the flow overwrite under the binary mask), batched over windows of
  different samples -> ``csrc/window.cu:object_window_kernel`` (TPU kernel:
  ``pallas_raster.py:_make_object_window_kernel`` via
  ``object_window_pallas``);
* ``polygon_coverage``, exact-area coverage of one closed outline over an
  arbitrary sample grid, batched the same way ->
  ``csrc/window.cu:polygon_coverage_kernel`` (TPU kernel:
  ``pallas_raster.py:_kernel`` via ``polygon_coverage_pallas``).

A CUDA tensor launches the kernel (counted in ``<function>.launches``); a
CPU tensor runs the plain version. Inside ``with plain_versions():`` the
plain versions run on any device: the kernel-vs-plain comparisons on the
card use it. The plain versions restate the TPU kernels' arithmetic, not the
composed branch of the renderer: the dense edge loop summing edges
0..n_edges-1 in order, the kernel's ellipse form, the composite algebra with
an integer binary accumulator, the blend, and the flow written as
``ofx * mi + flow * (1 - mi)``.

Operands per window, in the JAX kernel's layout: ``edges`` (4, C*E) screen
endpoints rows [ax, ay, bx, by]; ``meta`` (3 + 3C) int32 [n_prims, x0, y0,
additive[C], is_poly[C], n_edges[C]]; ``fmeta`` (6 + 8C) float32 [motion
2x3, per primitive (ellipse inverse 2x3, rx, ry)]. The batched wrapper adds
``win`` (4) int32 [batch index, wh, ww, texture id].
"""

from __future__ import annotations

import contextlib
import ctypes
import math

import torch

from .._fp import div
from . import raster
from .scene import ELL_CULL_M
from .texture import sample_bilinear_quad_flat

WIN_B, WIN_H, WIN_W, WIN_TEX = range(4)

# The culls of csrc/coverage.cuh, which both window kernels use (the plain
# versions stay dense; tests/test_torch_cull.py and test_torch_tile_cull.py
# pin the facts they rest on): an edge's term is skipped for cell rows 2 px
# beyond its y-span and for cells 2 px right of it; object_window skips an
# ellipse no more than ELL_CULL_ANISO times longer than wide for cells
# ELL_CULL_M (ops/scene.py) + 1 px beyond its extent, in rows and in
# columns. The kernel takes ELL_CULL_M and ELL_CULL_ANISO from each launch.
ELL_CULL_ANISO = 4.0

_plain = False


@contextlib.contextmanager
def plain_versions():
    """Inside the block the window kernels' wrappers run their plain
    versions on any device (the kernel-vs-plain comparisons on the card)."""
    global _plain
    prev, _plain = _plain, True
    try:
        yield
    finally:
        _plain = prev


def _runs_plain(name, t) -> bool:
    if _plain or t.device.type == "cpu":
        return True
    if t.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {t.device}")
    return False


def _ptr(t):
    return ctypes.c_void_p(0 if t is None else t.data_ptr())


def _check(name, t, dtype, shape=None):
    if t.device.type != "cuda" or t.dtype != dtype or not t.is_contiguous():
        raise ValueError(f"{name}: expects a contiguous {dtype} CUDA tensor")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, want {tuple(shape)}")


def _stream(t):
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


# ---------------------------------------------------------------------------
# Exact-area accumulation (the dense _area_accumulate)
# ---------------------------------------------------------------------------


def _area_accumulate(ax, ay, bx, by, n_edges, cx, cy):
    """Signed cell area of edge slots 0..n_edges-1 at cell centres (cx, cy)
    (n, ...), summed in edge order. ``ax`` .. ``by`` (n, E) endpoints,
    ``n_edges`` (n,) int; a window's slots past its count add nothing."""
    n = cx.shape[0]
    lead = (n,) + (1,) * (cx.dim() - 1)
    xlo = cx - 0.5
    ylo = cy - 0.5
    area = torch.zeros_like(cx)
    zero = torch.zeros(lead, dtype=cx.dtype, device=cx.device)
    ne = n_edges.reshape(lead)
    for e in range(int(n_edges.max()) if n else 0):
        a_x, a_y = ax[:, e].reshape(lead), ay[:, e].reshape(lead)
        dx = bx[:, e].reshape(lead) - a_x
        dy = by[:, e].reshape(lead) - a_y
        inv_dy = torch.where(dy.abs() > raster._E12, div(1.0, dy), zero)
        inv_dx = torch.where(dx.abs() > raster._E12, div(1.0, dx), zero)
        r0 = (ylo - a_y) * inv_dy
        r1 = (ylo + 1.0 - a_y) * inv_dy
        ta = torch.clamp(torch.minimum(r0, r1), 0.0, 1.0)
        tb = torch.clamp(torch.maximum(r0, r1), 0.0, 1.0)
        s0 = (xlo - a_x) * inv_dx
        s1 = (xlo + 1.0 - a_x) * inv_dx
        p = raster._clip(torch.minimum(s0, s1), ta, tb)
        q = raster._clip(torch.maximum(s0, s1), ta, tb)
        ga = torch.clamp(a_x + ta * dx - xlo, 0.0, 1.0)
        gb = torch.clamp(a_x + tb * dx - xlo, 0.0, 1.0)
        mid = (a_x - xlo) + (p + q) * (0.5 * dx)
        integral = ga * (p - ta) + mid * (q - p) + gb * (tb - q)
        area = torch.where(e < ne, area + dy * integral, area)
    return area


# ---------------------------------------------------------------------------
# polygon_coverage
# ---------------------------------------------------------------------------


def _closed_edges(edge_pts, n_edges):
    """(n, 4, E) edge table of outlines (n, E, 2) whose edge n_edges-1 is
    forced back to point 0 (``polygon_coverage_pallas``; the CUDA kernel
    closes the outline itself)."""
    E = edge_pts.shape[-2]
    b = torch.roll(edge_pts, -1, dims=-2)
    last = torch.arange(E, device=edge_pts.device)[None, :] == (
        n_edges.to(torch.int64)[:, None] - 1)
    bx = torch.where(last, edge_pts[:, :1, 0], b[..., 0])
    by = torch.where(last, edge_pts[:, :1, 1], b[..., 1])
    return torch.stack([edge_pts[..., 0], edge_pts[..., 1], bx, by], dim=1)


def polygon_coverage_plain(edge_pts, n_edges, px, py):
    """The plain version: ``(aa, inside)`` of closed outlines ``edge_pts``
    (n, E, 2), the first ``n_edges`` (n,) points real, over sample grids
    ``px``/``py`` (n, ...). Unbatched (E, 2) / scalar / grid calls are
    accepted as in ``polygon_coverage_pallas``."""
    single = edge_pts.dim() == 2
    if single:
        edge_pts, px, py = edge_pts[None], px[None], py[None]
    n_edges = torch.as_tensor(n_edges, device=edge_pts.device).reshape(-1)
    e = _closed_edges(edge_pts.to(torch.float32), n_edges)
    area = _area_accumulate(e[:, 0], e[:, 1], e[:, 2], e[:, 3], n_edges,
                            px, py).abs()
    aa, inside = torch.minimum(area, torch.ones_like(area)), area >= 0.5
    return (aa[0], inside[0]) if single else (aa, inside)


def polygon_coverage(edge_pts, n_edges, px, py):
    """Exact-area ``(aa, inside)`` of closed outlines ``edge_pts`` (n, E, 2)
    with ``n_edges`` (n,) real points over sample grids ``px``/``py`` (n, h,
    w). CUDA tensors launch ``polygon_coverage_kernel`` (counted in
    ``polygon_coverage.launches``); CPU tensors run the plain version."""
    if _runs_plain("polygon_coverage", px):
        return polygon_coverage_plain(edge_pts, n_edges, px, py)
    return _polygon_coverage_cuda(edge_pts, n_edges, px, py)


def _polygon_coverage_cuda(edge_pts, n_edges, px, py):
    """Launch ``polygon_coverage_kernel``, which closes the outlines itself:
    contiguous float32 points (n, E, 2), int32 ``n_edges`` (n,) and float32
    grids (n, ...) alike, all on one card, or it raises. Launches nothing
    else but the outputs' allocations; the grids' last axis is the kernel's
    row."""
    from ._build import load_window_library

    n, E = edge_pts.shape[0], edge_pts.shape[1]
    _check("polygon_coverage: edge_pts", edge_pts, torch.float32, (n, E, 2))
    _check("polygon_coverage: n_edges", n_edges, torch.int32, (n,))
    _check("polygon_coverage: px", px, torch.float32)
    _check("polygon_coverage: py", py, torch.float32, px.shape)
    if px.shape[0] != n:
        raise ValueError("polygon_coverage: grids must be (n, ...) alike")
    w = px.shape[-1] if px.dim() > 1 else 1
    h = math.prod(px.shape[1:]) // max(w, 1)
    aa = torch.empty_like(px)
    inside = torch.empty(px.shape, dtype=torch.bool, device=px.device)
    err = load_window_library().flowgen_polygon_coverage(
        _ptr(edge_pts), _ptr(n_edges), _ptr(px), _ptr(py), _ptr(aa),
        _ptr(inside), n, E, h, w, _stream(px))
    if err != 0:
        raise RuntimeError(f"polygon_coverage kernel launch failed: CUDA error {err}")
    polygon_coverage.launches += 1
    return aa, inside


polygon_coverage.launches = 0


# ---------------------------------------------------------------------------
# object_window
# ---------------------------------------------------------------------------


def _window_coverage(edges, meta, fmeta, px, py):
    """Composite (aa, binary 0/1 int32) of each window's primitives over its
    integer pixel grid (n, wh, ww), in the TPU kernel's arithmetic."""
    C = (meta.shape[-1] - 3) // 3
    E = edges.shape[-1] // C
    n = px.shape[0]
    lead = (n, 1, 1)
    cx = px + 0.5
    cy = py + 0.5
    acc_aa = torch.zeros_like(px)
    acc_in = torch.zeros(px.shape, dtype=torch.int32, device=px.device)
    n_prims = meta[:, 0]
    ed = edges.reshape(n, 4, C, E)
    for c in range(int(n_prims.max()) if n else 0):
        live = c < n_prims
        poly = meta[:, 3 + C + c] != 0
        # Each window evaluates its slot's own kind: a polygon's edges (none
        # for an ellipse slot) or the ellipse.
        n_edges = torch.where(live & poly, meta[:, 3 + 2 * C + c], 0)
        area = _area_accumulate(ed[:, 0, c], ed[:, 1, c], ed[:, 2, c],
                                ed[:, 3, c], n_edges, cx, cy).abs()
        aa = torch.minimum(area, torch.ones_like(area))
        ins = area >= 0.5
        if bool((live & ~poly).any()):
            f = [fmeta[:, 6 + c * 8 + i].reshape(lead) for i in range(8)]
            i00, i01, i02, i10, i11, i12, rx_e, ry_e = f
            ux = div(i00 * cx + i01 * cy + i02, rx_e)
            uy = div(i10 * cx + i11 * cy + i12, ry_e)
            aa_e, in_e = raster.ellipse_chord_coverage(
                ux, uy, div(i00, rx_e), div(i01, rx_e), div(i10, ry_e),
                div(i11, ry_e))
            aa = torch.where(poly.reshape(lead), aa, aa_e)
            ins = torch.where(poly.reshape(lead), ins, in_e)
        ins = ins.to(torch.int32)
        live = live.reshape(lead)
        additive = (meta[:, 3 + c] != 0).reshape(lead)
        a_aa = 1.0 - (1.0 - acc_aa) * (1.0 - aa)
        a_in = torch.maximum(acc_in, ins)
        s_aa = acc_aa * (1.0 - aa)
        s_in = acc_in * (1 - ins)
        acc_aa = torch.where(live, torch.where(additive, a_aa, s_aa), acc_aa)
        acc_in = torch.where(live, torch.where(additive, a_in, s_in), acc_in)
    return acc_aa, acc_in


def window_grids(y0, x0, wh, ww):
    """Integer pixel grids (px, py) (n, wh, ww) of windows at origins
    (``y0``, ``x0``) (n,) (the JAX renderer's ``_window_grids``)."""
    dev = x0.device
    xs = torch.arange(ww, dtype=torch.float32, device=dev)
    ys = torch.arange(wh, dtype=torch.float32, device=dev)
    n = x0.shape[0]
    px = xs[None, None, :] + x0.to(torch.float32)[:, None, None]
    py = ys[None, :, None] + y0.to(torch.float32)[:, None, None]
    return px.expand(n, wh, ww), py.expand(n, wh, ww)


def object_window_plain(edges, meta, fmeta, tex_w, frame_w, flow_w, *,
                        use_aa=True, emit_flow=True):
    """The plain version, in ``object_window_pallas``'s signature: windows
    ``tex_w`` / ``frame_w`` (n, wh, ww, 3) and ``flow_w`` (n, wh, ww, 2)
    with their tables ``edges`` (n, 4, C*E), ``meta`` (n, 3 + 3C), ``fmeta``
    (n, 6 + 8C); an unbatched window is accepted too. Returns (blended
    frame, updated flow)."""
    single = frame_w.dim() == 3
    if single:
        edges, meta, fmeta, tex_w, frame_w, flow_w = (
            t[None] for t in (edges, meta, fmeta, tex_w, frame_w, flow_w))
    n, wh, ww = frame_w.shape[:3]
    px, py = window_grids(meta[:, 2], meta[:, 1], wh, ww)
    acc_aa, acc_in = _window_coverage(edges, meta, fmeta, px, py)
    inside = acc_in != 0
    m = (acc_aa if use_aa else inside.to(torch.float32))[..., None]
    frame = torch.round(frame_w * (1.0 - m) + tex_w * m)
    if emit_flow:
        mm = [fmeta[:, i].reshape(n, 1, 1) for i in range(6)]
        ofx = mm[0] * px + mm[1] * py + mm[2] - px
        ofy = mm[3] * px + mm[4] * py + mm[5] - py
        mi = inside.to(torch.float32)[..., None]
        flow = torch.stack([ofx, ofy], -1) * mi + flow_w * (1.0 - mi)
    else:
        flow = flow_w
    return (frame[0], flow[0]) if single else (frame, flow)


def crop_texture(atlas_q, tex, crop, x, y, sampled):
    """Texels of each sample's object texture: the (H, W) centre crop at
    (cy0, cx0) of layer ``tex`` (n,) of the quad-packed atlas (T, SH, SW,
    12). ``sampled`` false copies the crop at integer positions ``x``/``y``
    (n, ...); true samples it bilinearly with the reflect fold (the JAX
    renderer's ``sample_bilinear_quad`` on the crop). ``crop`` = (cy0, cx0,
    H, W). Returns x's shape plus 3 channels, float32."""
    T, SH, SW = atlas_q.shape[:3]
    cy0, cx0, H, W = crop
    flat = atlas_q.reshape(-1, 12)
    lead = (-1,) + (1,) * (x.dim() - 1)
    # Crop texel (y, x) is row base + y * SW + x of the flattened atlas.
    base = ((tex.to(torch.int64) * SH + cy0) * SW + cx0).reshape(lead)
    if not sampled:
        rows = flat[base + y.to(torch.int64) * SW + x.to(torch.int64)]
        return rows[..., :3].to(torch.float32)
    return sample_bilinear_quad_flat(flat, base, H, W, x, y, wrap="reflect",
                                     row_stride=SW)


def window_texture(atlas_q, win, meta, fmeta, crop, wh, ww, sampled):
    """The object texture over windows ``win`` (n, 4) of class (wh, ww):
    frame 0 (``sampled`` false) the centre crop at the window's pixels,
    frame 1 the crop sampled at the motion-inverse positions ``fmeta[:, :6]``
    of them (see :func:`crop_texture`). Returns (n, wh, ww, 3)."""
    px, py = window_grids(meta[:, 2], meta[:, 1], wh, ww)
    tex = win[:, WIN_TEX]
    if not sampled:
        return crop_texture(atlas_q, tex, crop, px, py, False)
    mm = [fmeta[:, i].reshape(-1, 1, 1) for i in range(6)]
    sx = mm[0] * px + mm[1] * py + mm[2]
    sy = mm[3] * px + mm[4] * py + mm[5]
    return crop_texture(atlas_q, tex, crop, sx, sy, True)


def _window_index(win, meta, wh, ww):
    """Advanced index of windows (n, wh, ww) into planes (B, H, W, ...)."""
    ys = torch.arange(wh, device=win.device)
    xs = torch.arange(ww, device=win.device)
    b = win[:, WIN_B].long()[:, None, None]
    yy = (meta[:, 2].long()[:, None] + ys)[:, :, None]
    xx = (meta[:, 1].long()[:, None] + xs)[:, None, :]
    return b, yy, xx


def object_window(edges, meta, fmeta, win, frames, flow, atlas_q, *, crop,
                  sampled, use_aa=True, emit_flow=True, max_hw=None):
    """One painter rank's object windows, one per sample: blend each into
    ``frames`` (B, H, W, 3) and, with ``emit_flow``, overwrite ``flow`` (B,
    H, W, 2) under its binary mask, in place. ``win`` (n, 4) int32 holds
    each window's [batch index, wh, ww, texture id]; ``crop`` = (cy0, cx0,
    H, W) the objects' centre crop in the quad-packed ``atlas_q`` (T, SH,
    SW, 12) uint8; ``sampled`` selects frame 1's texture (see
    :func:`window_texture`). ``max_hw`` (the largest window) sizes the grid.
    CUDA tensors launch ``object_window_kernel`` (counted in
    ``object_window.launches``); CPU tensors run the plain version.

    ``frames`` must hold whole values, as the renderer's do: the kernel
    leaves a pixel that no primitive reaches (blend weight 0) untouched,
    which equals the plain version's ``round(f * 1 + t * 0)`` and flow
    ``ofx * 0 + flow`` only for whole-valued frames, and then up to the sign
    of a zero (where a frame or flow value is -0 the plain version may write
    +0)."""
    n = win.shape[0]
    if n == 0:
        return
    if max_hw is None:
        max_hw = (int(win[:, WIN_H].max()), int(win[:, WIN_W].max()))
    if _runs_plain("object_window", frames):
        sizes = win[:, WIN_H:WIN_W + 1].cpu()
        for wh, ww in sorted({tuple(map(int, s)) for s in sizes}):
            sel = ((sizes[:, 0] == wh) & (sizes[:, 1] == ww)).nonzero()[:, 0]
            sel = sel.to(frames.device)
            e, m, f, w = (t.index_select(0, sel)
                          for t in (edges, meta, fmeta, win))
            idx = _window_index(w, m, wh, ww)
            tex = window_texture(atlas_q, w, m, f, crop, wh, ww, sampled)
            fl = flow[idx] if emit_flow else torch.zeros(
                (len(sel), wh, ww, 2), device=frames.device)
            fr, fl = object_window_plain(e, m, f, tex, frames[idx], fl,
                                         use_aa=use_aa, emit_flow=emit_flow)
            frames[idx] = fr
            if emit_flow:
                flow[idx] = fl
        return
    _object_window_cuda(edges, meta, fmeta, win, frames, flow, atlas_q,
                        crop=crop, sampled=sampled, use_aa=use_aa,
                        emit_flow=emit_flow, max_hw=max_hw)


def _object_window_cuda(edges, meta, fmeta, win, frames, flow, atlas_q, *,
                        crop, sampled, use_aa, emit_flow, max_hw):
    """Launch ``object_window_kernel``; raises on anything but CUDA tensors
    of the expected types and shapes."""
    from ._build import load_window_library

    n = win.shape[0]
    B, H, W = frames.shape[:3]
    T, SH, SW = atlas_q.shape[:3]
    C = (meta.shape[1] - 3) // 3
    E = edges.shape[-1] // C
    _check("object_window: edges", edges, torch.float32, (n, 4, C * E))
    _check("object_window: meta", meta, torch.int32, (n, 3 + 3 * C))
    _check("object_window: fmeta", fmeta, torch.float32, (n, 6 + 8 * C))
    _check("object_window: win", win, torch.int32, (n, 4))
    _check("object_window: frames", frames, torch.float32, (B, H, W, 3))
    _check("object_window: atlas", atlas_q, torch.uint8, (T, SH, SW, 12))
    if emit_flow:
        _check("object_window: flow", flow, torch.float32, (B, H, W, 2))
    cy0, cx0, Hc, Wc = crop
    if (Hc, Wc) != (H, W):
        raise ValueError("object_window: the texture crop must be the frame "
                         "size")
    err = load_window_library().flowgen_object_window(
        _ptr(edges), _ptr(meta), _ptr(fmeta), _ptr(win), _ptr(atlas_q),
        _ptr(frames), _ptr(flow if emit_flow else None), n, B, H, W, T, SH,
        SW, cy0, cx0, max_hw[0], max_hw[1], C, E, int(bool(sampled)),
        int(bool(use_aa)), int(bool(emit_flow)), ELL_CULL_M, ELL_CULL_ANISO,
        _stream(frames))
    if err != 0:
        raise RuntimeError(
            f"object_window kernel launch failed: CUDA error {err}")
    object_window.launches += 1


object_window.launches = 0
