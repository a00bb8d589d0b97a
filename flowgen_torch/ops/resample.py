"""Two-pass affine resampling of packed-RGB slabs: host helpers and the
plain PyTorch resample (port of ``flowgen/ops/pallas_resample.py``).

An output -> slab affine ``sx = a x + b y + e``, ``sy = c x + d y + f`` splits
into two 1-D passes (Catmull-Smith):

  pass 1: t1[w, x] = lerp(rows[w, u0], rows[w, u1], frac(u)),
          u = clip(A x + B (w0 + w) + C, 0, CW - 1),
          A = a - b c / d, B = b / d, C = e - B f
  pass 2: out[y, x] = lerp(t1[v0, x], t1[v1, x], frac(v)),
          v = clip(c x + d y + f - w0, 0, P - 1)

over a staged row block ``rows = slab[w0 : w0 + P, c0 : c0 + CW]`` (the
coefficient C is rebased by -c0). The clips are relative to the staged
block, as in the JAX package's kernel (``resample_rows_in_kernel``).
Texels are RGB packed in one int32, ``(r << 16) | (g << 8) | b``.

Mode 9 adds the plain versions of the JAX package's f32 plane resample and
its separable displacement warps (f32 and packed RGB), which read their
taps through the TPU kernels' banded rule (``banded_taps``).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .._fp import div

PASS1_CHUNK = 128


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def pack_rgb_i32(img: torch.Tensor) -> torch.Tensor:
    """(..., H, W, 3) uint8/float -> (..., H, W) int32 (r<<16)|(g<<8)|b."""
    if img.dtype != torch.uint8:
        img = torch.clamp(torch.round(img.to(torch.float32)), 0, 255).to(
            torch.uint8
        )
    v = img.to(torch.int32)
    return (v[..., 0] << 16) | (v[..., 1] << 8) | v[..., 2]


def unpack_rgb(v: torch.Tensor):
    """Packed int32 -> three float32 channel planes."""
    return (
        ((v >> 16) & 0xFF).to(torch.float32),
        ((v >> 8) & 0xFF).to(torch.float32),
        (v & 0xFF).to(torch.float32),
    )


def _reflect_indices(i, n):
    period = 2 * n
    i = torch.remainder(i, period)
    return torch.where(i >= n, period - 1 - i, i)


def reflect_pad(img: torch.Tensor, margin_y: int, margin_x: int):
    """Pad a (H, W, ...) tensor with AGG wrap_mode_reflect content (period
    2n, second half mirrored)."""
    h, w = img.shape[0], img.shape[1]
    yi = _reflect_indices(torch.arange(-margin_y, h + margin_y, device=img.device), h)
    xi = _reflect_indices(torch.arange(-margin_x, w + margin_x, device=img.device), w)
    return img[yi][:, xi]


def pack_padded_slab(img, margin_y: int, margin_x: int):
    """(H, W, 3) image -> reflect-padded packed int32 slab, edge-padded to
    (multiple of 8, multiple of 128)."""
    slab = reflect_pad(pack_rgb_i32(img), margin_y, margin_x)
    h, w = slab.shape
    hp, wp = _round_up(h, 8), _round_up(w, 128)
    return _edge_pad(slab, hp, wp)


def _edge_pad(s: torch.Tensor, hp: int, wp: int):
    yi = torch.clamp(torch.arange(hp, device=s.device), max=s.shape[0] - 1)
    xi = torch.clamp(torch.arange(wp, device=s.device), max=s.shape[1] - 1)
    return s[..., yi, :][..., xi]


def two_pass_coeffs(transform):
    """Split an output -> source affine (2, 3) into (A, B, C, c, d, f)."""
    a, b, e = transform[0, 0], transform[0, 1], transform[0, 2]
    c, d, f = transform[1, 0], transform[1, 1], transform[1, 2]
    B = div(b, d)
    A = a - B * c
    C = e - B * f
    return A, B, C, c, d, f


def max_row_span(wh: int, ww: int, max_rot: float, max_scale: float) -> int:
    """Static bound on the source-row span of a (wh, ww) window."""
    if not max_rot <= math.pi / 4 + 1e-3:
        raise ValueError("two-pass resampler needs |residual rot| <= 45 deg")
    span = (
        math.sin(min(max_rot, math.pi / 4)) * max_scale * ww
        + max_scale * wh + 4
    )
    return _round_up(int(math.ceil(span)) + 8, 8)


def scan_tiles_pass1(A_max: float, B_max: float, rows: int) -> int:
    """Lane-tile scan count of the TPU kernel's pass 1 (kept for the static
    sizing of the port; the CUDA kernel addresses texels directly)."""
    return int(math.ceil((A_max * 128 + B_max * rows + 3) / 128)) + 1


def scan_tiles_pass2(c_max: float, d_max: float, xchunk: int) -> int:
    """Lane-tile scan count of the TPU kernel's pass 2."""
    return int(math.ceil((c_max * xchunk + d_max * 128 + 3) / 128)) + 1


# ---------------------------------------------------------------------------
# Scalar window geometry (float32 numpy scalars: IEEE float32 per operation,
# the same arithmetic as csrc/resample.cuh)
# ---------------------------------------------------------------------------

F32 = np.float32


def pass1_row_start(coeffs, x0: int, y0: int, wh: int, ww: int, P: int,
                    SH: int) -> int:
    """Row-block start: min source-v over the window corners, floor - 1,
    snapped to 8, clamped so [w0, w0+P) stays inside a height-``SH`` slab."""
    _, _, _, c, d, f = coeffs
    xs = (F32(x0), F32(x0) + F32(ww - 1))
    ys = (F32(y0), F32(y0) + F32(wh - 1))
    corners = [c * xx + d * yy + f for xx in xs for yy in ys]
    vmin = min(min(corners[0], corners[1]), min(corners[2], corners[3]))
    w0 = (int(np.floor(vmin)) - 1) & ~7
    return int(min(max(w0, 0), (SH - P) & ~7))


def col_window(coeffs, x0: int, w0: int, wwl: int, Pl: int, CW: int, SW: int):
    """Column window of the staged row block: the 128-aligned start of the
    source columns pass 1 can touch, clamped into the slab, and the
    coefficients rebased to it. ``CW >= SW`` disables windowing."""
    if CW >= SW:
        return 0, coeffs
    A, B, C, c, d, f = coeffs
    xf, wf = F32(x0), F32(w0)
    us = [
        A * xx + B * wv + C
        for xx in (xf, xf + F32(wwl - 1))
        for wv in (wf, wf + F32(Pl - 1))
    ]
    umin = min(min(us[0], us[1]), min(us[2], us[3]))
    c0 = (int(np.floor(umin)) - 1) & ~127
    c0 = min(max(c0, 0), SW - CW)
    return c0, (A, B, C - F32(c0), c, d, f)


def fold_coeffs_scalar(mm, cx_c, cy_c, nx, ny, margin):
    """Reflect fold at the footprint centre (cx_c, cy_c) composed into a raw
    output -> source affine, then split into two-pass coefficients: the
    TPU kernel's in-kernel fold (``s - 2n * floor(s / 2n)``)."""
    m00, m01, m02, m10, m11, m12 = (F32(v) for v in mm)
    cx_c, cy_c = F32(cx_c), F32(cy_c)

    def fold(s_c, n):
        n = F32(n)
        two_n = F32(2.0) * n
        r = s_c - two_n * np.floor(s_c / two_n)
        mirror = r >= n
        off = s_c - r
        sig = F32(-1.0) if mirror else F32(1.0)
        beta = ((two_n - F32(1.0)) + off if mirror else -off) + F32(margin)
        return sig, beta

    sx_c = m00 * cx_c + m01 * cy_c + m02
    sy_c = m10 * cx_c + m11 * cy_c + m12
    sigx, betax = fold(sx_c, nx)
    sigy, betay = fold(sy_c, ny)
    a = m00 * sigx
    bb = m01 * sigx
    e = m02 * sigx + betax
    c = m10 * sigy
    d = m11 * sigy
    f = m12 * sigy + betay
    B_ = bb / d
    return (a - B_ * c, B_, e - B_ * f, c, d, f)


# ---------------------------------------------------------------------------
# Plain two-pass resample of a staged row block
# ---------------------------------------------------------------------------


def resample_rows(rows: torch.Tensor, w0: int, coeffs, x0: int, y0: int,
                  wh: int, ww: int):
    """Two-pass resample of a (wh, ww) window at output origin (x0, y0) from
    a staged row block ``rows`` (P, CW) int32 holding slab rows [w0, w0+P)
    (and the column window the coefficients are rebased to). Pass 1 runs
    over all P rows, pass 2 gathers from it. Returns three (wh, ww) float32
    channel planes."""
    P, CW = rows.shape
    dev = rows.device
    A, B, C, c, d, f = (float(v) for v in coeffs)
    w0f = float(F32(w0))
    wg = (torch.arange(P, dtype=torch.float32, device=dev) + w0f)[:, None]
    xg = (torch.arange(ww, dtype=torch.float32, device=dev) + float(x0))[None, :]
    u = torch.clamp(A * xg + B * wg + C, 0.0, float(CW - 1))
    uf = torch.floor(u)
    fx = u - uf
    u0 = uf.to(torch.int64)
    u1 = torch.clamp(u0 + 1, max=CW - 1)
    p0 = torch.gather(rows, 1, u0)
    p1 = torch.gather(rows, 1, u1)

    yg = (torch.arange(wh, dtype=torch.float32, device=dev) + float(y0))[:, None]
    xg2 = xg.expand(wh, ww)
    v = torch.clamp(c * xg2 + d * yg + f - w0f, 0.0, float(P - 1))
    vf = torch.floor(v)
    fy = v - vf
    v0 = vf.to(torch.int64)
    v1 = torch.clamp(v0 + 1, max=P - 1)

    outs = []
    for a0, a1 in zip(unpack_rgb(p0), unpack_rgb(p1)):
        t1 = a0 + (a1 - a0) * fx
        b0 = torch.gather(t1, 0, v0)
        b1 = torch.gather(t1, 0, v1)
        outs.append(b0 + (b1 - b0) * fy)
    return tuple(outs)


def resample_pixels(rows: torch.Tensor, w0: int, coeffs, xs, ys):
    """The closed form of :func:`resample_rows` per output pixel, as the CUDA
    kernel evaluates it (``csrc/resample.cuh``): pass 2 reads only rows
    floor(v) and floor(v)+1 of pass 1, so each pixel lerps two pass-1 rows,
    each lerped at its own u. ``xs``/``ys`` are integer pixel coordinates
    (any shape). Returns three float32 planes of that shape."""
    P, CW = rows.shape
    A, B, C, c, d, f = (float(v) for v in coeffs)
    xf = xs.to(torch.float32)
    yf = ys.to(torch.float32)
    v = torch.clamp(c * xf + d * yf + f - float(F32(w0)), 0.0, float(P - 1))
    vf = torch.floor(v)
    fy = v - vf
    v0 = vf.to(torch.int64)
    v1 = torch.clamp(v0 + 1, max=P - 1)

    def pass1(vi):
        wg = (vi + w0).to(torch.float32)
        u = torch.clamp(A * xf + B * wg + C, 0.0, float(CW - 1))
        uf = torch.floor(u)
        fx = u - uf
        u0 = uf.to(torch.int64)
        u1 = torch.clamp(u0 + 1, max=CW - 1)
        a0 = unpack_rgb(rows[vi, u0])
        a1 = unpack_rgb(rows[vi, u1])
        return [p + (q - p) * fx for p, q in zip(a0, a1)]

    q0, q1 = pass1(v0), pass1(v1)
    return tuple(p + (q - p) * fy for p, q in zip(q0, q1))


def two_pass_window(slab: torch.Tensor, coeffs, x0: int, y0: int, wh: int,
                    ww: int, P: int, CW: int):
    """Stage the row block of a window (``pass1_row_start``, ``col_window``)
    from a packed slab (SH, SW) and resample it with :func:`resample_rows`.
    ``coeffs`` are float32 scalars in slab coordinates."""
    SH, SW = slab.shape
    coeffs = tuple(F32(v) for v in coeffs)
    w0 = pass1_row_start(coeffs, x0, y0, wh, ww, P, SH)
    CW = min(CW, SW)
    c0, coeffs = col_window(coeffs, x0, w0, ww, P, CW, SW)
    rows = slab[w0 : w0 + P, c0 : c0 + CW]
    return resample_rows(rows, w0, coeffs, x0, y0, wh, ww)


# ---------------------------------------------------------------------------
# The standalone resampler (the JAX package's affine_resample_pallas)
# ---------------------------------------------------------------------------


def _f32_coeffs(transform):
    """:func:`two_pass_coeffs` of a (2, 3) output -> slab affine, as float32
    scalars on the host."""
    t = transform.cpu().numpy() if torch.is_tensor(transform) else transform
    (a, b, e), (c, d, f) = np.asarray(t, np.float32)
    B = b / d
    return (a - B * c, B, e - B * f, c, d, f)


def _rows_need(coeffs, w0: int, x0: int, y0: int, wh: int, ww: int,
               P: int) -> float:
    """The source rows pass 2 can read for this affine (the JAX kernel's
    ``_pass1_rows_needed``): the corners' largest v less w0, plus 3,
    clipped to [1, P]. Pass-1 chunks from there on are not computed."""
    _, _, _, c, d, f = coeffs
    xs = (F32(x0), F32(x0) + F32(ww - 1))
    ys = (F32(y0), F32(y0) + F32(wh - 1))
    vmax = max(c * xx + d * yy + f for xx in xs for yy in ys)
    return float(min(max(vmax - F32(w0) + F32(3.0), F32(1.0)), F32(P)))


def resample_rows_banded(rows: torch.Tensor, w0: int, coeffs, x0: int,
                         y0: int, wh: int, ww: int, x_tiles_scan: int,
                         y_tiles_scan: int):
    """The JAX package's ``resample_rows_in_kernel`` on packed-RGB rows
    (P, SW) holding slab rows [w0, w0+P), its taps read through the banded
    rule (:func:`banded_taps`): pass 1 over (128-row chunk, 128-lane tile)
    blocks, each with a band of ``x_tiles_scan`` slab tiles, chunks past
    the rows pass 2 can read left out; pass 2 over (128-column, 128-row)
    blocks of the transposed pass-1 planes (rows padded to 128, as its
    scratch), each with a band of ``y_tiles_scan`` tiles. A tap outside its
    band reads 0. Inside the bands this is :func:`resample_rows`. Returns
    three (wh, ww) planes."""
    P, SW = rows.shape
    dev = rows.device
    A, B, C, c, d, f = (float(v) for v in coeffs)
    w0f = float(F32(w0))
    need = _rows_need(coeffs, w0, x0, y0, wh, ww, P)
    Pp = _round_up(P, 128)
    xg = torch.arange(ww, dtype=torch.float32, device=dev) + float(x0)
    t1 = [torch.zeros((ww, Pp), dtype=torch.float32, device=dev)
          for _ in range(3)]
    for r0 in range(0, P, PASS1_CHUNK):
        if not float(r0) < need:
            continue
        rc = min(PASS1_CHUNK, P - r0)
        wg = (torch.arange(rc, dtype=torch.float32, device=dev)
              + float(F32(w0f + r0)))[:, None]
        u = torch.clamp(A * xg[None, :] + B * wg + C, 0.0, float(SW - 1))
        p0, p1, fx, _ = banded_taps(rows[r0 : r0 + rc], u, rc, x_tiles_scan,
                                    SW)
        for ch, (a0, a1) in enumerate(zip(unpack_rgb(p0), unpack_rgb(p1))):
            t1[ch][:, r0 : r0 + rc] = (a0 + (a1 - a0) * fx).t()
    whp = _round_up(wh, 128)
    xchunk = 128 if ww >= 128 else ww
    yg = torch.arange(whp, dtype=torch.float32, device=dev) + float(y0)
    v = torch.clamp(c * xg[:, None] + d * yg[None, :] + f - w0f, 0.0,
                    float(P - 1))
    return tuple(banded_lerp(t, v, xchunk, y_tiles_scan, P,
                             clamp_oob=True)[:, :wh].t() for t in t1)


def affine_resample_plain(slab, transform, x0: int, y0: int, *, wh: int,
                          ww: int, P: int, x_tiles_scan: int = 4,
                          y_tiles_scan: int = 4):
    """The plain version of :func:`affine_resample`: the row block of
    ``pass1_row_start`` over the whole slab width, resampled by
    :func:`resample_rows_banded`."""
    SH, _ = slab.shape
    co = _f32_coeffs(transform)
    w0 = pass1_row_start(co, int(x0), int(y0), wh, ww, P, SH)
    r, g, b = resample_rows_banded(slab[w0 : w0 + P], w0, co, int(x0),
                                   int(y0), wh, ww, x_tiles_scan,
                                   y_tiles_scan)
    return torch.stack([r, g, b], -1)


def affine_resample(slab, transform, x0: int, y0: int, *, wh: int, ww: int,
                    P: int, x_tiles_scan: int = 4, y_tiles_scan: int = 4):
    """Resample a (wh, ww) window at output origin (x0, y0) through an
    output -> slab affine ``transform`` (2, 3) from a packed padded slab
    (:func:`pack_padded_slab`), staging ``P`` source rows, each pass's taps
    read through bands of ``x_tiles_scan`` and ``y_tiles_scan`` 128-lane
    tiles as in the JAX package's ``affine_resample_pallas`` (a tap outside
    its band reads 0; :func:`resample_rows_banded`). ``ww`` is a multiple of
    128, as the JAX kernel requires. Returns (wh, ww, 3) float32. A CUDA
    slab launches ``csrc/resample.cu:affine_resample_kernel`` (counted in
    ``affine_resample.launches``); a CPU slab runs
    :func:`affine_resample_plain`. No path of the generator calls it, as
    in the JAX package."""
    if ww % 128 or x_tiles_scan < 1 or y_tiles_scan < 1:
        raise ValueError("affine_resample: ww must be a multiple of 128 and "
                         "the band widths at least 1")
    if slab.device.type == "cpu":
        return affine_resample_plain(slab, transform, x0, y0, wh=wh, ww=ww,
                                     P=P, x_tiles_scan=x_tiles_scan,
                                     y_tiles_scan=y_tiles_scan)
    if (slab.device.type != "cuda" or slab.dtype != torch.int32
            or not slab.is_contiguous() or slab.dim() != 2):
        raise ValueError("affine_resample: expects a contiguous (SH, SW) int32 "
                         "CUDA slab")
    import ctypes

    from ._build import load_resample_library

    SH, SW = slab.shape
    out = torch.empty((wh, ww, 3), dtype=torch.float32, device=slab.device)
    err = load_resample_library().flowgen_affine_resample(
        ctypes.c_void_p(slab.data_ptr()),
        *(float(c) for c in _f32_coeffs(transform)),
        ctypes.c_void_p(out.data_ptr()), SH, SW, int(x0), int(y0), wh, ww, P,
        x_tiles_scan, y_tiles_scan,
        ctypes.c_void_p(torch.cuda.current_stream(slab.device).cuda_stream))
    if err != 0:
        raise RuntimeError(f"affine_resample kernel launch failed: CUDA error {err}")
    affine_resample.launches += 1
    return out


affine_resample.launches = 0


# ---------------------------------------------------------------------------
# Banded taps and the mode-9 resamplers (plain versions)
# ---------------------------------------------------------------------------
#
# The JAX package's kernels read their two bilinear taps per element through
# ``_banded_tap_pair``: per (rows_per_block, 128) block of positions, a band
# of ``n_tiles_scan`` 128-lane source tiles starts at the tile of the block's
# smallest left tap, and a tap outside that band reads 0. The band is part
# of the function, so the plain versions below apply it exactly.


def banded_taps(src: torch.Tensor, u: torch.Tensor, rows_per_block: int,
                n_tiles_scan: int, width_valid: int):
    """Bilinear taps of rows ``src`` (G, Ls), Ls a multiple of 128, at
    positions ``u`` (G, X), X a multiple of 128 and G of ``rows_per_block``.
    Positions clip to [0, width_valid - 1]. Returns (p0, p1, fx, ok): the
    two taps (0 outside the block's band), the lerp weight, and whether the
    unclipped position lay inside [0, width_valid - 1]."""
    G, X = u.shape
    Ls = src.shape[1]
    n_src = Ls // 128
    wv = float(width_valid)
    ok = (u >= 0.0) & (u <= wv - 1.0)
    uc = torch.clamp(u, 0.0, wv - 1.0)
    uf = torch.floor(uc)
    fx = uc - uf
    u0 = uf.to(torch.int64)
    u1 = torch.clamp(u0 + 1, max=int(width_valid) - 1)
    nscan = min(n_tiles_scan, n_src)
    br = rows_per_block
    bmin = u0.reshape(G // br, br, X // 128, 128).amin(dim=(1, 3))
    tile0 = torch.clamp(torch.clamp(bmin >> 7, max=n_src - nscan), min=0)
    lo = (tile0 * 128).repeat_interleave(br, 0).repeat_interleave(128, 1)
    hi = lo + nscan * 128

    def tap(idx):
        v = torch.gather(src, 1, idx)
        return torch.where((idx >= lo) & (idx < hi), v, torch.zeros_like(v))

    return tap(u0), tap(u1), fx, ok


def banded_lerp(src, u, rows_per_block, n_tiles_scan, width_valid,
                clamp_oob=False):
    """The JAX package's ``_banded_lerp_rows``: ``det_lerp`` of the banded
    taps; positions outside [0, width_valid - 1] give 0 unless
    ``clamp_oob`` holds them at the edge value."""
    p0, p1, fx, ok = banded_taps(src, u, rows_per_block, n_tiles_scan,
                                 width_valid)
    v = p0 + (p1 - p0) * fx
    return v if clamp_oob else torch.where(ok, v, torch.zeros_like(v))


def _pad_lanes(x: torch.Tensor, lanes: int):
    return torch.nn.functional.pad(x, (0, lanes - x.shape[-1]))


def resample_rows_f32(rows: torch.Tensor, w0: int, coeffs, x0: int, y0: int,
                      wh: int, ww: int, x_tiles_scan: int, y_tiles_scan: int,
                      pass2_lanes: int):
    """Single-plane f32 two-pass affine resample of a (wh, ww) window from
    staged field rows ``rows`` (P, SW) holding rows [w0, w0+P) (the JAX
    package's ``resample_rows_f32``): pass 1 in 128-row chunks, each with
    its own band, pass 2 over (128, 128) blocks of the transposed pass-1
    rows, whose scratch is ``pass2_lanes`` wide. Returns (wh, ww) f32."""
    P, SW = rows.shape
    dev = rows.device
    A, B, C, c, d, f = (float(v) for v in coeffs)
    w0f = float(F32(w0))
    xg = torch.arange(ww, dtype=torch.float32, device=dev) + float(x0)
    t1 = torch.empty((P, ww), dtype=torch.float32, device=dev)
    for r0 in range(0, P, PASS1_CHUNK):
        rc = min(PASS1_CHUNK, P - r0)
        wg = (torch.arange(rc, dtype=torch.float32, device=dev)
              + float(F32(w0f + r0)))[:, None]
        u = torch.clamp(A * xg[None, :] + B * wg + C, 0.0, float(SW - 1))
        t1[r0 : r0 + rc] = banded_lerp(rows[r0 : r0 + rc], u, rc,
                                       x_tiles_scan, SW, clamp_oob=True)
    whp = _round_up(wh, 128)
    xchunk = 128 if ww >= 128 else ww
    yg = torch.arange(whp, dtype=torch.float32, device=dev) + float(y0)
    v = torch.clamp(c * xg[:, None] + d * yg[None, :] + f - w0f, 0.0,
                    float(P - 1))
    outT = banded_lerp(_pad_lanes(t1.t(), pass2_lanes), v, xchunk,
                       y_tiles_scan, P, clamp_oob=True)
    return outT[:, :wh].t()


def _pass1_u(gdisp, x0, ex0, ww):
    xs = torch.arange(ww, dtype=torch.float32, device=gdisp.device) + float(x0)
    return (xs[None, :] + gdisp) - float(ex0)


def _pass2_v(vdisp, y0, ey0, wh, whp):
    vdT = _pad_lanes(vdisp.t(), whp)
    ys = torch.arange(whp, dtype=torch.float32, device=vdisp.device) + float(y0)
    return (ys[None, :] + vdT) - float(ey0)


def displace_warp(src, gdisp, vdisp, x0, y0, ex0, ey0, wh, ww, whE, wwE,
                  x_scan=3, y_scan=3):
    """Separable bounded-displacement warp of an f32 plane (the JAX
    package's ``displace_warp_in_kernel``): ``src`` (whE, wwE) with frame
    origin (ey0, ex0); pass 1 reads row w at ``x + gdisp[w, x]``, pass 2
    reads the pass-1 rows at ``y + vdisp[y, x]``. Positions outside the
    source give 0. Returns (wh, ww)."""
    tmp = banded_lerp(src, _pass1_u(gdisp, x0, ex0, ww), whE, x_scan, wwE)
    whp = _round_up(wh, 128)
    out = banded_lerp(_pad_lanes(tmp.t(), _round_up(whE, 128)),
                      _pass2_v(vdisp, y0, ey0, wh, whp), 128, y_scan, whE)
    return out[:, :wh].t()


def _lerp_packed(p0, p1, fx, ok):
    out = []
    for a0, a1 in zip(unpack_rgb(p0), unpack_rgb(p1)):
        v = a0 + (a1 - a0) * fx
        out.append(torch.where(ok, v, torch.zeros_like(v)))
    return out


def displace_warp_rgb(src, gdisp, vdisp, x0, y0, ex0, ey0, wh, ww, whE, wwE,
                      pass2_lanes, x_scan=3, y_scan=3):
    """Packed-RGB twin of :func:`displace_warp` (the JAX package's
    ``displace_warp_rgb_in_kernel``): the pass-1 result is rounded to u8 and
    repacked before pass 2. ``pass2_lanes`` is the width of the JAX kernel's
    transposed scratch (shared with the background warp). Returns three
    (wh, ww) f32 planes."""
    p0, p1, fx, ok = banded_taps(src, _pass1_u(gdisp, x0, ex0, ww), whE,
                                 x_scan, wwE)
    r, g, b = _lerp_packed(p0, p1, fx, ok)
    tmp = ((torch.round(r).to(torch.int32) << 16)
           | (torch.round(g).to(torch.int32) << 8)
           | torch.round(b).to(torch.int32))
    whp = _round_up(wh, 128)
    q0, q1, fy, okv = banded_taps(_pad_lanes(tmp.t(), pass2_lanes),
                                  _pass2_v(vdisp, y0, ey0, wh, whp), 128,
                                  y_scan, whE)
    return tuple(v[:, :wh].t() for v in _lerp_packed(q0, q1, fy, okv))
