"""Analytic exact-area coverage of the reference (a frozen copy of the port's
``ops/raster.py``, with the polygon sum taken over all edges at once).

Polygons: exact signed cell area per edge by Green's theorem, the 3-piece
trapezoid with its p/q face-crossing breakpoints and the unclamped midpoint
(``edge_cell_area``). Fat ellipses: the reference's inscribed 100-gon, one
sector chord plus both neighbours per pixel, with the exact cell area of the
three half-planes' intersection (``ellipse_chord_coverage``). Every function
is elementwise float32 in the JAX package's order of operations; Python
constants are rounded to float32 first, as JAX rounds weak constants.
``csrc/coverage.cuh`` holds the same arithmetic for the scene kernel.
"""

from __future__ import annotations

import math

import torch

from .affine import invert
from .fp import div, f32, sqrt

_E12 = f32(1e-12)


def _clip(x, lo, hi):
    """``jnp.clip``: max with the lower bound first, then min."""
    return torch.minimum(torch.maximum(x, lo), hi)


def _c(x, like):
    return x if torch.is_tensor(x) else torch.full_like(like, f32(x))


def edge_cell_area(ax, ay, bx, by, px, py):
    """Signed area contribution of edge (a -> b) to the unit cell centred at
    (px, py). Broadcasts; summed over a closed outline it is the exact signed
    polygon area inside the cell."""
    dx = bx - ax
    dy = by - ay
    zero = torch.zeros_like(dy)
    inv_dy = torch.where(dy.abs() > _E12, div(1.0, dy), zero)
    inv_dx = torch.where(dx.abs() > _E12, div(1.0, dx), zero)

    xlo = px - 0.5
    ylo = py - 0.5
    yhi = py + 0.5

    r0 = (ylo - ay) * inv_dy
    r1 = (yhi - ay) * inv_dy
    z, o = torch.zeros_like(r0), torch.ones_like(r0)
    ta = _clip(torch.minimum(r0, r1), z, o)
    tb = _clip(torch.maximum(r0, r1), z, o)

    s0 = (xlo - ax) * inv_dx
    s1 = (xlo + 1.0 - ax) * inv_dx
    p = _clip(torch.minimum(s0, s1), ta, tb)
    q = _clip(torch.maximum(s0, s1), ta, tb)

    def g(t):
        return torch.clamp(ax + t * dx - xlo, 0.0, 1.0)

    mid = (ax - xlo) + (p + q) * (0.5 * dx)
    integral = g(ta) * (p - ta) + mid * (q - p) + g(tb) * (tb - q)
    return dy * integral


def polygon_coverage(edge_pts, n_edges, px, py):
    """Coverage (aa, inside) of a closed outline ``edge_pts`` (E, 2) over
    pixel-centre grids ``px``/``py`` (h, w). The first ``n_edges`` edges
    close the outline (the padding repeats point 0, so every later edge has
    no length and adds nothing); their contributions are summed one by one
    in edge order."""
    a = edge_pts[:n_edges]
    b = torch.roll(edge_pts, -1, dims=0)[:n_edges]
    col = lambda t, i: t[:, i, None, None]
    contrib = edge_cell_area(col(a, 0), col(a, 1), col(b, 0), col(b, 1),
                             px[None], py[None])
    area = torch.zeros_like(px)
    for e in range(n_edges):
        area = area + contrib[e]
    area = area.abs()
    return torch.clamp(area, 0.0, 1.0), area >= 0.5


def pixel_grid(width, height, center_offset=0.5, device="cpu"):
    """Pixel sample positions (px, py), each (height, width) float32:
    coverage is evaluated at centres (+0.5), flow at integer coordinates."""
    ys = torch.arange(height, dtype=torch.float32, device=device) + center_offset
    xs = torch.arange(width, dtype=torch.float32, device=device) + center_offset
    py, px = torch.meshgrid(ys, xs, indexing="ij")
    return px, py


def _sector_center_dir(ux, uy, steps: int):
    """Unit direction of the centre of the ``2*pi/steps`` sector holding
    (ux, uy): quadrant fold plus a binary search over power-of-two sector
    rotations with Python-constant cos/sin (trig-free)."""
    assert steps % 4 == 0
    delta = 2.0 * math.pi / steps
    q = steps // 4
    c = ux.abs()
    s = uy.abs()
    nx = torch.full_like(c, f32(math.cos(delta / 2.0)))
    ny = torch.full_like(c, f32(math.sin(delta / 2.0)))
    a = (1 << ((q - 1).bit_length() - 1)) if q > 1 else 0
    while a >= 1:
        ca = f32(math.cos(a * delta))
        sa = f32(math.sin(a * delta))
        pred = s * ca - c * sa >= 0.0
        c, s = (
            torch.where(pred, c * ca + s * sa, c),
            torch.where(pred, s * ca - c * sa, s),
        )
        nx, ny = (
            torch.where(pred, nx * ca - ny * sa, nx),
            torch.where(pred, ny * ca + nx * sa, ny),
        )
        a >>= 1
    nx = torch.where(ux >= 0.0, nx, -nx)
    ny = torch.where(uy >= 0.0, ny, -ny)
    return nx, ny


def _clamped_line_integral(m, c, a, b):
    """``∫_a^b clamp(m*t + c, 0, 1) dt`` for ``b >= a`` (0 if ``b <= a``)."""
    a = _c(a, m)
    b = _c(b, m)
    inv_m = torch.where(m.abs() > _E12, div(1.0, m), torch.zeros_like(m))
    r0 = (0.0 - c) * inv_m
    r1 = (1.0 - c) * inv_m
    b = torch.maximum(b, a)
    p = _clip(torch.minimum(r0, r1), a, b)
    q = _clip(torch.maximum(r0, r1), a, b)

    def g(t):
        return torch.clamp(m * t + c, 0.0, 1.0)

    mid = c + (p + q) * (0.5 * m)
    return g(a) * (p - a) + mid * (q - p) + g(b) * (b - q)


def _break_eta(ma, ca, mb, cb):
    """Where the lower envelope switches from line a to line b."""
    dm = ma - mb
    parallel = dm.abs() <= f32(1e-9)
    side = torch.where(ca <= cb, torch.full_like(ca, f32(0.6)),
                       torch.full_like(ca, f32(-0.6)))
    return torch.where(
        parallel, side, div(cb - ca, torch.where(parallel, torch.ones_like(dm), dm))
    )


def halfplanes3_cell_coverage(d1, nx1, ny1, d2, nx2, ny2, d3, nx3, ny3):
    """Exact area of the unit cell inside the intersection of three
    half-planes ``{p : n_i . (p - centre) <= -d_i}``."""
    swap = nx1.abs() < ny1.abs()
    lead = torch.where(swap, ny1, nx1)
    s = torch.where(lead >= 0.0, torch.ones_like(lead), -torch.ones_like(lead))

    def graph(nx, ny, d):
        A = torch.where(swap, ny, nx)
        B = torch.where(swap, nx, ny)
        invA = div(1.0, torch.clamp(A * s, min=f32(1e-6)))
        return (-B * s) * invA, (-d) * invA

    m1, c1 = graph(nx1, ny1, d1)
    m2, c2 = graph(nx2, ny2, d2)
    m3, c3 = graph(nx3, ny3, d3)

    def cswap(ma, ca, mb, cb):
        p = ma < mb
        return (torch.where(p, mb, ma), torch.where(p, cb, ca),
                torch.where(p, ma, mb), torch.where(p, ca, cb))

    m1, c1, m2, c2 = cswap(m1, c1, m2, c2)
    m2, c2, m3, c3 = cswap(m2, c2, m3, c3)
    m1, c1, m2, c2 = cswap(m1, c1, m2, c2)
    t12 = _break_eta(m1, c1, m2, c2)
    t23 = _break_eta(m2, c2, m3, c3)
    t13 = _break_eta(m1, c1, m3, c3)
    mid = t12 <= t23
    ta = torch.clamp(torch.where(mid, t12, t13), -0.5, 0.5)
    tb = _clip(torch.where(mid, t23, t13), ta, torch.full_like(ta, 0.5))
    return (
        _clamped_line_integral(m1, c1 + 0.5, -0.5, ta)
        + _clamped_line_integral(m2, c2 + 0.5, ta, tb)
        + _clamped_line_integral(m3, c3 + 0.5, tb, 0.5)
    )


def ellipse_chord_coverage(ux, uy, jxx, jxy, jyx, jyy, steps: int = 100):
    """Per-pixel coverage (aa, inside) of the inscribed ``steps``-gon of the
    unit circle in normalised ellipse coordinates (ux, uy) with constant
    screen Jacobian [[jxx, jxy], [jyx, jyy]]."""
    nx_u, ny_u = _sector_center_dir(ux, uy, steps)
    cosd = f32(math.cos(2.0 * math.pi / steps))
    sind = f32(math.sin(2.0 * math.pi / steps))
    coshalf = f32(math.cos(math.pi / steps))

    def chord(nx, ny):
        a = nx * jxx + ny * jyx
        b = nx * jxy + ny * jyy
        norm = torch.clamp(sqrt(a * a + b * b), min=f32(1e-9))
        l = nx * ux + ny * uy - coshalf
        return div(l, norm), div(a, norm), div(b, norm)

    d1, a1, b1 = chord(nx_u, ny_u)
    d2, a2, b2 = chord(nx_u * cosd - ny_u * sind, ny_u * cosd + nx_u * sind)
    d3, a3, b3 = chord(nx_u * cosd + ny_u * sind, ny_u * cosd - nx_u * sind)
    aa = halfplanes3_cell_coverage(d1, a1, b1, d2, a2, b2, d3, a3, b3)
    return aa, aa >= 0.5


def ellipse_coverage(transform, rx, ry, px, py):
    """Coverage of an ellipse (radii rx, ry about the local origin) under the
    local -> screen affine ``transform`` (..., 2, 3), the leading dims
    batched against grids ``px``/``py`` (..., h, w)."""
    inv = invert(transform)
    i = [[inv[..., r, c, None, None] for c in range(3)] for r in range(2)]
    rx = rx[..., None, None] if torch.is_tensor(rx) else rx
    ry = ry[..., None, None] if torch.is_tensor(ry) else ry
    ux = div(i[0][0] * px + i[0][1] * py + i[0][2], rx)
    uy = div(i[1][0] * px + i[1][1] * py + i[1][2], ry)
    return ellipse_chord_coverage(
        ux, uy, div(i[0][0], rx), div(i[0][1], rx), div(i[1][0], ry),
        div(i[1][1], ry),
    )


def combine_additive(acc_aa, acc_in, aa, inside):
    """Screen-algebra union u | v: u = 1 - (1 - u)(1 - v)."""
    return 1.0 - (1.0 - acc_aa) * (1.0 - aa), acc_in | inside


def combine_subtractive(acc_aa, acc_in, aa, inside):
    """Screen-algebra subtraction u & ~v: u = u (1 - v)."""
    return acc_aa * (1.0 - aa), acc_in & ~inside
