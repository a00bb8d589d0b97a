"""Scene sampling (port of ``flowgen/params/sampler.py``).

Every quantity is a pure function of ``(seed, sample_index, stream, object,
component)`` through the per-sample threefry bits table
(``random/streams.py``). The JAX package vmaps one sample at a time; here the
batch, object and component axes are written out as leading tensor
dimensions, so one pass samples a whole batch. Float leaves follow the JAX
package's order of operations; the polygon compaction is an exact index
gather where the JAX package uses a one-hot matrix product.
"""

from __future__ import annotations

import math
import threading

import numpy as np
import torch

from .._fp import const, cos, div, f32, sin
from ..config import (
    EDGE_SUBDIV,
    ELLIPSE_STEPS,
    KIND_COMPOSITE,
    KIND_ELLIPSE,
    KIND_POLYGON,
    MAX_COMPONENTS,
    MAX_EDGES,
    MAX_OBJECTS,
    MAX_SPOKES,
    DataGenConfig,
    ModeSpec,
)
from ..ops import affine
from ..random import shapers
from ..random.streams import ScopeDraws, Stream, sample_bits_table, sample_key
from ..utils.profiling import span
from .blueprint import Background, Objects, Primitives, Scene, map_scene

SEG_DUMMY = 0
SEG_LINE = 1
SEG_CURVE = 2

# Bezier parameters t = i / EDGE_SUBDIV, divided in float32 as XLA does.
_SUB_T = np.arange(EDGE_SUBDIV, dtype=np.float32) / np.float32(EDGE_SUBDIV)


def _where(c, a, b):
    """``jnp.where`` with Python-scalar branches allowed on either side."""
    if not torch.is_tensor(a):
        a = (torch.full_like(b, a) if torch.is_tensor(b)
             else torch.full((), a, device=c.device))
    if not torch.is_tensor(b):
        b = torch.full_like(a, b)
    return torch.where(c, a, b)


def _triggered(d: ScopeDraws, s_trig, s_val, p, a, b, default, shaper):
    hit = shapers.trigger(p, d.uniform(s_trig, 0.0, 1.0))
    val = shaper(a, b, d.normal(s_val))
    return _where(hit, val, default)


# ---------------------------------------------------------------------------
# Polygon geometry
# ---------------------------------------------------------------------------


def _sample_spoke_polygon(d: ScopeDraws, spec: ModeSpec):
    """Star polygon with perturbed spoke angles and random radii
    (cpp:2206-2229, 2287-2316). Returns verts (..., S, 2), segment types
    (..., S) and the spoke count (...)."""
    S = MAX_SPOKES
    dev = d.row.device
    n = d.uniform_int(Stream.POLY_SPOKES, *spec.spokes_range)
    i = torch.arange(S, dtype=torch.float32, device=dev)
    dphi = d.uniform(Stream.POLY_DPHI, *spec.dphi_range_deg, (S,))
    phi = (div(i * 360.0, n.to(torch.float32)[..., None]) + dphi) * f32(
        math.pi / 180.0
    )
    r = d.uniform(Stream.POLY_R, *spec.spoke_r_range, (S,))
    xs = d.uniform(Stream.POLY_SCALE_X, *spec.poly_scale_range)
    ys = d.uniform(Stream.POLY_SCALE_Y, *spec.poly_scale_range)
    verts = torch.stack(
        [xs[..., None] * r * cos(phi), ys[..., None] * r * sin(phi)],
        dim=-1,
    )

    if spec.axis_aligned_rect:
        # Mode 1: fixed 4-spoke axis-aligned rectangle (cpp:2163-2183).
        x = r[..., 0] * xs
        y = r[..., 0] * ys
        sgn = const("rect_signs", dev, lambda: torch.tensor(
            [[1.0, -1.0], [1.0, 1.0], [-1.0, 1.0], [-1.0, -1.0]]))
        rect = sgn * torch.stack([x, y], -1)[..., None, :]
        verts = torch.zeros_like(verts)
        verts[..., :4, :] = rect
        n = torch.full_like(n, 4)
        types = torch.full(verts.shape[:-1], SEG_LINE, dtype=torch.int32,
                           device=dev)
        types[..., 0] = SEG_DUMMY
        return verts, types, n

    # Segment types with the reference's skip-next-after-curve walk
    # (cpp:2305-2315).
    curve_u = d.uniform(Stream.POLY_CURVE_TRIGGER, 0.0, 1.0, (S,))
    can_curve = spec.allow_curves and spec.curve_p > 0.0
    types = [torch.full_like(n, SEG_DUMMY)]
    prev_dummy = torch.zeros_like(n, dtype=torch.bool)
    for idx in range(1, S):
        if can_curve:
            is_curve = (
                (idx < n - 1) & (curve_u[..., idx] < f32(spec.curve_p))
                & ~prev_dummy
            )
        else:
            is_curve = torch.zeros_like(prev_dummy)
        t = torch.where(
            prev_dummy, SEG_DUMMY,
            torch.where(is_curve, SEG_CURVE, SEG_LINE),
        ).to(torch.int32)
        types.append(t)
        prev_dummy = is_curve
    return verts, torch.stack(types, -1), n


def _take_spoke(verts, idx):
    """verts[..., idx, :] for a per-scope index tensor idx (...)."""
    g = idx.long()[..., None, None].expand(idx.shape + (1, verts.shape[-1]))
    return torch.gather(verts, -2, g)


def flatten_outline(verts, types, n):
    """Flatten a (possibly curved) closed spoke outline to ``MAX_EDGES``
    points, compacted to the front (padding repeats point 0). Each half of a
    quadratic Bezier is sampled at ``EDGE_SUBDIV`` points; straight segments
    keep one point. Returns (points (..., MAX_EDGES, 2), n_points)."""
    S = MAX_SPOKES
    dev = verts.device
    e = torch.arange(S, device=dev)
    n_ = n.long()[..., None]
    last = e == n_ - 1                                     # (..., S)
    ve = verts
    v0 = verts[..., 0:1, :]
    v1 = verts[..., 1:2, :]
    va = torch.where(last[..., None], v0, torch.roll(verts, -1, dims=-2))
    vprev = torch.where(
        (e == 0)[..., None], _take_spoke(verts, n - 1),
        torch.roll(verts, 1, dims=-2),
    )
    vnext = torch.where(
        last[..., None], v1,
        torch.where((e == n_ - 2)[..., None], v0,
                    torch.roll(verts, -2, dims=-2)),
    )
    ta = torch.where(last, types[..., 0:1], torch.roll(types, -1, dims=-1))
    a_nonzero = ~last

    t = const("sub_t", dev, lambda: torch.from_numpy(_SUB_T))[:, None]

    def bezier(p0, c, p1, s):
        p0, c, p1 = p0[..., None, :], c[..., None, :], p1[..., None, :]
        om = 1 - s
        return (om * om) * p0 + ((2 * s) * om) * c + (s * s) * p1

    line_pts = ve[..., None, :] + t * (va - ve)[..., None, :]
    first_half = bezier(ve, va, vnext, t * 0.5)
    second_half = bezier(vprev, ve, va, 0.5 + t * 0.5)

    case_cfirst = (ta == SEG_CURVE) & a_nonzero
    case_csecond = (ta == SEG_DUMMY) & a_nonzero
    is_curve_slot = case_cfirst | case_csecond
    pts = torch.where(
        case_cfirst[..., None, None], first_half,
        torch.where(case_csecond[..., None, None], second_half, line_pts),
    )                                                      # (..., S, SUB, 2)

    # Compaction as an exact gather: output row j takes the unique kept
    # spoke whose [start, cum) interval holds j, at sub-offset j - start
    # (curve slots keep all subdivisions, line slots sub 0 only).
    per_spoke = torch.where(is_curve_slot, EDGE_SUBDIV, 1) * (e < n_)
    cum = torch.cumsum(per_spoke, dim=-1)
    start = cum - per_spoke
    n_pts = cum[..., -1]
    j = torch.arange(MAX_EDGES, device=dev)
    spoke = (cum[..., None, :] <= j[:, None]).sum(-1).clamp(max=S - 1)
    start_j = torch.gather(start, -1, spoke)
    curve_j = torch.gather(is_curve_slot, -1, spoke)
    off = torch.where(curve_j, j - start_j, 0)
    flat = spoke * EDGE_SUBDIV + off
    flat = torch.where(j < n_pts[..., None], flat, 0)
    src = pts.reshape(pts.shape[:-3] + (S * EDGE_SUBDIV, 2))
    out = torch.gather(src, -2, flat[..., None].expand(flat.shape + (2,)))
    return out, n_pts.to(torch.int32)


def _sample_geometry(d: ScopeDraws, spec: ModeSpec, kinds):
    """One primitive's kind, ellipse radii and flattened outline."""
    kind = shapers.choice(
        const(("kinds", kinds), d.row.device,
              lambda: torch.tensor(kinds, dtype=torch.int32)),
        d.raw_index(Stream.OBJ_TYPE),
    )
    f = spec.ellipse_radius_factor
    rx = d.uniform(Stream.ELLI_SCALE_X, *spec.ellipse_scale_range) * f
    ry = d.uniform(Stream.ELLI_SCALE_Y, *spec.ellipse_scale_range) * f
    verts, types, n = _sample_spoke_polygon(d, spec)
    edge_pts, n_edges = flatten_outline(verts, types, n)
    return kind, rx, ry, edge_pts, n_edges


# ---------------------------------------------------------------------------
# Scene sampling
# ---------------------------------------------------------------------------


def sample_background(d: ScopeDraws, spec: ModeSpec, width, height,
                      n_warp_slots):
    """generateBackground (cpp:2105-2143) over the sample-level scope rows."""
    rot = _triggered(
        d, Stream.BG_ROT_TRIGGER, Stream.BG_ROT,
        spec.bg_rot_p, *spec.bg_rot_range, 0.0, shapers.gaussian_sq,
    )
    scale = _triggered(
        d, Stream.BG_SCALE_TRIGGER, Stream.BG_SCALE,
        spec.bg_scale_p, *spec.bg_scale_range, 1.0, shapers.gaussian_sq,
    )
    pre_tx = shapers.gaussian_4(*spec.bg_trans_range, d.normal(Stream.BG_TRANS_X))
    pre_ty = shapers.gaussian_4(*spec.bg_trans_range, d.normal(Stream.BG_TRANS_Y))
    if spec.horizontal_only:
        pre_ty = torch.zeros_like(pre_ty)
    tx = cos(-rot) * pre_tx - sin(-rot) * pre_ty
    ty = sin(-rot) * pre_tx + cos(-rot) * pre_ty
    motion = affine.motion_transform(rot, scale, tx, ty)

    dev = d.row.device
    tex_id = d.raw_index(Stream.BG_TEX_ID)
    tex_rot = d.uniform(Stream.BG_INIT_ROT, *spec.bg_init_rot_range)
    tex_zoom = d.uniform(Stream.BG_INIT_SCALE, *spec.bg_init_scale_range)
    shift_x = shapers.choice(
        const(("bg_shift", float(width)), dev,
              lambda: torch.tensor([0.0, float(width)])),
        d.raw_index(Stream.BG_INIT_TRANS_X),
    )
    shift_y = shapers.choice(
        const(("bg_shift", float(height)), dev,
              lambda: torch.tensor([0.0, float(height)])),
        d.raw_index(Stream.BG_INIT_TRANS_Y),
    )
    warp = shapers.trigger(
        spec.warp_p, d.uniform(Stream.OBJ_DEFORMS_NONRIGIDLY, 0.0, 1.0)
    )
    warp_slot = d.uniform_int(Stream.WARP_ASSIGN, 0, max(n_warp_slots - 1, 0))
    return Background(
        motion=motion,
        tex_id=tex_id,
        tex_rot_deg=tex_rot,
        tex_zoom=tex_zoom,
        tex_shift=torch.stack([shift_x, shift_y], -1),
        warp=warp,
        warp_slot=warp_slot,
    )


def sample_scene(skeys, spec: ModeSpec, *, width: int, height: int,
                 n_warp_slots: int = 1) -> Scene:
    """Sample a batch of scene blueprints from per-sample keys (B, 2)."""
    K, C = MAX_OBJECTS, MAX_COMPONENTS
    dev = skeys.device
    w2, h2 = width / 2.0, height / 2.0
    m = spec.obj_init_trans_margin

    bits = sample_bits_table(skeys, 1 + K + K * C)        # (B, 1+K+KC, S)
    d0 = ScopeDraws(bits[:, 0])
    bg = sample_background(d0, spec, width, height, n_warp_slots)
    ok = ScopeDraws(bits[:, 1 : 1 + K])                   # (B, K, S)
    ck = ScopeDraws(bits[:, 1 + K :].reshape(bits.shape[0], K, C, -1))

    n_objects = d0.uniform(Stream.NUM_FG_OBJECTS, *spec.n_fg_range).to(
        torch.int32
    )
    ks = torch.arange(K, device=dev)
    valid = ks < n_objects[:, None]                       # (B, K)

    non_composite = tuple(k for k in spec.obj_types if k != KIND_COMPOSITE)

    obj_kind, s_rx, s_ry, s_pts, s_ne = _sample_geometry(ok, spec, spec.obj_types)
    is_comp = obj_kind == KIND_COMPOSITE

    init_rot = ok.uniform(Stream.OBJ_INIT_ROT, *spec.obj_init_rot_range)
    init_tx = ok.uniform(Stream.OBJ_INIT_TRANS_X, -w2 - m, 3 * w2 + m)
    init_ty = ok.uniform(Stream.OBJ_INIT_TRANS_Y, -h2 - m, 3 * h2 + m)
    rot = _triggered(
        ok, Stream.OBJ_ROT_TRIGGER, Stream.OBJ_ROT,
        spec.obj_rot_p, *spec.obj_rot_range, 0.0, shapers.gaussian_sq,
    )
    scale = _triggered(
        ok, Stream.OBJ_SCALE_TRIGGER, Stream.OBJ_SCALE,
        spec.obj_scale_p, *spec.obj_scale_range, 1.0, shapers.gaussian_sq,
    )
    tx = shapers.gaussian_cube(*spec.obj_trans_range, ok.normal(Stream.OBJ_TRANS_X))
    ty = shapers.gaussian_cube(*spec.obj_trans_range, ok.normal(Stream.OBJ_TRANS_Y))
    if spec.horizontal_only:
        ty = torch.zeros_like(ty)
    tex_id = ok.raw_index(Stream.OBJ_TEX_ID)
    thin = shapers.trigger(
        spec.thin_p, ok.uniform(Stream.OBJ_IS_EXTRA_THIN, 0.0, 1.0)
    ) & bool(spec.use_thin)
    warp = shapers.trigger(
        spec.warp_p, ok.uniform(Stream.OBJ_DEFORMS_NONRIGIDLY, 0.0, 1.0)
    )
    warp_slot = ok.uniform_int(Stream.WARP_ASSIGN, 0, max(n_warp_slots - 1, 0))
    motion = affine.motion_transform(rot, scale, tx, ty)  # (B, K, 2, 3)

    # --- component-slot geometry (used when the object is a composite) ---
    c_kind, c_rx, c_ry, c_pts, c_ne = _sample_geometry(ck, spec, non_composite)
    c_init_rot = ck.uniform(Stream.OBJ_INIT_ROT, *spec.obj_init_rot_range)
    off_x = ck.uniform(Stream.COMP_OFFSET, *spec.component_offset_range)
    off_y = ck.uniform(Stream.COMP_OFFSET_Y, *spec.component_offset_range)
    c_add = shapers.trigger(
        spec.component_additive_p,
        ck.uniform(Stream.COMP_IS_ADDITIVE, 0.0, 1.0),
    )
    n_parts = ok.uniform_int(Stream.COMP_NUM_COMPONENTS, *spec.n_components_range)

    cs = torch.arange(C, device=dev)
    e1 = lambda x: x[..., None]                            # (B,K) -> (B,K,1)

    # Regular composite (cpp:2384-2428 / 2549-2592).
    reg_valid = cs < e1(n_parts)
    is_primary = cs == 0
    shrink = _where(is_primary, 1.0,
                    torch.full((C,), f32(spec.component_shrink), device=dev))
    reg_rot = torch.where(is_primary, e1(init_rot), c_init_rot)
    reg_tx = torch.where(is_primary, e1(init_tx), e1(init_tx) + off_x)
    reg_ty = torch.where(is_primary, e1(init_ty), e1(init_ty) + off_y)
    reg_add = is_primary | c_add
    reg_rx = c_rx * shrink
    reg_ry = c_ry * shrink
    reg_pts = c_pts * shrink[:, None, None]

    # Thin composite, "outline" style (cpp:2504-2547 / 2668-2713).
    ell_offset = (c_kind[..., 0] == KIND_ELLIPSE) & shapers.trigger(
        spec.generic_p, ok.uniform(Stream.GENERIC_TRIGGER, 0.0, 1.0)
    )
    o_dx = ok.uniform(Stream.COMP_INIT_TRANS_X, *spec.comp_init_trans_range)
    o_dy = ok.uniform(Stream.COMP_INIT_TRANS_Y, *spec.comp_init_trans_range)
    inner_scale = _where(ell_offset, 1.0, f32(spec.outline_shrink))
    thin_valid = (cs < 2).expand(reg_valid.shape)
    is_outer = cs == 0
    thin_kind = c_kind[..., 0:1].expand(c_kind.shape)
    thin_rx = torch.where(is_outer, c_rx[..., 0:1], c_rx[..., 0:1] * e1(inner_scale))
    thin_ry = torch.where(is_outer, c_ry[..., 0:1], c_ry[..., 0:1] * e1(inner_scale))
    pts0 = c_pts[..., 0:1, :, :]
    poly_shrink = _where(c_kind[..., 0] == KIND_POLYGON,
                         f32(spec.outline_shrink), 1.0)
    thin_pts = torch.where(
        is_outer[:, None, None], pts0, pts0 * poly_shrink[..., None, None, None]
    )
    keep = is_outer | ~e1(ell_offset)
    thin_tx = torch.where(keep, e1(init_tx), e1(init_tx + o_dx))
    thin_ty = torch.where(keep, e1(init_ty), e1(init_ty + o_dy))
    thin_rot = e1(init_rot).expand(reg_rot.shape)
    thin_add = is_outer.expand(reg_add.shape)

    # Simple object (one primitive in slot 0); thin needles shrink the local
    # x axis by thin_shrink (cpp:2462-2464, 2496-2500).
    needle = thin & ~is_comp
    simple_valid = (cs == 0).expand(reg_valid.shape)
    simple_rx = torch.where(needle, s_rx * f32(spec.thin_shrink), s_rx)
    one = torch.ones(2, device=dev)
    nshrink = const(("needle_shrink", f32(spec.thin_shrink)), dev,
                    lambda: torch.tensor([f32(spec.thin_shrink), 1.0]))
    simple_pts = s_pts * torch.where(needle[..., None, None], nshrink, one)
    # Thin needle ellipses take the literal 100-gon polygon path.
    ell_needle = needle & (obj_kind == KIND_ELLIPSE)
    ang = torch.arange(ELLIPSE_STEPS, dtype=torch.float32, device=dev) * f32(
        2.0 * math.pi / ELLIPSE_STEPS
    )
    gon = torch.stack(
        [cos(ang) * e1(s_rx * f32(spec.thin_shrink)),
         sin(ang) * e1(s_ry)], -1,
    )                                                     # (B,K,100,2)
    gon = torch.cat(
        [gon, gon[..., :1, :].expand(gon.shape[:-2] + (MAX_EDGES - ELLIPSE_STEPS, 2))],
        dim=-2,
    )
    simple_pts = torch.where(ell_needle[..., None, None], gon, simple_pts)
    simple_ne = torch.where(ell_needle, ELLIPSE_STEPS, s_ne).to(torch.int32)
    simple_poly = (obj_kind == KIND_POLYGON) | ell_needle

    comp_thin = thin

    def pick(simple, thin_v, reg_v):
        return torch.where(
            e1(is_comp), torch.where(e1(comp_thin), thin_v, reg_v), simple
        )

    prim_valid = pick(simple_valid, thin_valid, reg_valid) & e1(valid)
    prim_add = pick(torch.ones_like(reg_add), thin_add, reg_add)
    prim_is_poly = pick(
        e1(simple_poly).expand(reg_add.shape),
        thin_kind == KIND_POLYGON,
        c_kind == KIND_POLYGON,
    )
    prim_rx = pick(e1(simple_rx).expand(reg_rx.shape), thin_rx, reg_rx)
    prim_ry = pick(e1(s_ry).expand(reg_ry.shape), thin_ry, reg_ry)
    prim_rot = pick(e1(init_rot).expand(reg_rot.shape), thin_rot, reg_rot)
    prim_tx = pick(e1(init_tx).expand(reg_tx.shape), thin_tx, reg_tx)
    prim_ty = pick(e1(init_ty).expand(reg_ty.shape), thin_ty, reg_ty)
    prim_pts = torch.where(
        is_comp[..., None, None, None],
        torch.where(comp_thin[..., None, None, None], thin_pts, reg_pts),
        simple_pts[:, :, None].expand(reg_pts.shape),
    )
    prim_ne = pick(
        e1(simple_ne).expand(c_ne.shape), c_ne[..., 0:1].expand(c_ne.shape),
        c_ne,
    )
    prim_intrinsic = affine.intrinsic_transform(prim_rot, prim_tx, prim_ty)

    # Fold the conjugated background motion into every object's motion
    # (addBackgroundMotion, cpp:324-335).
    bg_conj = affine.conjugate_about(bg.motion, w2, h2)
    motion_total = affine.compose(motion, bg_conj[:, None])

    objects = Objects(
        valid=valid,
        tex_id=tex_id,
        motion=motion_total,
        motion_inv=affine.invert(motion_total),
        warp=warp,
        warp_slot=warp_slot,
    )
    prims = Primitives(
        valid=prim_valid,
        additive=prim_add,
        is_poly=prim_is_poly,
        intrinsic=prim_intrinsic,
        ell_rx=prim_rx,
        ell_ry=prim_ry,
        edge_pts=prim_pts,
        n_edges=prim_ne.to(torch.int32),
    )
    return Scene(background=bg, objects=objects, prims=prims, n_objects=n_objects)


# ---------------------------------------------------------------------------
# The batch entry point: one CUDA graph per (device, mode, frame, slots, batch)
# ---------------------------------------------------------------------------

_GRAPHS: dict = {}
_GRAPH_LOCK = threading.Lock()
_GRAPH_STATS = {"capture": 0, "replay": 0, "eager": 0}


class _SamplerGraph:
    """``run(root, indices)`` captured once in a CUDA graph whose static
    inputs are the root key (2,) and the sample indices (B,), int64 on the
    device. The first call warms ``run`` up eagerly on a side stream (which
    also fills the constant caches it reads) and captures it there; every
    call copies its inputs in, replays the graph on the current stream and
    returns clones of the graph's outputs, which the next replay
    overwrites. The replayed kernels are the eager ones on the same inputs,
    so the scenes are the eager scenes bit for bit."""

    def __init__(self, dev, n, run):
        self.dev = dev
        self.run = run
        self.root = torch.empty(2, dtype=torch.int64, device=dev)
        self.idx = torch.empty(n, dtype=torch.int64, device=dev)
        self.graph = None
        self.out = None
        # Recorded after each call's clones, so that a call on another
        # stream does not overwrite inputs or outputs still being read.
        self.done = torch.cuda.Event()

    def __call__(self, root, sample_indices):
        with torch.cuda.device(self.dev):
            cur = torch.cuda.current_stream()
            cur.wait_event(self.done)
            self.root.copy_(root)
            self.idx.copy_(torch.as_tensor(sample_indices))
            if self.graph is None:
                self._capture(cur)
            self.graph.replay()
            out = map_scene(torch.clone, self.out)
            self.done.record(cur)
            return out

    def _capture(self, cur):
        side = torch.cuda.Stream()
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            self.run(self.root, self.idx)
        cur.wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=side,
                              capture_error_mode="thread_local"):
            self.out = self.run(self.root, self.idx)
        self.graph = graph


def _graph_key(root, sample_indices, cfg: DataGenConfig, n_warp_slots):
    """The key of the sampler's graph for these inputs, or None where the
    call runs eagerly: a root that is not one (2,) int64 key on a CUDA
    device, indices that are not one batch, or a stream that is itself
    being captured."""
    if not (torch.is_tensor(root) and root.is_cuda and root.shape == (2,)
            and root.dtype == torch.int64):
        return None
    shape = (tuple(sample_indices.shape) if torch.is_tensor(sample_indices)
             else np.shape(sample_indices))
    if len(shape) != 1 or torch.cuda.is_current_stream_capturing():
        return None
    return (root.device, cfg.mode_spec, cfg.width, cfg.height, n_warp_slots,
            shape[0])


def sampler_graph_stats() -> dict:
    """How often :func:`sample_scene_batch` captured a graph, replayed one
    and ran eagerly, since the process started."""
    with _GRAPH_LOCK:
        return dict(_GRAPH_STATS)


def sample_scene_batch(root, sample_indices, cfg: DataGenConfig, n_warp_slots=1):
    """Scene blueprints for a batch of global sample indices.

    On a CUDA device the sampler's few thousand small launches replay from
    one CUDA graph per (device, mode, frame, warp slots, batch size)
    (:class:`_SamplerGraph`), captured on the key's first call; elsewhere
    the sampler runs eagerly. The ``flowgen.sampler`` span's argument says
    which: ``capture``, ``replay`` or ``eager``."""

    def run(r, idx):
        return sample_scene(sample_key(r, idx), cfg.mode_spec,
                            width=cfg.width, height=cfg.height,
                            n_warp_slots=n_warp_slots)

    key = _graph_key(root, sample_indices, cfg, n_warp_slots)
    if key is None:
        with span("flowgen.sampler", "eager"):
            with _GRAPH_LOCK:
                _GRAPH_STATS["eager"] += 1
            return run(root, sample_indices)
    with _GRAPH_LOCK:
        graph = _GRAPHS.get(key)
        how = "capture" if graph is None else "replay"
        with span("flowgen.sampler", how):
            _GRAPH_STATS[how] += 1
            if graph is None:
                graph = _GRAPHS[key] = _SamplerGraph(root.device, key[-1],
                                                     run)
            return graph(root, sample_indices)
