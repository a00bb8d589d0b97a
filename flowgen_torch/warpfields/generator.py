"""Warp-crop bank and the scene kernel's warp planes for mode 9 (port of
``flowgen/warpfields/generator.py``).

Each bank epoch (``step // warp_bank_reuse_steps``) derives
``warp_fields_per_batch`` composed big fields from ``(seed, epoch)``, tiles
them into crops (the bank, ``make_warp_bank``, which the windowed renderer
samples), and for the scene kernel solves the separable warp's column
inverse once per big field (``make_bank_and_aux``). Objects
and backgrounds index the crops through their sampled warp slots.

``cfg.warp_bank_impl`` picks the content stream, never the device: the
default ``"pallas"`` composes through ``warpfields/compose.py`` (CUDA
kernels on the card, their plain versions on the CPU, the same bits on
both); ``"xla"`` composes by quad-gather lookups (``fields.self_compose``)
and solves the column inverse by a gather fixed point (:func:`_gdisp_xla`),
plain PyTorch on either device, as XLA in the JAX package.

On the card ``pipeline/generator.py:make_generate_fn`` replays an epoch's
scene-kernel planes from CUDA graphs (:class:`BankAuxGraphs`), whose inputs
are the root key and the epoch index.
An epoch's build names its phases in a profile: ``flowgen.bank_fields``
(displacer grids and elementary fields, on the card one
``fields.elementary_field`` kernel), ``flowgen.bank_compose`` (the
doublings) and, in :func:`make_bank_and_aux`, ``flowgen.bank_aux``.
"""

from __future__ import annotations

import torch

from ..compose.render import WarpAux, WarpBank
from ..config import DataGenConfig
from ..ops.scene import BG_EY, bg_band_starts
from ..ops.texture import sample_bilinear
from ..random.streams import Stream, sample_key
from ..utils.profiling import span
from . import compose, fields
from .fields import _upsample2, sample_displacer_grid, stack_grids

# Finite stand-in for the reference's NaN flow at flagged bank pixels under
# ``warp_oob="nan"``: it rides through the kernels' linear resampling and is
# decoded back to NaN at output adaptation (pipeline/generator._adapt_output).
OOB_SENTINEL = 4.0e18
OOB_FLOW_THRESH = 1.0e9


def apply_oob_policy(bank: WarpBank, policy: str) -> WarpBank:
    """``warp_oob``: "zero" passes through; "nan" replaces flagged
    forward-flow pixels with OOB_SENTINEL. The inverse field is kept."""
    if policy == "nan":
        return bank._replace(flow=torch.where(
            torch.isnan(bank.flow), torch.full_like(bank.flow, OOB_SENTINEL),
            bank.flow))
    return bank


def big_field_size(width: int, height: int) -> int:
    return 3 * max(width, height)


def crop_origins(width: int, height: int):
    """Static crop tiling of the big field: stride (W/3, H/3), margins
    W/4 .. big - 5W/4."""
    big = big_field_size(width, height)
    xs = list(range(width // 4, big - 5 * width // 4, width // 3))
    ys = list(range(height // 4, big - 5 * height // 4, height // 3))
    return [(x, y) for y in ys for x in xs]


def n_crops_per_field(width: int, height: int) -> int:
    return len(crop_origins(width, height))


def bank_size(cfg: DataGenConfig) -> int:
    return n_crops_per_field(cfg.width, cfg.height) * cfg.warp_fields_per_batch


def _stream_of(cfg: DataGenConfig, impl):
    impl = cfg.warp_bank_impl if impl is None else impl
    if impl not in ("pallas", "xla"):
        raise ValueError(f"unknown warp bank stream {impl!r}")
    return impl


def _step_keys(root, step, cfg: DataGenConfig):
    """The big-field keys (F, 2) of step ``step``'s bank epoch: ``root``
    folded by the epoch, then each field's ``Stream.WARP_FIELD`` key."""
    epoch = int(step) // max(cfg.warp_bank_reuse_steps, 1)
    return _field_keys(root, _index(root, epoch), cfg.warp_fields_per_batch)


def _index(key, i: int):
    """``i`` as an int64 scalar on ``key``'s device, filled there: no
    host-to-device copy."""
    return torch.full((), int(i), dtype=torch.int64, device=key.device)


def _field_keys(root, epoch, n: int):
    """:func:`_step_keys` of an epoch index already on the device:
    ``stream_key(fold_in(root, epoch), Stream.WARP_FIELD, i)`` for i < n,
    folded by device scalars."""
    k = sample_key(root, epoch)
    k = sample_key(k, _index(k, int(Stream.WARP_FIELD)))
    return torch.stack([sample_key(k, _index(k, i)) for i in range(n)])


def _big_fields(keys, cfg: DataGenConfig, impl=None):
    """The composed big fields and their inverses of the field keys
    ``keys`` (F, 2): (flows, iflows), each (F, 2, big, big) planes x, y
    with NaN at flagged pixels, in the content stream ``impl`` (default
    ``cfg.warp_bank_impl``). All 2F directions compose together, through
    shared launches."""
    impl = _stream_of(cfg, impl)
    big = big_field_size(cfg.width, cfg.height)
    with span("flowgen.bank_fields"):
        grids, flags = [], []
        for key in keys:
            g = sample_displacer_grid(key, big)
            grids += [g, g]
            flags += [False, True]
        grid, inverse = stack_grids(grids, flags)
        f_h = fields.elementary_field(grid, big // 2, inverse, stride=2.0) * 0.5
    with span("flowgen.bank_compose"):
        out = (compose.compose_big_fields if impl == "pallas"
               else fields.compose_big_fields)(f_h)
    return out[0::2], out[1::2]


def _crops(planes, cfg: DataGenConfig):
    """(F, C, big, big) -> (F * n_crops, C, H, W), field-major."""
    H, W = cfg.height, cfg.width
    return torch.cat([
        torch.stack([f[:, y : y + H, x : x + W] for (x, y) in
                     crop_origins(W, H)])
        for f in planes
    ])


def _crop_bank(flows, iflows, cfg: DataGenConfig) -> WarpBank:
    bank = WarpBank(
        flow=_crops(flows, cfg).permute(0, 2, 3, 1).contiguous(),
        iflow=_crops(iflows, cfg).permute(0, 2, 3, 1).contiguous(),
    )
    return apply_oob_policy(bank, cfg.warp_oob)


def make_warp_bank(root, step, cfg: DataGenConfig, impl=None) -> WarpBank:
    """The crop bank of one bank epoch, without the scene kernel's warp
    planes: what the windowed renderer samples (mode 9 off the fused
    path). ``impl``: the content stream, "pallas" or "xla", or None to
    follow ``cfg.warp_bank_impl``; a config dial, never chosen by the
    device."""
    return _crop_bank(*_big_fields(_step_keys(root, step, cfg), cfg, impl),
                      cfg)


def _half_offset_expand(p, axis: int, c0: int, n_pairs: int):
    """Clamped linear sampling of ``p`` along ``axis`` at the x2 lattice
    ``c0 + j/2 + 0.75``, j = 0..2*n_pairs-1 (fractions 0.75 / 0.25
    alternate): edge-clamped slices and lerps, no gathers."""
    n = p.shape[axis]
    idx = torch.clamp(torch.arange(c0, c0 + n_pairs + 2, device=p.device),
                      0, n - 1)
    q = p.index_select(axis, idx)
    a, b, c = (q.narrow(axis, s, n_pairs) for s in (0, 1, 2))
    even = 0.25 * a + 0.75 * b
    odd = 0.75 * b + 0.25 * c
    out = torch.stack([even, odd], dim=axis + 1)
    shape = list(p.shape)
    shape[axis] = 2 * n_pairs
    return out.reshape(shape)


def _gdisp_xla(D, n_iter: int = 4, coarse: int = 4):
    """Pass-1 x-displacement with the column-inverse correction for
    displacement fields ``D`` (N, Hh, W, 2) in pixels, the ``"xla"``
    stream's solve: gdisp(x, w) = D_x(x, y*) where w = y* + D_y(x, y*),
    ``n_iter`` clamped-bilinear fixed-point steps on the ``coarse``-strided
    lattice, then ``coarse.bit_length() - 1`` x2 plane upsamples. The lerps
    are FMAs, as XLA:CPU compiles the JAX package's step. Returns (N, Hh,
    W)."""
    N, Hh, Ww = D.shape[:3]
    ar = [torch.arange(n // coarse, dtype=torch.float32, device=D.device)
          * coarse for n in (Hh, Ww)]
    yy, xx = (t.expand(N, -1, -1) for t in torch.meshgrid(*ar, indexing="ij"))

    def lookup(c, y):
        return sample_bilinear(D[..., c : c + 1], xx, y, wrap="clamp",
                               contract=True)[..., 0]

    y = yy
    for _ in range(n_iter):
        y = yy - lookup(1, y)
    gd = lookup(0, y)
    for _ in range(coarse.bit_length() - 1):
        gd = _upsample2(gd)
    return gd


def bg_upscale(iflow, bg_ey: int):
    """The background's x2-upscaled displacement fields on the extended
    frame grid: ``D(y, x) = 2 * iflow((x + W/2 + .5)/2 - .5, (y + H/2 +
    .5)/2 - .5)`` for rows y in [-bg_ey, H + bg_ey), by interleaved
    slice-lerps. ``iflow`` (N, H, W, 2) -> (N, H + 2*bg_ey, W, 2)."""
    H, W = iflow.shape[1], iflow.shape[2]
    rows = _half_offset_expand(iflow, 1, H // 4 - bg_ey // 2 - 1,
                               (H + 2 * bg_ey) // 2)
    return 2.0 * _half_offset_expand(rows, 2, W // 4 - 1, W // 2)


def make_warp_aux(bank: WarpBank, n_iter=None, coarse: int = 4,
                  use_pallas=None) -> WarpAux:
    """The scene kernel's warp planes of a crop bank passed without them,
    solved per crop: ``WarpAux(obj, bg, bg_band)``, ``obj`` (N, 4, H, W) =
    [gdisp, iflow_y, flow_x, flow_y] and ``bg`` (N, 2, H + 2*BG_EY, W) =
    [gdisp, iflow_y] of the background's x2-upscaled field
    (:func:`bg_upscale`), the JAX package's ``(obj_aux, bg_aux)``.
    ``use_pallas``: True solves with ``compose.coarse_gdisp_batch`` (its
    CUDA kernels on the card, its plain version on the CPU; ``n_iter``
    default 8), False with :func:`_gdisp_xla` (``n_iter`` default 4), both
    at lattice stride ``coarse``; None follows the device as the JAX
    function follows the backend: the kernel on the card, :func:`_gdisp_xla`
    on the CPU."""
    iflow = torch.nan_to_num(bank.iflow)
    flow = torch.nan_to_num(bank.flow)
    D_bg = bg_upscale(iflow, BG_EY)
    if use_pallas is None:
        use_pallas = iflow.device.type == "cuda"
    if use_pallas:
        def solve(D):
            return compose.coarse_gdisp_batch(D, coarse, n_iter or 8)
    else:
        def solve(D):
            return _gdisp_xla(D, n_iter or 4, coarse)
    obj = torch.cat([solve(iflow)[:, None], iflow[..., 1][:, None],
                     flow.movedim(-1, 1)], dim=1).contiguous()
    bg = torch.stack([solve(D_bg), D_bg[..., 1]], dim=1).contiguous()
    return WarpAux(obj, bg, bg_band_starts(bg))


def make_bank_and_aux(root, step, cfg: DataGenConfig, impl=None,
                      n_iter=None, coarse: int = 4):
    """Bank and scene-kernel warp planes from shared big fields, the
    hot-path producer: one column-inverse solve per big field replaces the
    per-crop solves (a crop's column is a sub-segment of its field's, and
    the solve commutes with the background's x2 zoom). Returns ``(bank,
    WarpAux(obj, bg, bg_band))``: obj (N, 4, H, W) = [gdisp, iflow_y,
    flow_x, flow_y]; bg (N, 2, H + 2*BG_EY, W) = [gdisp, iflow_y] of the
    x2-upscaled background field; bg_band the background warp's pass-1
    bands of those planes (``ops/scene.py:bg_band_starts``). ``impl``
    (default ``cfg.warp_bank_impl``) picks the stream of both the fields
    and the solve: ``coarse_gdisp_batch`` for "pallas" (``n_iter`` default
    8), :func:`_gdisp_xla` for "xla" (default 4), both at lattice stride
    ``coarse``."""
    return _keyed_bank_and_aux(_step_keys(root, step, cfg), cfg, impl, n_iter,
                               coarse)


def _keyed_bank_and_aux(keys, cfg: DataGenConfig, impl, n_iter, coarse):
    """:func:`make_bank_and_aux` of the epoch's field keys (F, 2)."""
    impl = _stream_of(cfg, impl)
    flows, iflows = _big_fields(keys, cfg, impl)
    with span("flowgen.bank_aux"):
        return _bank_and_aux(flows, iflows, cfg, impl, n_iter, coarse)


def _bank_and_aux(flows, iflows, cfg: DataGenConfig, impl, n_iter, coarse):
    """:func:`make_bank_and_aux` after the big fields: the crop bank, the big
    fields' column-inverse solve, the crops of the object planes and the
    background's x2-upscaled planes with their bands."""
    W, H = cfg.width, cfg.height
    origins = crop_origins(W, H)
    bank = _crop_bank(flows, iflows, cfg)

    big_i = torch.nan_to_num(iflows)
    if cfg.warp_oob == "nan":
        flows = torch.where(torch.isnan(flows),
                            torch.full_like(flows, OOB_SENTINEL), flows)
    big_f = torch.nan_to_num(flows)
    D = big_i.permute(0, 2, 3, 1)
    gd_big = (compose.coarse_gdisp_batch(D, coarse, n_iter or 8)
              if impl == "pallas" else _gdisp_xla(D, n_iter or 4, coarse))
    big4 = torch.stack([gd_big, big_i[:, 1], big_f[:, 0], big_f[:, 1]], dim=1)
    obj_aux = _crops(big4, cfg)                             # (N, 4, H, W)

    big2 = torch.stack([gd_big, big_i[:, 1]], dim=1)        # (F, 2, S, S)
    n_pairs_r = (H + 2 * BG_EY) // 2
    per_origin = []
    for (x, y) in origins:
        r = _half_offset_expand(big2, 2, y + H // 4 - BG_EY // 2 - 1, n_pairs_r)
        per_origin.append(
            2.0 * _half_offset_expand(r, 3, x + W // 4 - 1, W // 2))
    bg_aux = torch.stack(per_origin, dim=1).reshape(
        -1, 2, H + 2 * BG_EY, W).contiguous()
    return bank, WarpAux(obj_aux.contiguous(), bg_aux, bg_band_starts(bg_aux))


class BankAuxGraphs:
    """``make_bank_and_aux(root, step, cfg)[1]``, the scene kernel's warp
    planes of a bank epoch in the ``"pallas"`` stream, replayed from CUDA
    graphs on ``dev``: one for each parity of the epoch index, captured on
    its first call, with the root key (2,) and the epoch index (int64 on
    the device) as inputs. An epoch's build is thousands of small launches
    from the host; a replay is one.

    The planes a call returns are its graph's outputs, not copies: the next
    call of the same parity overwrites them, in the order of the calling
    stream, so a caller holds at most one epoch of each parity
    (``pipeline/generator.py:BankEpochCache``) and reads the planes on that
    stream. The first capture follows one eager build on a side stream,
    which loads the kernels and fills the constants they read. The replayed
    kernels are the eager ones on the same inputs, so the planes are the
    eager planes bit for bit. ``captures`` and ``replays`` count the
    calls; the kernels' launch counters (``compose.hwarp_rows.launches``,
    ``compose.coarse_gdisp_batch.launches``,
    ``fields.elementary_field.launches``) count the warm-up's and the
    captures' launches, not the replays'."""

    def __init__(self, cfg: DataGenConfig, dev):
        self.cfg = cfg
        self.dev = torch.device(dev)
        self.root = torch.empty(2, dtype=torch.int64, device=self.dev)
        self.epoch = torch.empty((), dtype=torch.int64, device=self.dev)
        self.graphs, self.out = [None, None], [None, None]
        self.captures = self.replays = 0

    def _run(self):
        keys = _field_keys(self.root, self.epoch, self.cfg.warp_fields_per_batch)
        return _keyed_bank_and_aux(keys, self.cfg, "pallas", None, 4)[1]

    def __call__(self, root, step) -> WarpAux:
        epoch = int(step) // max(self.cfg.warp_bank_reuse_steps, 1)
        slot = epoch % 2
        with torch.cuda.device(self.dev):
            cur = torch.cuda.current_stream()
            self.root.copy_(root)
            self.epoch.fill_(epoch)
            if self.graphs[slot] is None:
                self._capture(slot, cur)
            self.graphs[slot].replay()
            self.replays += 1
            return self.out[slot]

    def _capture(self, slot: int, cur):
        side = torch.cuda.Stream()
        side.wait_stream(cur)
        if self.captures == 0:
            with torch.cuda.stream(side):
                self._run()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=side,
                              capture_error_mode="thread_local"):
            self.out[slot] = self._run()
        cur.wait_stream(side)
        self.graphs[slot] = graph
        self.captures += 1
