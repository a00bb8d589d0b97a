"""The port's mode-9 bank producer against the JAX package on the CPU: the
key-based random draws, detmath, the displacer population, the elementary
field, the plain bank kernels (coarse_gdisp_batch, displace_planes_batch)
and the whole make_bank_and_aux at 128x96 (big field 384, half lattice 192).
The JAX side runs its bank kernels in Pallas interpret mode, as its own CPU
runs do; its bank and aux are computed once per file.

The bank is chaotic (17 doublings amplify one ulp into pixels), so the port
keeps the JAX package's order of operations everywhere and the comparisons
here are bit for bit; the bank additionally meets the JAX package's on-device
bank gate (tools/check_pallas_tpu.py): NaN-mask mismatch under 1e-4, flow
median |d| < 1e-4 px and under 1e-3 of values with |d| > 0.01 px."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flowgen
import flowgen_torch
from flowgen.compose.render import WarpBank as JBank
from flowgen.ops import detmath as jd
from flowgen.random import streams as js
from flowgen.warpfields import fields as jf
from flowgen.warpfields import generator as jg
from flowgen.warpfields import pallas_fields as jpf
from flowgen_torch.interop import aux_from_numpy, bank_from_numpy
from flowgen_torch.ops import detmath as td
from flowgen_torch.random import streams as ts
from flowgen_torch.warpfields import compose as tcomp
from flowgen_torch.warpfields import fields as tfields
from flowgen_torch.warpfields import generator as tg

torch.set_num_threads(1)

W, H, B = 128, 96, 2
SEED, STEP = 0, 0


def _cfgs(**kw):
    return (flowgen.DataGenConfig(mode=9, batch_size=B, width=W, height=H, **kw),
            flowgen_torch.DataGenConfig(mode=9, batch_size=B, width=W, height=H,
                                        **kw))


@pytest.fixture(scope="module")
def ref():
    jc, _ = _cfgs()
    bank, aux = jax.jit(lambda r, s: jg.make_bank_and_aux(r, s, jc))(
        js.root_key(SEED), jnp.int32(STEP))
    return {"bank": jax.tree.map(np.asarray, bank),
            "aux": tuple(np.asarray(a) for a in aux)}


def _bits(a):
    a = np.ascontiguousarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _bit_equal(got, want):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_array_equal(_bits(got), _bits(want))


def _keys(seed):
    jk = js.stream_key(jax.random.fold_in(js.root_key(seed), 3),
                       js.Stream.WARP_FIELD, 1)
    tk = ts.stream_key(ts.fold_in(ts.root_key(seed), 3), ts.Stream.WARP_FIELD, 1)
    return jk, tk


@pytest.mark.parametrize("seed", [0, 1, 12345, 2**31 - 1])
def test_key_draws_match_jax(seed):
    jk, tk = _keys(seed)
    _bit_equal(tk, np.asarray(jax.random.key_data(jk)).astype(np.int64))
    _bit_equal(ts.split(tk, 8), np.asarray(
        jax.random.key_data(jax.random.split(jk, 8))).astype(np.int64))
    for shape in ((), (7,), (3, 5)):
        _bit_equal(ts.uniform(tk, -1.0, 1.0, shape), js.uniform(jk, -1.0, 1.0, shape))
        _bit_equal(ts.uniform(tk, 50.0, 70.0, shape), js.uniform(jk, 50.0, 70.0, shape))
        _bit_equal(ts.uniform_int(tk, 0, 2, shape), js.uniform_int(jk, 0, 2, shape))
        # A span whose 2**32 residue wraps in uint32 (JAX's randint reduces
        # with wrap-around).
        _bit_equal(ts.uniform_int(tk, -5, 100000, shape),
                   js.uniform_int(jk, -5, 100000, shape))


_DET_INPUTS = {
    "det_sin": np.r_[np.linspace(-4, 4, 20001), 0.0, -0.0, 1e-30, np.pi, -np.pi],
    "det_cos": np.r_[np.linspace(-4, 4, 20001), 0.0, -0.0, 1e-30, np.pi, -np.pi],
    "det_exp": np.r_[-np.geomspace(1e-8, 200.0, 20001), 0.0, -87.0, -87.5],
    "det_recip": np.r_[np.geomspace(1e-6, 1e6, 10001), -np.geomspace(1e-6, 1e6, 10001),
                       1.0, 2.0, 3e-4, -2e-6],
}


@pytest.mark.parametrize("name", sorted(_DET_INPUTS))
def test_detmath_matches_jax(name):
    x = _DET_INPUTS[name].astype(np.float32)
    rng = np.random.default_rng(0)
    x = np.r_[x, rng.uniform(x.min(), x.max(), 20000).astype(np.float32)]
    _bit_equal(getattr(td, name)(torch.from_numpy(x)),
               getattr(jd, name)(jnp.asarray(x)))
    if name == "det_recip":
        y = rng.uniform(-50, 50, x.size).astype(np.float32)
        _bit_equal(td.det_div(torch.from_numpy(y), torch.from_numpy(x)),
                   jd.det_div(jnp.asarray(y), jnp.asarray(x)))
        _bit_equal(td.det_lerp(torch.from_numpy(y), torch.from_numpy(x),
                               torch.from_numpy(np.abs(y) / 50)),
                   jd.det_lerp(jnp.asarray(y), jnp.asarray(x),
                               jnp.asarray(np.abs(y) / 50)))


@pytest.mark.parametrize("size", [384, 1536])
def test_displacer_grid_matches_jax(size):
    jk, tk = _keys(7)
    jgrid = jf.sample_displacer_grid(jk, size)
    tgrid = tfields.sample_displacer_grid(tk, size)
    for a, b in zip(tgrid, jgrid):
        _bit_equal(a, b)
    gx, gy = tfields.hex_grid_centers(size)
    jx, jy = jf.hex_grid_centers(size)
    _bit_equal(gx, jx)
    _bit_equal(gy, jy)


def test_elementary_field_matches_jax():
    """Both directions of two big fields in one batched call of the plain
    version (what the card's kernel is held to), against the JAX package's
    per-field fori_loop, on the half lattice of a 512 field."""
    grids, jgrids, flags = [], [], []
    for seed in (3, 4):
        jk, tk = _keys(seed)
        grids += [tfields.sample_displacer_grid(tk, 512)] * 2
        jgrids += [jf.sample_displacer_grid(jk, 512)] * 2
        flags += [False, True]
    g, inv = tfields.stack_grids(grids, flags)
    got = tfields.elementary_field_plain(g, 256, inv, stride=2.0)
    assert g.kind.shape == (4, 6)
    for m, (jgrid, inverse) in enumerate(zip(jgrids, flags)):
        want = jf.elementary_field(jgrid, 256, inverse=inverse, stride=2.0)
        _bit_equal(got[m].permute(1, 2, 0), want)
        _bit_equal(tfields.clamp_near_zeros(got[m] * 40.0),
                   jnp.moveaxis(jf.clamp_near_zeros(want * 40.0), -1, 0))


def test_upsample_and_half_offset_match_jax(ref):
    iflow = np.nan_to_num(ref["bank"].iflow[:3])
    p = iflow[..., 0]
    _bit_equal(tfields._upsample2(torch.from_numpy(p)),
               jpf._upsample2_plane(jnp.asarray(p)))
    _bit_equal(tg._half_offset_expand(torch.from_numpy(iflow), 2, -3, 70),
               jg._half_offset_expand(jnp.asarray(iflow), 2, -3, 70))


def test_bank_kernels_plain_match_jax(ref):
    """The plain coarse_gdisp_batch and displace_planes_batch on composed
    crops of the bank (square 96 x 96 crops exercise the edge padding to
    128), against the JAX kernels in interpret mode."""
    D = np.nan_to_num(ref["bank"].iflow[:4, :, :96])
    gd = tcomp.coarse_gdisp_batch(torch.from_numpy(D))
    jgd = jpf.coarse_gdisp_batch(jnp.asarray(D), interpret=True)
    _bit_equal(gd, jgd)
    src = torch.from_numpy(np.ascontiguousarray(np.moveaxis(D, -1, 1)))
    out = tcomp.displace_planes_batch(src, gd, src[:, 1])
    jout = jpf.displace_planes_batch(jnp.moveaxis(jnp.asarray(D), -1, 1), jgd,
                                     jnp.asarray(D[..., 1]), interpret=True)
    _bit_equal(out, jout)
    assert float(gd.abs().max()) > 1.0


def _band_starts(D):
    """The band's first tile of every (step, field, lane tile) of the plain
    solve on ``D``: (SOLVE_ITERS + 1, N, n_src) int64."""
    from flowgen_torch.ops.resample import banded_lerp

    dyT, dxT, Lv = tcomp.coarse_solve_inputs(D)
    N, R, Lp = dyT.shape
    n_src = Lp // 128
    wpos = torch.arange(Lp, dtype=torch.float32).expand(N * R, Lp)
    d = torch.zeros_like(wpos)
    starts = []
    for it in range(tcomp.SOLVE_ITERS + 1):
        u0 = torch.floor(torch.clamp(wpos - d, 0.0, float(Lv - 1))).long()
        bmin = u0.reshape(N, R, n_src, 128).amin(dim=(1, 3))
        starts.append(torch.clamp(bmin >> 7, 0, n_src - tcomp.COARSE_SCAN))
        src = (dyT if it < tcomp.SOLVE_ITERS else dxT).reshape(N * R, Lp)
        d = banded_lerp(src, wpos - d, R, tcomp.COARSE_SCAN, Lv, clamp_oob=True)
    return torch.stack(starts)


def test_coarse_gdisp_band_moves_matches_jax():
    """2 fields of 1536^2 (Hc = 384: three lane tiles, so the band's first
    tile can move), smooth displacements up to 60 px whose y channel is
    nowhere positive in field 0 and nowhere negative in field 1: the middle
    tile's band starts at tile 1 in field 0 and at tile 0 in field 1. The
    plain coarse_gdisp_batch equals the JAX kernel in interpret mode bit for
    bit."""
    S = 1536
    rng = np.random.default_rng(7)
    y = np.arange(S, dtype=np.float32)[:, None]
    x = np.arange(S, dtype=np.float32)[None, :]
    D = np.zeros((2, S, S, 2), np.float32)
    for m, sign in enumerate((-1.0, 1.0)):
        ph = rng.random(3).astype(np.float32) * 6.0
        bump = 0.5 - 0.5 * np.cos(y * (2 * np.pi / S) + ph[0] * 0.1)
        D[m, ..., 1] = sign * 60.0 * bump * (0.6 + 0.4 * np.sin(x * 0.004 + ph[1]))
        D[m, ..., 0] = 45.0 * np.sin(y * 0.003 + x * 0.005 + ph[2])
    starts = _band_starts(torch.from_numpy(D))
    assert bool((starts[:, 0, 1] == 1).all())
    assert bool((starts[1:, 1, 1] == 0).any())
    gd = tcomp.coarse_gdisp_batch(torch.from_numpy(D))
    jgd = jpf.coarse_gdisp_batch(jnp.asarray(D), interpret=True)
    _bit_equal(gd, jgd)
    assert float(gd.abs().max()) > 30.0


def test_make_bank_and_aux_meets_bank_gate(ref):
    _, tc = _cfgs()
    bank, aux = tg.make_bank_and_aux(ts.root_key(SEED), STEP, tc)
    assert bank.flow.shape == (tg.bank_size(tc), H, W, 2) == (80, H, W, 2)
    assert aux[0].shape == (80, 4, H, W) and aux[1].shape == (80, 2, H + 192, W)
    for got, want in ((bank.flow, ref["bank"].flow),
                      (bank.iflow, ref["bank"].iflow)):
        got = got.numpy()
        nan_g, nan_w = np.isnan(got), np.isnan(want)
        assert (nan_g != nan_w).mean() < 1e-4
        both = ~nan_g & ~nan_w
        d = np.abs(got[both] - want[both])
        assert np.median(d) < 1e-4
        assert (d > 0.01).mean() < 1e-3
    assert np.nanmax(np.abs(ref["bank"].iflow)) > 5.0


def test_make_bank_and_aux_bit_equal(ref):
    _, tc = _cfgs()
    bank, aux = tg.make_bank_and_aux(ts.root_key(SEED), STEP, tc)
    _bit_equal(bank.flow, ref["bank"].flow)
    _bit_equal(bank.iflow, ref["bank"].iflow)
    for got, want in zip(aux, ref["aux"]):
        _bit_equal(got, want)
    carried = bank_from_numpy(ref["bank"])
    _bit_equal(carried.iflow, ref["bank"].iflow)
    carried_aux = aux_from_numpy(ref["aux"])
    for got, want in zip(carried_aux, ref["aux"]):
        _bit_equal(got, want)
    # The background bands depend only on the background planes.
    _bit_equal(aux.bg_band, carried_aux.bg_band)


def test_bg_band_starts_holds_every_tap():
    """Each band of the background warp's pass 1 starts at the tile of its
    block's smallest left tap (or as far right as the source allows), so
    with |gdisp| under 64 px every tap of the block lies inside its 4
    tiles: smooth background planes at 512x384, where the band is narrower
    than the source."""
    from flowgen_torch.ops import scene as ps

    h, w = 384, 512
    yy, xx = torch.meshgrid(torch.arange(h + 2 * ps.BG_EY, dtype=torch.float32),
                            torch.arange(w, dtype=torch.float32), indexing="ij")
    bg = torch.stack([torch.stack([60.0 * torch.sin(xx / 37.0 + k)
                                   * torch.cos(yy / 53.0), yy * 0])
                      for k in range(3)])
    band = ps.bg_band_starts(bg)
    geo = ps._warp_geometry(h, w)
    ww = min(ps.WIN_W, w)
    n_src = geo["WB"] // 128
    tiles = ps._bg_tiles(h, w, min(ps.WIN_H, h), ww)
    assert band.shape == (3, len(tiles), ww // 128) and band.dtype == torch.int32
    assert n_src > 4 and int(band.max()) > 0
    xs = torch.arange(ww, dtype=torch.float32)
    for t, (y0s, x0s) in enumerate(tiles):
        u = xs + x0s + bg[:, 0, y0s : y0s + geo["whB"], x0s : x0s + ww] + ps.BG_EX
        u0 = torch.floor(torch.clamp(u, 0, geo["WB"] - 1)).long()
        u1 = torch.clamp(u0 + 1, max=geo["WB"] - 1)
        lo = band[:, t].long().repeat_interleave(128, dim=1)[:, None] * 128
        assert bool(((u0 >= lo) & (u1 < lo + 4 * 128)).all())
        first = u0.reshape(3, -1, ww // 128, 128).amin(dim=(1, 3))
        tight = (first >> 7) == band[:, t]
        assert bool((tight | (band[:, t] == n_src - 4)).all())


def test_bank_kernel_wrappers_refuse_other_devices():
    """The bank kernels' wrappers run the kernel on CUDA tensors and the
    plain version on CPU tensors; other devices raise, and the plain
    switch resets when its block raises."""
    planes = torch.zeros((1, 1, 128, 128), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tcomp.hwarp_rows(planes, planes[:, 0])
    with pytest.raises(ValueError, match="unsupported device"):
        tcomp.coarse_gdisp_batch(planes.permute(0, 2, 3, 1))
    with pytest.raises(RuntimeError):
        with tcomp.plain_versions():
            assert tcomp._plain
            raise RuntimeError
    assert not tcomp._plain


def test_oob_policy_matches_jax(ref):
    flow = ref["bank"].flow[:2].copy()
    flow[0, 5:9, 7:30] = np.nan
    jbank = JBank(flow=jnp.asarray(flow), iflow=jnp.asarray(flow))
    for policy in ("zero", "nan"):
        got = tg.apply_oob_policy(bank_from_numpy(jbank), policy)
        _bit_equal(got.flow, jg.apply_oob_policy(jbank, policy).flow)
    assert tg.OOB_SENTINEL == jg.OOB_SENTINEL
    assert tg.OOB_FLOW_THRESH == jg.OOB_FLOW_THRESH
    assert tg.crop_origins(W, H) == jg.crop_origins(W, H)
    assert tg.crop_origins(512, 384) == jg.crop_origins(512, 384)


def test_xla_content_stream_raises():
    """The three functions of the "xla" stream, once refusals, return
    fields of the right shapes: finite warp planes, a zero field kept
    zero, a big field of the bank's magnitudes."""
    _, tc = _cfgs(warp_bank_impl="xla")
    bank, aux = tg.make_bank_and_aux(ts.root_key(0), 0, tc)
    n = tg.bank_size(tc)
    assert bank.flow.shape == bank.iflow.shape == (n, H, W, 2)
    assert aux.obj.shape == (n, 4, H, W) and bool(torch.isfinite(aux.obj).all())
    f = tfields.self_compose(torch.zeros(1, 2, 8, 8))
    assert f.shape == (1, 2, 8, 8) and bool((f == 0).all())
    flow, iflow = tfields.make_big_field(ts.root_key(0), 384)
    assert flow.shape == iflow.shape == (2, 384, 384)
    assert 0.0 < float(torch.nan_to_num(flow).abs().max()) < 120.0
