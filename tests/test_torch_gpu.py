"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Every test is marked ``gpu`` and skips where no CUDA device exists;
whether one exists is decided inside each test. This file imports neither
JAX nor the JAX package, so it also runs on a machine without them:

    python -m pytest tests/test_torch_gpu.py -q --noconftest
"""

import math

import numpy as np
import pytest
import torch

import flowgen_torch
from flowgen_torch.compose import fused
from flowgen_torch.ops import scene as ps
from flowgen_torch.params.sampler import sample_scene_batch
from flowgen_torch.pipeline.generator import generate_batch, make_slab_packer
from flowgen_torch.random.streams import root_key

torch.set_num_threads(1)

pytestmark = pytest.mark.gpu


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the CUDA kernels have no CPU mode)")


def _tables(cfg, seed, dev):
    atlas = flowgen_torch.procedural_atlas(4, height=cfg.height, width=cfg.width)
    obj, bg, src, _ = make_slab_packer(cfg, dev)(atlas)
    scenes = sample_scene_batch(root_key(seed, dev),
                                torch.arange(cfg.batch_size, device=dev), cfg)
    args, opts = fused.scene_tables(scenes, cfg, obj, bg, src)
    return args, opts


@pytest.mark.parametrize("mode,width,height,batch", [
    (7, 128, 96, 2), (7, 512, 384, 1), (1, 256, 192, 2), (5, 512, 384, 1),
])
def test_scene_kernel_matches_plain(mode, width, height, batch):
    _need_card()
    cfg = flowgen_torch.DataGenConfig(mode=mode, batch_size=batch,
                                      width=width, height=height)
    args, opts = _tables(cfg, 3, torch.device("cuda"))
    before = ps.scene_render.launches
    kf, kl, _ = ps.scene_render(*args, **opts)
    torch.cuda.synchronize()
    assert ps.scene_render.launches == before + 1
    pf, pl, _ = ps.scene_render_plain(*args, **opts)
    assert (kf != pf).float().mean().item() < 1e-4
    d = (kl - pl).abs()
    assert d.flatten().median().item() < 1e-4
    assert (d > 0.01).float().mean().item() < 1e-3


@pytest.mark.parametrize("mode,width,height,batch,tsplit", [
    (11, 128, 96, 2, 1), (13, 256, 96, 1, 2), (11, 512, 384, 1, 2),
    (13, 512, 384, 1, 2),
])
def test_quadrant_scene_kernel_matches_plain(mode, width, height, batch,
                                             tsplit):
    """Quadrant slabs, the frame-1 sub-windows, inverse flow and ids: the
    kernel equals its plain version bit for bit."""
    _need_card()
    cfg = flowgen_torch.DataGenConfig(
        mode=mode, batch_size=batch, width=width, height=height,
        compute_inverse_flow=True, emit_masks=True)
    args, opts = _tables(cfg, 3, torch.device("cuda"))
    assert opts["spec_key"][6] == tsplit
    assert args[7].shape[0] == 8          # rot90 copies of 4 textures
    kf, kl, ki = ps.scene_render(*args, **opts)
    torch.cuda.synchronize()
    pf, pl, pi = ps.scene_render_plain(*args, **opts)
    assert kl.shape[1] == 4 and ki is not None
    assert torch.equal(kf, pf)
    assert torch.equal(kl, pl)
    assert torch.equal(ki, pi)


@pytest.mark.parametrize("kw", [
    dict(mode=7), dict(mode=13, width=256, compute_inverse_flow=True,
                       emit_masks=True),
])
def test_generate_batch_cuda_matches_cpu(kw):
    _need_card()
    cfg = flowgen_torch.DataGenConfig(**{"batch_size": 2, "width": 128,
                                         "height": 96, **kw})
    atlas = flowgen_torch.procedural_atlas(4, height=96, width=cfg.width)
    g = generate_batch(0, 0, atlas, cfg, device="cuda")
    c = generate_batch(0, 0, atlas, cfg, device="cpu")
    assert set(g) == set(c)
    for k in ("image0", "image1"):
        assert (g[k].cpu() - c[k]).abs().ge(1).float().mean().item() < 0.01
    for k in [k for k in ("flow0", "flow1") if k in c]:
        d = (g[k].cpu() - c[k]).abs()
        assert d.flatten().median().item() < 1e-4
    for k in [k for k in ("occlusion", "motion_boundary") if k in c]:
        assert (g[k].cpu() != c[k]).float().mean().item() < 1e-4


def _smooth_fields(m, s, mag, dev):
    """(m, 2, s, s) smooth displacement fields with |f| <= ~mag px: real
    elementary fields of a 2s lattice on its half lattice, rescaled."""
    from flowgen_torch.random.streams import Stream, stream_key
    from flowgen_torch.warpfields import fields

    grids, flags = [], []
    for i in range(m):
        grids.append(fields.sample_displacer_grid(
            stream_key(root_key(5, dev), Stream.WARP_FIELD, i), 2 * s))
        flags.append(bool(i % 2))
    g, inv = fields.stack_grids(grids, flags)
    f = fields.elementary_field(g, s, inv, stride=2.0)
    return f * (mag / f.abs().amax(dim=(1, 2, 3), keepdim=True))


@pytest.mark.parametrize("s", [192, 384, 768, 1536])
def test_fields_kernels_match_plain(s):
    """The bank kernels on smooth fields; at 1536 the coarse lattice has
    three lane tiles, so the solve's band can move and its CTAs exchange
    their minima."""
    from flowgen_torch.warpfields import compose

    _need_card()
    dev = torch.device("cuda")
    f = _smooth_fields(4, s, 12.0, dev)
    c0, h0 = compose.coarse_gdisp_batch.launches, compose.hwarp_rows.launches
    gd = compose.coarse_gdisp_batch(f.permute(0, 2, 3, 1))
    out = compose.displace_planes_batch(f, gd, f[:, 1])
    torch.cuda.synchronize()
    assert compose.coarse_gdisp_batch.launches == c0 + 2   # solve, upsample
    assert compose.hwarp_rows.launches == h0 + 2
    fc = f.cpu()
    gd_p = compose.coarse_gdisp_batch(fc.permute(0, 2, 3, 1))
    out_p = compose.displace_planes_batch(fc, gd_p, fc[:, 1])
    assert torch.equal(gd.cpu(), gd_p)
    assert torch.equal(out.cpu(), out_p)


@pytest.mark.parametrize("layout", ["contiguous", "cropped", "transposed"])
def test_coarse_gdisp_any_strides_matches_plain(layout):
    """coarse_gdisp_batch reads D in place by its strides: layouts other
    than the bank's permuted planes, at 1536 with displacements up to 200
    px (taps past the solve's staged halo), bit for bit."""
    from flowgen_torch.warpfields import compose

    _need_card()
    dev = torch.device("cuda")
    s = 1536
    f = _smooth_fields(2, s, 200.0, dev)
    if layout == "contiguous":
        D = f.permute(0, 2, 3, 1).contiguous()
    elif layout == "cropped":
        big = torch.nn.functional.pad(f, (12, 4, 8, 0))
        D = big[:, :, 8 : 8 + s, 12 : 12 + s].permute(0, 2, 3, 1)
    else:
        D = f.permute(0, 3, 2, 1)
    gd = compose.coarse_gdisp_batch(D)
    torch.cuda.synchronize()
    want = compose.coarse_gdisp_batch(D.cpu())
    assert torch.equal(gd.cpu().view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("hd,wd", [(4608, 4608), (512, 8192)])
def test_coarse_gdisp_wide_matches_plain(hd, wd):
    """Fields over 4096 px wide, whose slabs are longer than the solve holds
    in registers, take the wide solve: at 4608^2 (the big fields of
    1536-px frames) its CTAs exchange their minima, at 512 x 8192 (one lane
    tile) they need not; bit for bit against the plain version on the
    card."""
    from flowgen_torch.warpfields import compose

    _need_card()
    dev = torch.device("cuda")
    f = _smooth_fields(2, max(hd, wd), 60.0, dev)[:, :, :hd, :wd]
    D = f.permute(0, 2, 3, 1)
    c0 = compose.coarse_gdisp_batch.launches
    gd = compose.coarse_gdisp_batch(D)
    assert compose.coarse_gdisp_batch.launches == c0 + 2   # solve, upsample
    with compose.plain_versions():
        want = compose.coarse_gdisp_batch(D)
    torch.cuda.synchronize()
    assert gd.shape == (2, hd, wd)
    assert torch.equal(gd.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("s,stride,n_iter", [
    (768, 1, 0), (768, 1, 20), (768, 2, 0), (768, 2, 20), (768, 8, 0),
    (768, 8, 20), (3072, 8, 20), (1536, 1, 20), (1536, 4, 100)])
def test_coarse_gdisp_strides_match_plain(s, stride, n_iter):
    """coarse_gdisp_batch at lattice strides other than the bank's and at
    step counts from 0 to 100, bit for bit against the plain version: at
    768^2 the band moves at strides 1 and 2 (more lane tiles than the
    scan), at 3072^2 at stride 8; 1536^2 at stride 1 takes the wide solve;
    100 steps cycle the exchange's two slots 50 times. The upsample is
    log2(stride) launches of upsample2_kernel (upsample4_kernel at 4)."""
    from flowgen_torch.warpfields import compose

    _need_card()
    dev = torch.device("cuda")
    D = _smooth_fields(2, s, 30.0, dev).permute(0, 2, 3, 1)
    c0 = compose.coarse_gdisp_batch.launches
    gd = compose.coarse_gdisp_batch(D, stride, n_iter)
    torch.cuda.synchronize()
    levels = stride.bit_length() - 1
    assert compose.coarse_gdisp_batch.launches == c0 + 1 + (
        1 if levels == 2 else levels)
    want = compose.coarse_gdisp_batch(D.cpu(), stride, n_iter)
    assert gd.shape == (2, s, s)
    assert torch.equal(gd.cpu().view(torch.int32), want.view(torch.int32))


def test_coarse_solve_refuses_short_scratch():
    """The wide solve's scratch is sized by fields.cu alone: the solve
    fails, launching nothing, on a scratch one float shorter than
    flowgen_coarse_scratch_floats says, and runs on one of that size; the
    narrow solve needs none."""
    from flowgen_torch.ops._build import load_fields_library
    from flowgen_torch.warpfields import compose

    _need_card()
    dev = torch.device("cuda")
    lib = load_fields_library()
    S, scan = 1536, compose.coarse_scan(1)
    assert lib.flowgen_coarse_scratch_floats(1, S // 4, S // 4, scan) == 0
    need = lib.flowgen_coarse_scratch_floats(1, S, S, scan)
    assert need == S * S
    D = torch.zeros((1, S, S, 2), dtype=torch.float32, device=dev)
    gd = torch.empty((1, S, S), dtype=torch.float32, device=dev)
    for n, ok in ((need - 1, False), (need, True)):
        scratch = torch.empty(n, dtype=torch.float32, device=dev)
        err = lib.flowgen_coarse_solve(
            compose._ptr(D), *D.stride(), 1, compose._ptr(gd),
            compose._ptr(scratch), n, 1, S, S, 8, scan, compose._stream(D))
        assert (err == 0) == ok
    torch.cuda.synchronize()


def test_bank_cuda_matches_plain():
    from flowgen_torch.warpfields.generator import make_bank_and_aux

    _need_card()
    cfg = flowgen_torch.DataGenConfig(mode=9, batch_size=2, width=128, height=96)
    g_bank, g_aux = make_bank_and_aux(root_key(0, "cuda"), 0, cfg)
    c_bank, c_aux = make_bank_and_aux(root_key(0), 0, cfg)
    for a, b in zip(tuple(g_bank) + tuple(g_aux), tuple(c_bank) + tuple(c_aux)):
        assert torch.equal(a.cpu(), b)


def test_bank_graphs_replay_eager_planes():
    """The graphs' warp planes equal the eager bank's bit for bit, epoch
    after epoch, under two roots and after a seek back; a call overwrites
    only its own parity's planes, and each parity is captured once."""
    from flowgen_torch.warpfields.generator import (BankAuxGraphs,
                                                     make_bank_and_aux)

    _need_card()
    cfg = flowgen_torch.DataGenConfig(mode=9, batch_size=2, width=128,
                                      height=96, warp_bank_reuse_steps=2)
    graphs = BankAuxGraphs(cfg, "cuda")
    for seed in (3, 2**31 + 5):
        root = root_key(seed, "cuda")
        held = None
        for step in (0, 2, 5, 6, 1, 9):
            got = graphs(root, step)
            want = make_bank_and_aux(root, step, cfg)[1]
            for a, b in zip(got, want):
                assert torch.equal(a, b)
            if held is not None and (step // 2) % 2 != held[0]:
                for a, b in zip(held[1], held[2]):
                    assert torch.equal(a, b)
            held = ((step // 2) % 2, got, [t.clone() for t in got])
    assert (graphs.captures, graphs.replays) == (2, 12)


def test_warm_eager_bank_does_not_synchronize():
    """After one build, an eager bank epoch on the card makes no call that
    waits for the device (no host-to-device copy of host data): what makes
    it capturable."""
    from flowgen_torch.warpfields.generator import make_bank_and_aux

    _need_card()
    cfg = flowgen_torch.DataGenConfig(mode=9, batch_size=2, width=128,
                                      height=96)
    root = root_key(8, "cuda")
    make_bank_and_aux(root, 0, cfg)
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        make_bank_and_aux(root, 2, cfg)
    finally:
        torch.cuda.set_sync_debug_mode(prev)


def test_generate_fn_bank_graphs_match_eager_batches():
    """make_generate_fn on the card (the bank's epochs from its graphs,
    built ahead, and a seek back and forth) gives generate_batch's eager
    batches bit for bit."""
    from flowgen_torch.pipeline.generator import make_generate_fn

    _need_card()
    cfg = flowgen_torch.DataGenConfig(mode=9, batch_size=2, width=128,
                                      height=96, warp_bank_reuse_steps=2)
    atlas = flowgen_torch.procedural_atlas(4, height=96, width=128)
    fn = make_generate_fn(cfg, device="cuda")
    for step in (0, 1, 2, 3, 4, 9, 2, 3, 4, 0):
        got = fn(0, step, atlas)
        want = generate_batch(0, step, atlas, cfg, device="cuda")
        assert set(got) == set(want)
        for k in want:
            assert torch.equal(got[k], want[k]), (step, k)


def _field_grids(big, n_fields, dev, both=True, seed=11):
    """Displacer grids of ``n_fields`` big fields of ``big``^2, each with its
    inverse where ``both``, stacked as a bank epoch stacks them."""
    from flowgen_torch.random.streams import Stream, stream_key
    from flowgen_torch.warpfields import fields

    grids, flags = [], []
    for i in range(n_fields):
        g = fields.sample_displacer_grid(
            stream_key(root_key(seed, dev), Stream.WARP_FIELD, i), big)
        grids += [g, g] if both else [g]
        flags += [False, True] if both else [False]
    return fields.stack_grids(grids, flags)


def _same_bits(a, b):
    return torch.equal(a.contiguous().view(torch.int32),
                       b.contiguous().view(torch.int32))


@pytest.mark.parametrize("big,n_fields,both,size,stride,m,n", [
    (1536, 2, True, 768, 2.0, 4, 63),     # a chairs bank epoch
    (3072, 1, True, 1536, 2.0, 2, 270),   # a Sintel big field
    (600, 1, False, 97, 1.0, 1, 12),      # ragged tiles
])
def test_elementary_field_kernel_matches_plain(big, n_fields, both, size,
                                               stride, m, n):
    """The kernel against the plain version on the card, bit for bit (the
    sign of a zero included), one launch a call; Sintel's 270 displacers
    take three chunks of staged constants."""
    from flowgen_torch.warpfields import fields

    _need_card()
    grid, inv = _field_grids(big, n_fields, "cuda", both)
    assert tuple(grid.kind.shape) == (m, n)
    n0 = fields.elementary_field.launches
    got = fields.elementary_field(grid, size, inv, stride=stride)
    assert fields.elementary_field.launches == n0 + 1
    want = fields.elementary_field_plain(grid, size, inv, stride=stride)
    torch.cuda.synchronize()
    assert got.shape == (m, 2, size, size)
    assert _same_bits(got, want)


def test_elementary_field_kernel_replays_in_a_graph():
    """Captured in a CUDA graph and replayed on new displacers copied into
    its input, the kernel gives the eager launch's bits."""
    from flowgen_torch.warpfields import fields

    _need_card()
    grid, inv = _field_grids(1536, 2, "cuda")
    consts = fields._packed_constants(grid, inv)
    other = fields._packed_constants(*_field_grids(1536, 2, "cuda", seed=12))
    buf = consts.clone()
    fields.elementary_field_cuda(buf, 768, 2.0)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        out = fields.elementary_field_cuda(buf, 768, 2.0)
    torch.cuda.current_stream().wait_stream(side)
    for k in (consts, other):
        buf.copy_(k)
        graph.replay()
        assert _same_bits(out, fields.elementary_field_cuda(k, 768, 2.0))
    assert not _same_bits(fields.elementary_field_cuda(consts, 768, 2.0),
                          fields.elementary_field_cuda(other, 768, 2.0))


@pytest.mark.parametrize("bad", ["float64", "strided", "cpu"])
def test_elementary_field_kernel_refuses_bad_constants(bad):
    from flowgen_torch.warpfields import fields

    _need_card()
    grid, inv = _field_grids(600, 1, "cuda")
    consts = fields._packed_constants(grid, inv)
    if bad == "float64":
        consts = consts.double()
    elif bad == "strided":
        consts = consts.transpose(0, 1)
    else:
        consts = consts.cpu()
    n0 = fields.elementary_field.launches
    with pytest.raises(ValueError):
        fields.elementary_field_cuda(consts, 64, 2.0)
    assert fields.elementary_field.launches == n0


def test_bank_graphs_match_plain_bank_512x384():
    """BankAuxGraphs at the chairs cells' 512x384 (2 big fields of 1536^2,
    the elementary field through its kernel) against the eager bank built
    by the plain versions, bit for bit."""
    from flowgen_torch.warpfields import compose
    from flowgen_torch.warpfields.generator import (BankAuxGraphs,
                                                     make_bank_and_aux)

    _need_card()
    cfg = flowgen_torch.DataGenConfig(mode=9, batch_size=8,
                                      warp_bank_reuse_steps=2)
    root = root_key(2**31 + 9, "cuda")
    graphs = BankAuxGraphs(cfg, "cuda")
    for step in (0, 2):
        got = [t.clone() for t in graphs(root, step)]
        with compose.plain_versions():
            want = make_bank_and_aux(root, step, cfg)[1]
        for a, b in zip(got, want):
            assert _same_bits(a, b) if a.is_floating_point() else torch.equal(a, b)


def _mode9_tables(cfg, dev):
    """Scene-kernel inputs of a mode-9 batch holding deforming objects and a
    deforming background (the first such seed)."""
    from flowgen_torch.warpfields.generator import bank_size, make_bank_and_aux

    atlas = flowgen_torch.procedural_atlas(4, height=cfg.height, width=cfg.width)
    obj, bg, src, _ = make_slab_packer(cfg, dev)(atlas)
    for seed in range(64):
        scenes = sample_scene_batch(
            root_key(seed, dev), torch.arange(cfg.batch_size, device=dev), cfg,
            n_warp_slots=bank_size(cfg))
        if (int((scenes.objects.warp & scenes.objects.valid).sum()) >= 1
                and int(scenes.background.warp.sum()) >= 1):
            break
    else:
        raise AssertionError("no seed with a deforming object and background")
    _, aux = make_bank_and_aux(root_key(0, dev), 0, cfg)
    args, opts = fused.scene_tables(scenes, cfg, obj, bg, src, warp_aux=aux)
    return args, opts


@pytest.mark.parametrize("width,height,batch", [(128, 96, 2), (512, 384, 1)])
def test_mode9_scene_kernel_matches_plain(width, height, batch):
    _need_card()
    cfg = flowgen_torch.DataGenConfig(mode=9, batch_size=batch, width=width,
                                      height=height)
    args, opts = _mode9_tables(cfg, torch.device("cuda"))
    kf, kl, _ = ps.scene_render(*args, **opts)
    torch.cuda.synchronize()
    pf, pl, _ = ps.scene_render_plain(*args, **opts)
    assert torch.equal(kf, pf)
    assert torch.equal(kl, pl)


def test_mode9_inverse_flow_and_ids_match_plain():
    """The warp branch's inverse flow (under the warped binary mask) and
    ids: the kernel equals its plain version bit for bit."""
    _need_card()
    cfg = flowgen_torch.DataGenConfig(mode=9, batch_size=2, width=128,
                                      height=96, compute_inverse_flow=True,
                                      emit_masks=True)
    args, opts = _mode9_tables(cfg, torch.device("cuda"))
    kf, kl, ki = ps.scene_render(*args, **opts)
    torch.cuda.synchronize()
    pf, pl, pi = ps.scene_render_plain(*args, **opts)
    assert kl.shape[1] == 4
    assert torch.equal(kf, pf)
    assert torch.equal(kl, pl)
    assert torch.equal(ki, pi)


def test_mode9_scene_kernel_matches_plain_b8():
    """A batch of 8 at 512x384 holding a deforming object and a deforming
    background, with inverse flow and ids: the redesigned kernel (work list
    binned per CTA, staged edges culled against the taps' box) equals its
    plain version bit for bit."""
    _need_card()
    cfg = flowgen_torch.DataGenConfig(mode=9, batch_size=8,
                                      compute_inverse_flow=True,
                                      emit_masks=True)
    args, opts = _mode9_tables(cfg, torch.device("cuda"))
    kf, kl, ki = ps.scene_render(*args, **opts)
    torch.cuda.synchronize()
    pf, pl, pi = ps.scene_render_plain(*args, **opts)
    assert torch.equal(kf, pf)
    assert torch.equal(kl, pl)
    assert torch.equal(ki, pi)


def _windowed_inputs(cfg, seed, dev):
    """Scenes, the quad-packed atlas and (mode 9) the crop bank of a
    windowed batch."""
    from flowgen_torch.pipeline.generator import make_atlas_packer
    from flowgen_torch.warpfields.generator import bank_size, make_warp_bank

    atlas = flowgen_torch.procedural_atlas(4, height=cfg.height, width=cfg.width)
    warp = cfg.mode_spec.warp_p > 0.0
    scenes = sample_scene_batch(
        root_key(seed, dev), torch.arange(cfg.batch_size, device=dev), cfg,
        n_warp_slots=bank_size(cfg) if warp else 1)
    bank = make_warp_bank(root_key(seed, dev), 0, cfg) if warp else None
    return scenes, make_atlas_packer(dev)(atlas), bank


@pytest.mark.parametrize("kw", [
    dict(mode=7), dict(mode=7, use_antialiasing=False),
    dict(mode=7, compute_inverse_flow=True, emit_masks=True),
    dict(mode=9, width=256, height=196),
    dict(mode=9, width=256, height=196, compute_inverse_flow=True),
])
def test_windowed_render_kernels_match_plain(kw):
    """The windowed renderer through object_window and polygon_coverage
    equals the same through their plain versions, bit for bit."""
    from flowgen_torch.compose.render import render_batch
    from flowgen_torch.ops import window

    _need_card()
    cfg = flowgen_torch.DataGenConfig(**{"batch_size": 2, "width": 300,
                                         "height": 200, **kw})
    scenes, atlas_q, bank = _windowed_inputs(cfg, 3, torch.device("cuda"))
    o0, p0 = window.object_window.launches, window.polygon_coverage.launches
    k = render_batch(scenes, atlas_q, cfg, bank)
    torch.cuda.synchronize()
    assert (window.object_window.launches > o0
            or window.polygon_coverage.launches > p0)
    with window.plain_versions():
        p = render_batch(scenes, atlas_q, cfg, bank)
    for a, b in zip(k, p):
        assert torch.equal(a, b)


def test_polygon_coverage_kernel_matches_plain():
    from flowgen_torch.ops import window

    _need_card()
    g = torch.Generator().manual_seed(0)
    n, E = 5, 120
    ang = torch.sort(torch.rand((n, E), generator=g) * 6.283, dim=1).values
    r = 20.0 + 60.0 * torch.rand((n, E), generator=g)
    pts = torch.stack([150 + r * torch.cos(ang), 90 + r * torch.sin(ang)], -1)
    n_edges = torch.tensor([3, 17, 60, 119, 120], dtype=torch.int32)
    ys, xs = torch.meshgrid(torch.arange(192.0), torch.arange(256.0),
                            indexing="ij")
    px = (xs + 0.5 + torch.arange(n)[:, None, None] * 0.25).contiguous()
    py = (ys + 0.5).expand(n, 192, 256).contiguous()
    dev = torch.device("cuda")
    before = window.polygon_coverage.launches
    ka, ki = window.polygon_coverage(pts.to(dev), n_edges.to(dev), px.to(dev),
                                     py.to(dev))
    torch.cuda.synchronize()
    assert window.polygon_coverage.launches == before + 1
    pa, pi = window.polygon_coverage_plain(pts, n_edges, px, py)
    assert torch.equal(ka.cpu(), pa) and torch.equal(ki.cpu(), pi)
    assert 0 < float(pi.float().mean()) < 1


@pytest.mark.parametrize("grid", ["jittered", "shuffled", "1x1", "1x1024"])
def test_polygon_coverage_kernel_grids(grid):
    """Any sample grid (the kernel boxes each tile from its points): jittered
    and shuffled points, a single point and a single row; outlines with
    n_edges = E (no padding), 3 and 57 edges. Bit for bit against the plain
    version on the CPU."""
    from flowgen_torch.ops import window

    _need_card()
    rng = np.random.default_rng(4)
    n, E = 4, 120
    ang = np.sort(rng.uniform(0, 2 * np.pi, (n, E)), axis=1)
    r = rng.uniform(15.0, 60.0, (n, E))
    pts = np.stack([100 + 1.5 * r * np.cos(ang), 30 + r * np.sin(ang)], -1)
    n_edges = np.array([E, E, 3, 57], np.int32)
    h, w = {"jittered": (64, 200), "shuffled": (48, 160), "1x1": (1, 1),
            "1x1024": (1, 1024)}[grid]
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
    px = np.broadcast_to(xs + 0.5 + 100.0 * (w == 1), (n, h, w)).copy()
    py = np.broadcast_to(ys + 0.5 + 30.0 * (h == 1), (n, h, w)).copy()
    if grid in ("jittered", "shuffled"):
        px += rng.uniform(-0.45, 0.45, px.shape)
        py += rng.uniform(-0.45, 0.45, py.shape)
    if grid == "shuffled":
        perm = rng.permutation(h * w)
        px = px.reshape(n, -1)[:, perm].reshape(n, h, w)
        py = py.reshape(n, -1)[:, perm].reshape(n, h, w)
    pts, px, py = (torch.from_numpy(np.ascontiguousarray(a, np.float32))
                   for a in (pts, px, py))
    ne = torch.from_numpy(n_edges)
    dev = torch.device("cuda")
    ka, ki = window.polygon_coverage(pts.to(dev), ne.to(dev), px.to(dev),
                                     py.to(dev))
    torch.cuda.synchronize()
    pa, pi = window.polygon_coverage_plain(pts, ne, px, py)
    assert torch.equal(ka.cpu().view(torch.int32), pa.view(torch.int32))
    assert torch.equal(ki.cpu(), pi)
    assert bool(pi.any())


def test_generate_batch_cuda_matches_cpu_windowed():
    """Mode 7 at MPI-Sintel's 1024x436: the CUDA window kernels against the
    CPU's composed branch, within the on-device gates."""
    _need_card()
    cfg = flowgen_torch.DataGenConfig(mode=7, batch_size=2, width=1024,
                                      height=436)
    atlas = flowgen_torch.procedural_atlas(4, height=436, width=1024)
    g = generate_batch(0, 0, atlas, cfg, device="cuda")
    c = generate_batch(0, 0, atlas, cfg, device="cpu")
    assert set(g) == set(c)
    for k in ("image0", "image1"):
        d = (g[k].cpu() - c[k]).abs()
        assert d.ge(1).float().mean().item() < 0.01
        assert d.ge(2).float().mean().item() < 1e-4
    d = (g["flow0"].cpu() - c["flow0"]).abs()
    assert d.flatten().median().item() < 1e-4
    assert (d > 0.01).float().mean().item() < 1e-3


def test_affine_resample_kernel_matches_plain():
    from flowgen_torch.ops import resample as res

    _need_card()
    img = torch.from_numpy(flowgen_torch.procedural_atlas(
        1, height=192, width=256)[0])                      # (384, 512, 3)
    slab = res.pack_padded_slab(img, 64, 64)
    P = res.max_row_span(192, 256, 0.7, 1.35)
    c, s = 1.1 * math.cos(0.3), 1.1 * math.sin(0.3)
    t = torch.tensor([[c, -s, 90.0], [s, c, 40.0]])
    before = res.affine_resample.launches
    k = res.affine_resample(slab.cuda(), t, 16, 8, wh=192, ww=256, P=P)
    torch.cuda.synchronize()
    assert res.affine_resample.launches == before + 1
    p = res.affine_resample_plain(slab, t, 16, 8, wh=192, ww=256, P=P)
    assert torch.equal(k.cpu(), p)


@pytest.mark.parametrize("h,w,wh,ww", [(768, 1024, 384, 512),
                                       (872, 2048, 436, 1024)])
def test_affine_resample_kernel_matches_plain_on_frames(h, w, wh, ww):
    """Whole frames, as the background pass resamples them: a 384x512
    output from the 2H x 2W source of 512x384 and a 436x1024 one from
    MPI-Sintel's 872x2048, in slabs with the scene kernel's margin."""
    from flowgen_torch.ops import resample as res
    from flowgen_torch.ops.scene import SLAB_MARGIN as M

    _need_card()
    img = torch.from_numpy(flowgen_torch.procedural_atlas(
        1, height=h // 2, width=w // 2, seed=2)[0])
    slab = res.pack_padded_slab(img, M, M)
    P = res.max_row_span(wh, ww, 0.23, 1.35)
    c, s = 1.1 * math.cos(-0.2), 1.1 * math.sin(-0.2)
    cx, cy = 0.5 * ww, 0.5 * wh
    t = torch.tensor([[c, -s, M + 0.5 * w - (c * cx - s * cy) + 3.3],
                      [s, c, M + 0.5 * h - (s * cx + c * cy) - 7.6]])
    k = res.affine_resample(slab.cuda(), t, 0, 0, wh=wh, ww=ww, P=P)
    p = res.affine_resample_plain(slab, t, 0, 0, wh=wh, ww=ww, P=P)
    assert torch.equal(k.cpu().view(torch.int32), p.view(torch.int32))


@pytest.mark.parametrize("xscan,yscan", [(1, 1), (1, 4), (4, 1), (2, 2)])
def test_affine_resample_band_widths_match_plain(xscan, yscan):
    """Band widths too narrow for the affine (x_tiles_scan, y_tiles_scan
    of 1 or 2 tiles at a 40 degree rotation): the taps outside a block's
    band read 0 in the kernel as in the plain version, bit for bit."""
    from flowgen_torch.ops import resample as res

    _need_card()
    img = torch.from_numpy(flowgen_torch.procedural_atlas(
        1, height=192, width=256)[0])
    slab = res.pack_padded_slab(img, 64, 64)
    P = res.max_row_span(192, 256, 0.7, 1.35)
    c, s = 1.3 * math.cos(0.7), 1.3 * math.sin(0.7)
    t = torch.tensor([[c, -s, 200.0], [s, c, 30.0]])
    kw = dict(wh=192, ww=256, P=P, x_tiles_scan=xscan, y_tiles_scan=yscan)
    k = res.affine_resample(slab.cuda(), t, 16, 8, **kw)
    p = res.affine_resample_plain(slab, t, 16, 8, **kw)
    assert (p == 0).any()
    assert torch.equal(k.cpu().view(torch.int32), p.view(torch.int32))


def _star_edges(rng, n, cx, cy, r0, r1):
    """(4, E) closed star outline of ``n`` edges padded with its first
    point, as the window kernel's edge rows [ax; ay; bx; by]."""
    E = 120
    ang = np.sort(rng.uniform(0, 2 * np.pi, n))
    r = rng.uniform(r0, r1, n)
    pts = np.zeros((E, 2), np.float32)
    pts[:n] = np.stack([cx + r * np.cos(ang), cy + r * np.sin(ang)], -1)
    pts[n:] = pts[0]
    b = np.roll(pts, -1, axis=0)
    b[n - 1] = pts[0]
    return np.stack([pts[:, 0], pts[:, 1], b[:, 0], b[:, 1]])


def _ellipse_inverse(cx, cy, th, s):
    """Inverse 2x3 of rotate(th), scale(s), translate(cx, cy), row-major."""
    c, si = np.cos(th) / s, np.sin(th) / s
    return [c, si, -(c * cx + si * cy), -si, c, si * cx - c * cy]


def _object_window_inputs(H, W, wins, seed):
    """Tables of windows (y0, x0, wh, ww), each in its own sample, over
    (H, W) frames: per window 120-edge additive and subtractive stars, a
    60-edge star reaching past the window, a round and a rotated ellipse
    and a needle ellipse (7 primitives); a quad-packed atlas of 2
    textures, whole-valued frames and flow."""
    from flowgen_torch.compose.render import prepare_atlas

    rng = np.random.default_rng(seed)
    C, E = 7, 120
    n = len(wins)
    edges = np.zeros((n, 4, C, E), np.float32)
    meta = np.zeros((n, 3 + 3 * C), np.int32)
    fmeta = np.zeros((n, 6 + 8 * C), np.float32)
    win = np.zeros((n, 4), np.int32)
    for i, (y0, x0, wh, ww) in enumerate(wins):
        cx, cy = x0 + ww / 2, y0 + wh / 2
        r = max(min(wh, ww) / 3, 3.0)
        for c, (ne, r0, r1, dx) in ((0, (120, 0.3 * r, r, 0.0)),
                                    (2, (120, 0.1 * r, 0.4 * r, 0.2 * r)),
                                    (5, (60, 0.5 * r, 2.5 * r, -0.3 * r))):
            edges[i, :, c] = _star_edges(rng, ne, cx + dx, cy, r0, r1)
            meta[i, 3 + 2 * C + c] = ne
        meta[i, 3 + C + np.array([0, 2, 5])] = 1            # polygons
        meta[i, 3 + np.array([0, 1, 3, 4, 5])] = 1          # additive
        for c, (ex, ey, rx, ry, th) in (
                (1, (cx - 0.2 * r, cy, 0.5 * r, 0.4 * r, 0.0)),
                (3, (cx + 0.3 * r, cy - 0.2 * r, 0.8 * r, 0.3 * r, 0.7)),
                (4, (cx, cy + 0.1 * r, 1.5 * r, 0.02 * r, 1.1)),
                (6, (cx, cy, 0.2 * r, 0.2 * r, 0.0))):
            fmeta[i, 6 + 8 * c:12 + 8 * c] = _ellipse_inverse(ex, ey, th, 1.1)
            fmeta[i, 12 + 8 * c:14 + 8 * c] = rx, ry
        meta[i, :3] = C, x0, y0
        fmeta[i, :6] = [1.02, -0.05, 3.5, 0.04, 0.97, -2.25]
        win[i] = i, wh, ww, i % 2
    atlas = rng.integers(0, 256, (2, H + 16, W + 32, 3)).astype(np.uint8)
    frames = np.round(rng.uniform(0, 255, (n, H, W, 3))).astype(np.float32)
    flow = rng.normal(0, 2, (n, H, W, 2)).astype(np.float32)
    T = torch.from_numpy
    return (T(edges.reshape(n, 4, C * E)), T(meta), T(fmeta), T(win),
            T(frames), T(flow), prepare_atlas(T(atlas)), (8, 16, H, W))


# MPI-Sintel frames: a full-frame window, 192x256 windows touching each
# frame edge, 1-pixel-wide and 1-pixel-tall windows.
SINTEL_WINDOWS = [(0, 0, 436, 1024), (0, 500, 192, 256), (244, 300, 192, 256),
                  (100, 0, 192, 256), (50, 768, 192, 256), (10, 37, 300, 1),
                  (435, 0, 1, 1024), (0, 1023, 436, 1)]


@pytest.mark.parametrize("sampled,use_aa,emit_flow", [
    (False, True, True), (True, True, True), (False, False, True),
    (True, True, False)])
def test_object_window_kernel_matches_plain(sampled, use_aa, emit_flow):
    """object_window with its culls against the dense plain version, bit
    for bit up to the sign of a zero, on full-frame windows of 120-edge
    primitives, windows at each frame edge and 1-pixel windows."""
    from flowgen_torch.ops import window

    _need_card()
    dev = torch.device("cuda")
    e, m, f, w, fr, fl, atlas, crop = _object_window_inputs(
        436, 1024, SINTEL_WINDOWS, 7)
    kw = dict(crop=crop, sampled=sampled, use_aa=use_aa, emit_flow=emit_flow,
              max_hw=(436, 1024))
    kf, kfl = fr.to(dev), fl.to(dev)
    before = window.object_window.launches
    window.object_window(e.to(dev), m.to(dev), f.to(dev), w.to(dev), kf, kfl,
                         atlas.to(dev), **kw)
    torch.cuda.synchronize()
    assert window.object_window.launches == before + 1
    pf, pfl = fr.to(dev), fl.to(dev)
    with window.plain_versions():
        window.object_window(e.to(dev), m.to(dev), f.to(dev), w.to(dev), pf,
                             pfl, atlas.to(dev), **kw)
    # Bit for bit, the sign of a zero aside (x + 0.0 turns -0 into +0): the
    # kernel leaves unreached pixels untouched where the plain version
    # writes -0 + +0.
    for k, p in ((kf, pf), (kfl, pfl)):
        assert torch.equal((k + 0.0).view(torch.int32),
                           (p + 0.0).view(torch.int32))
    assert not torch.equal(pf.cpu(), fr)
    assert torch.equal(pfl.cpu(), fl) != emit_flow


@pytest.mark.parametrize("batch,height,width", [(1, 37, 53), (3, 96, 128),
                                                (64, 384, 512)])
def test_photometric_kernel_matches_plain(batch, height, width):
    """The photometric kernels equal their plain version bit for bit, out
    of place, at frame sizes that do and do not fill whole float4 groups,
    on values that take both arms of the value pass: whole levels (0 and
    255 included) read the table; fractional values, -0 and values one ulp
    off a level take the direct expression (-0 the table's too)."""
    from flowgen_torch.ops import photometric

    _need_card()
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(batch)
    a, b = (torch.randint(0, 256, (batch, height, width, 3), generator=g)
            .float() for _ in range(2))
    flat = a.view(-1)
    flat[::5] += torch.rand(flat[::5].shape, generator=g)
    flat[1::9] = torch.nextafter(flat[1::9], torch.tensor(300.0))
    flat[2::9] = torch.nextafter(flat[2::9], torch.tensor(-1.0))
    flat[3::17] = -0.0
    flat[4::17] = 0.0
    flat[5::17] = 255.0
    a, b = a.to(dev), b.to(dev)
    root = root_key(11, dev)
    idx = torch.arange(5, 5 + batch, device=dev)
    before = photometric.augment_batch.launches
    k0, k1 = photometric.augment_batch(root, idx, a, b)
    torch.cuda.synchronize()
    assert photometric.augment_batch.launches == before + 1
    p0, p1 = photometric.augment_batch_plain(root, idx, a, b)
    assert torch.equal(k0.view(torch.int32), p0.view(torch.int32))
    assert torch.equal(k1.view(torch.int32), p1.view(torch.int32))
    assert not torch.equal(k0, a)


def _db(height, width, seed=0):
    from flowgen_torch.texture_io import build_texture_db

    rng = np.random.default_rng(seed)

    def tex(h, w):
        base = rng.integers(0, 255, (h // 8 + 1, w // 8 + 1, 3), np.uint8)
        return np.kron(base, np.ones((8, 8, 1), np.uint8))[:h, :w]

    return build_texture_db(
        [tex(2 * height, 2 * width), tex(height // 2 + 3, width // 2 + 5),
         tex(3 * height + 17, 3 * width + 40)], height=height, width=width)


@pytest.mark.parametrize("mode", [7, 13])
def test_texture_db_scene_kernel_matches_plain(mode):
    """Background slabs of native sources (wider than 2W, per-source reflect
    periods smaller than the slab): the scene kernel against its plain
    version, bit for bit."""
    _need_card()
    dev = torch.device("cuda")
    cfg = flowgen_torch.DataGenConfig(mode=mode, batch_size=6, width=256,
                                      height=192, compute_inverse_flow=True,
                                      emit_masks=True)
    slabs = make_slab_packer(cfg, dev)(_db(cfg.height, cfg.width))
    scenes = sample_scene_batch(root_key(5, dev),
                                torch.arange(cfg.batch_size, device=dev), cfg)
    args, opts = fused.scene_tables(scenes, cfg, *slabs)
    kf, kl, ki = ps.scene_render(*args, **opts)
    torch.cuda.synchronize()
    pf, pl, pi = ps.scene_render_plain(*args, **opts)
    assert torch.equal(kf, pf) and torch.equal(ki, pi)
    assert torch.equal((kl + 0.0).view(torch.int32), (pl + 0.0).view(torch.int32))


@pytest.mark.parametrize("kw", [
    dict(mode=7, photometric_augment=True),
    dict(mode=13, photometric_augment=True, render_impl="windowed"),
])
def test_generate_batch_texture_db_cuda_matches_cpu(kw):
    """A TextureDB, the photometric stage on, on the card and on the CPU:
    equal frames within a level (the windowed renderer's composed branch
    and the CPU's own float order), equal flow within the gates."""
    _need_card()
    cfg = flowgen_torch.DataGenConfig(batch_size=2, width=128, height=96,
                                      **kw)
    db = _db(cfg.height, cfg.width, seed=1)
    a = generate_batch(3, 1, db, cfg, device="cuda")
    b = generate_batch(3, 1, db, cfg, device="cpu")
    for k in ("image0", "image1"):
        d = (a[k].cpu() - b[k]).abs()
        assert (d >= 1).float().mean().item() < 0.01
    d = (a["flow0"].cpu() - b["flow0"]).abs()
    assert d.flatten().median().item() < 1e-4


def test_xla_bank_cuda_matches_cpu():
    """Mode 9's "xla" bank stream (plain PyTorch on both devices) on the card
    against the CPU, by the bank gate: NaN-mask mismatch under 1e-4, median
    |d| < 1e-4 px, under 1e-3 of values with |d| > 0.01 px."""
    _need_card()
    from flowgen_torch.warpfields import generator as wg

    cfg = flowgen_torch.DataGenConfig(mode=9, batch_size=2, width=128,
                                      height=96, warp_bank_impl="xla")
    bg, ag = wg.make_bank_and_aux(root_key(0, "cuda"), 0, cfg)
    bc, ac = wg.make_bank_and_aux(root_key(0, "cpu"), 0, cfg)
    for a, b in ((bg.flow, bc.flow), (bg.iflow, bc.iflow), (ag.obj, ac.obj),
                 (ag.bg, ac.bg)):
        a = a.cpu()
        na, nb = torch.isnan(a), torch.isnan(b)
        assert (na != nb).float().mean().item() < 1e-4
        d = (a - b).abs()[~na & ~nb]
        assert d.median().item() < 1e-4
        assert (d > 0.01).float().mean().item() < 1e-3


@pytest.mark.parametrize("render_impl", ["fused", "windowed"])
def test_generate_batch_xla_cuda_matches_cpu(render_impl):
    """Mode 9 with the "xla" stream seed to batch on the card and on the
    CPU, within the on-device gates."""
    _need_card()
    cfg = flowgen_torch.DataGenConfig(mode=9, batch_size=2, width=128,
                                      height=96, warp_bank_impl="xla",
                                      render_impl=render_impl)
    atlas = flowgen_torch.procedural_atlas(4, height=96, width=128)
    g = generate_batch(1, 0, atlas, cfg, device="cuda")
    c = generate_batch(1, 0, atlas, cfg, device="cpu")
    for k in ("image0", "image1"):
        d = (g[k].cpu() - c[k]).abs()
        assert d.ge(1).float().mean().item() < 0.01
        assert d.ge(2).float().mean().item() < 1e-4
    d = (g["flow0"].cpu() - c["flow0"]).abs()
    assert d.flatten().median().item() < 1e-4
    assert (d > 0.01).float().mean().item() < 1e-3


def test_flownet_forward_cuda_matches_cpu():
    """FlowNetS (width 8) on the card with TF32 off against the CPU, on
    weights from a seed: |d| <= 1e-4 + 1e-4 |want|."""
    _need_card()
    from flowgen_torch.train import flownet

    torch.manual_seed(0)
    ref = flownet.create_model(width=8)
    model = flownet.create_model(width=8).cuda()
    model.load_state_dict(ref.state_dict())
    x = torch.randn(2, 6, 128, 256)
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.no_grad():
            got = model(x.cuda())
            want = ref(x)
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    for g, w in zip(got, want):
        torch.testing.assert_close(g.cpu(), w, rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# The sampler's CUDA graph (params/sampler.py:_SamplerGraph)
# ---------------------------------------------------------------------------


def _scene_leaves(scene):
    from flowgen_torch.params.blueprint import map_scene

    out = []
    map_scene(out.append, scene)
    return out


def _assert_bitwise_equal(got, want):
    for g, w in zip(_scene_leaves(got), _scene_leaves(want), strict=True):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g.contiguous().view(torch.uint8),
                           w.contiguous().view(torch.uint8))


def _eager_scenes(root, idx, cfg, slots):
    from flowgen_torch.params.sampler import sample_scene
    from flowgen_torch.random.streams import sample_key

    return sample_scene(sample_key(root, idx), cfg.mode_spec,
                        width=cfg.width, height=cfg.height,
                        n_warp_slots=slots)


@pytest.mark.parametrize("mode,width,height,batch,steps", [
    (7, 512, 384, 8, 6), (9, 512, 384, 8, 3), (1, 256, 192, 4, 3),
    (7, 1024, 436, 4, 3),
], ids=["mode7", "mode9", "mode1", "frame_1024x436"])
def test_sampler_graph_replays_eager_scenes(mode, width, height, batch,
                                            steps):
    """The graph's scenes equal the eager sampler's bit for bit, step after
    step and under two roots (so its static inputs take each call's
    values), in mode 9 with its bank's warp slots, mode 1's rectangles and
    a frame that is no multiple of (8, 128); a scene returned by one call
    is unchanged after the next."""
    _need_card()
    from flowgen_torch.warpfields.generator import bank_size

    dev = torch.device("cuda")
    cfg = flowgen_torch.DataGenConfig(mode=mode, batch_size=batch,
                                      width=width, height=height)
    slots = bank_size(cfg) if cfg.mode_spec.warp_p > 0.0 else 1
    assert mode != 9 or slots > 1
    held = None
    for seed in (11, 2**31 + 7):
        root = root_key(seed, dev)
        for step in range(steps):
            idx = step * batch + torch.arange(batch, device=dev)
            got = sample_scene_batch(root, idx, cfg, n_warp_slots=slots)
            _assert_bitwise_equal(got, _eager_scenes(root, idx, cfg, slots))
            if held is None:
                held = (got, [t.clone() for t in _scene_leaves(got)])
    for a, b in zip(_scene_leaves(held[0]), held[1]):
        assert torch.equal(a, b)


def test_sampler_graph_counts_one_capture_per_key():
    """A key's first call captures and every later one replays; host
    indices (a list) are taken too."""
    _need_card()
    from flowgen_torch.params.sampler import sampler_graph_stats

    dev = torch.device("cuda")
    cfg = flowgen_torch.DataGenConfig(mode=7, batch_size=3, width=256,
                                      height=160)
    root = root_key(4, dev)
    before = sampler_graph_stats()
    for step in range(5):
        got = sample_scene_batch(root, [3 * step, 3 * step + 1, 3 * step + 2],
                                 cfg)
    after = sampler_graph_stats()
    assert {k: after[k] - before[k] for k in after} == {
        "capture": 1, "replay": 4, "eager": 0}
    _assert_bitwise_equal(
        got, _eager_scenes(root, torch.arange(12, 15, device=dev), cfg, 1))


@pytest.mark.parametrize("mode", [1, 7, 9])
def test_warm_eager_sampler_does_not_synchronize(mode):
    """After one call, the eager sampler on the card makes no call that
    waits for the device (no host-to-device copy of host data): what makes
    it capturable."""
    _need_card()
    dev = torch.device("cuda")
    cfg = flowgen_torch.DataGenConfig(mode=mode, batch_size=4, width=256,
                                      height=192)
    root, idx = root_key(9, dev), torch.arange(4, device=dev)
    _eager_scenes(root, idx, cfg, 3)
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        _eager_scenes(root, idx, cfg, 3)
    finally:
        torch.cuda.set_sync_debug_mode(prev)


def test_sampler_graph_shared_by_threads():
    """Eight threads, half of them on streams of their own, share one key's
    graph under a short switch interval: every scene equals the eager
    one."""
    _need_card()
    import contextlib
    import sys
    import threading

    dev = torch.device("cuda")
    cfg = flowgen_torch.DataGenConfig(mode=7, batch_size=4, width=256,
                                      height=128)
    root = root_key(21, dev)
    idx = [4 * i + torch.arange(4, device=dev) for i in range(16)]
    want = [_eager_scenes(root, ix, cfg, 1) for ix in idx]
    torch.cuda.synchronize()
    got, errors = {}, []

    def work(t):
        try:
            ctx = (torch.cuda.stream(torch.cuda.Stream()) if t % 2
                   else contextlib.nullcontext())
            with ctx:
                for i in range(t, 16, 8):
                    got[i] = sample_scene_batch(root, idx[i], cfg)
                torch.cuda.current_stream().synchronize()
        except Exception as e:  # reported below, with the thread's number
            errors.append((t, e))

    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(t,)) for t in range(8)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=300)
    finally:
        sys.setswitchinterval(prev)
    assert not any(th.is_alive() for th in threads)
    assert errors == []
    torch.cuda.synchronize()
    for i in range(16):
        _assert_bitwise_equal(got[i], want[i])
