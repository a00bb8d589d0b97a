"""``warpfields/compose.py``'s public functions against the JAX package's
``pallas_fields`` (its kernels in Pallas interpret mode, jitted), bit for
bit, on numpy inputs from a seed: ``coarse_gdisp_batch`` at lattice
strides 1, 2, 4 and 8 and 0, 4, 8 and 20 fixed-point steps (at 128x256,
one lane tile at every stride), ``coarse_gdisp``, ``displace_planes``,
``displace_plane``, ``self_compose`` (``self_compose_pallas``) and the keyed
"pallas" big fields, ``make_big_field`` and ``make_big_fields_keyed``
(``make_big_field_pallas``, ``make_big_fields_pallas``). The port keeps
fields as (..., 2, S, S) planes; the JAX package as (..., S, S, 2).

About 35 s on one worker, most of it the JAX solves' compiles."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flowgen.random.streams import Stream as JStream
from flowgen.random.streams import root_key as j_root
from flowgen.random.streams import stream_key as j_stream_key
from flowgen.warpfields import pallas_fields as pf
from flowgen_torch.random.streams import Stream, root_key, stream_key
from flowgen_torch.warpfields import compose

torch.set_num_threads(1)


def _bits(a):
    return np.ascontiguousarray(np.asarray(a), np.float32).view(np.int32)


def _assert_bits(got, want):
    got = got.numpy() if torch.is_tensor(got) else got
    np.testing.assert_array_equal(_bits(got), _bits(want))


def _smooth(n, h, w, mag, seed=0):
    """(n, h, w, 2) smooth displacement fields of about ``mag`` px."""
    rng = np.random.default_rng(seed)
    y = np.linspace(0.0, 3.0, h)[:, None]
    x = np.linspace(0.0, 3.0, w)[None]
    out = np.zeros((n, h, w, 2), np.float32)
    for i in range(n):
        a = rng.uniform(-1.0, 1.0, 6)
        out[i, ..., 0] = mag * np.sin(2 * a[0] * x + 3 * a[1] * y + a[2])
        out[i, ..., 1] = mag * np.cos(3 * a[3] * x + 2 * a[4] * y + a[5])
    return out


# ---------------------------------------------------------------------------
# warpfields/compose.py
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_iter", [0, 4, 8, 20])
@pytest.mark.parametrize("stride", [1, 2, 4, 8])
def test_coarse_gdisp_batch_any_stride(stride, n_iter):
    D = _smooth(2, 128, 256, 40.0)
    want = jax.jit(lambda d: pf.coarse_gdisp_batch(
        d, stride, n_iter, interpret=True))(jnp.asarray(D))
    got = compose.coarse_gdisp_batch(torch.from_numpy(D), stride, n_iter)
    assert got.shape == (2, 128, 256)
    _assert_bits(got, want)


def test_coarse_gdisp_rejects_other_strides():
    D = torch.zeros(1, 96, 96, 2)
    for stride in (3, 0, 64):
        with pytest.raises(ValueError):
            compose.coarse_gdisp_batch(D, stride)


def test_single_field_wrappers():
    """coarse_gdisp, displace_planes and displace_plane on one field."""
    D = _smooth(1, 256, 256, 12.0, seed=1)[0]
    gd_j = jax.jit(lambda d: pf.coarse_gdisp(d, 2, 6, interpret=True))(
        jnp.asarray(D))
    gd = compose.coarse_gdisp(torch.from_numpy(D), 2, 6)
    _assert_bits(gd, gd_j)
    src = np.random.default_rng(2).normal(size=(3, 256, 256)).astype(np.float32)
    vd = D[..., 1]
    want = jax.jit(lambda s, g, v: pf.displace_planes(s, g, v, interpret=True))(
        jnp.asarray(src), gd_j, jnp.asarray(vd))
    got = compose.displace_planes(torch.from_numpy(src), gd,
                                  torch.from_numpy(vd))
    _assert_bits(got, want)
    one = jax.jit(lambda s, g, v: pf.displace_plane(s, g, v, interpret=True))(
        jnp.asarray(src[1]), gd_j, jnp.asarray(vd))
    _assert_bits(compose.displace_plane(torch.from_numpy(src[1]), gd,
                                        torch.from_numpy(vd)), one)


def test_self_compose_single_field():
    f0 = _smooth(1, 192, 192, 0.3, seed=3)[0]
    want = jax.jit(lambda f: pf.self_compose_pallas(f, 5, interpret=True))(
        jnp.asarray(f0))
    got = compose.self_compose(torch.from_numpy(f0).permute(2, 0, 1), 5)
    _assert_bits(got.permute(1, 2, 0), want)
    assert np.isnan(np.asarray(want)).any()


@pytest.mark.parametrize("size", [256, 384])
def test_keyed_big_field(size):
    """The keyed "pallas" big field at the smallest sizes the bank's
    schedule takes: 256 (one lane tile on the half lattice) and 384 (the
    big field of a 128x96 frame)."""
    jk = j_stream_key(j_root(3), JStream.WARP_FIELD, 0)
    want = jax.jit(lambda k: pf.make_big_field_pallas(k, size,
                                                      interpret=True))(jk)
    got = compose.make_big_field(stream_key(root_key(3), Stream.WARP_FIELD, 0),
                                 size)
    for g, w in zip(got, want):
        assert g.shape == (2, size, size)
        _assert_bits(g.permute(1, 2, 0), w)


def test_keyed_big_fields_coarse_iters():
    """Two keys through shared launches, 15 doublings on the half lattice
    (two at full size)."""
    jks = [j_stream_key(j_root(4), JStream.WARP_FIELD, i) for i in range(2)]
    want = jax.jit(lambda k: pf.make_big_fields_pallas(
        list(k), 256, coarse_iters=15, interpret=True))(jnp.stack(jks))
    keys = [stream_key(root_key(4), Stream.WARP_FIELD, i) for i in range(2)]
    got = compose.make_big_fields_keyed(keys, 256, coarse_iters=15)
    for g, w in zip(got, want):
        _assert_bits(g.permute(0, 2, 3, 1), w)
