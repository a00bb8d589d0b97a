"""The port's plain two-pass resample against the JAX package's
``two_pass_reference`` and ``affine_resample_pallas`` (interpret mode) on
affines inside mode 7's motion envelope, and the per-pixel closed form the
CUDA kernel evaluates against the staged two-pass form."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flowgen.ops import affine as jaff
from flowgen.ops import pallas_resample as jres
from flowgen_torch.ops import resample as tres

torch.set_num_threads(1)

H, W = 160, 256
MY = MX = 32
WH, WW = 64, 128

# Mode 7's envelope: total rotation up to 40 deg, inverse scale up to 1.34.
CASES = [
    ("identity", 0.0, 1.0, 0.0, 0.0),
    ("trans", 0.0, 1.0, 7.3, -4.2),
    ("zoom", 0.0, 1.25, 3.0, 2.0),
    ("rot10", np.deg2rad(10), 1.1, 5.0, -3.0),
    ("rot-20", np.deg2rad(-20), 0.85, -6.0, 8.0),
    ("rot35", np.deg2rad(35), 0.75, 2.0, 1.5),
]


@pytest.fixture(scope="module")
def img():
    rng = np.random.default_rng(0)
    return rng.integers(0, 256, (H, W, 3)).astype(np.uint8)


@pytest.fixture(scope="module")
def slabs(img):
    j = np.asarray(jres.pack_padded_slab(jnp.asarray(img), MY, MX))
    t = tres.pack_padded_slab(torch.from_numpy(img), MY, MX)
    return j, t


def _transform(rot, zoom, tx, ty):
    t_img = jaff.chain(
        jaff.translation(tx, ty),
        jaff.conjugate_about(jaff.rotation(rot), W / 2, H / 2),
        jaff.scaling(1.0 / zoom),
    )
    return np.asarray(jaff.compose(t_img, jaff.translation(MX, MY)))


def test_slab_packing_matches(slabs):
    np.testing.assert_array_equal(slabs[1].numpy(), slabs[0])


def _port(tslab, t, x0, y0, P):
    co = tres.two_pass_coeffs(torch.from_numpy(t.copy()))
    co = tuple(np.float32(c.item()) for c in co)
    r, g, b = tres.two_pass_window(tslab, co, x0, y0, WH, WW, P, tslab.shape[1])
    return torch.stack([r, g, b], -1).numpy()


@pytest.mark.parametrize("name,rot,zoom,tx,ty", CASES)
def test_plain_matches_reference(slabs, name, rot, zoom, tx, ty):
    t = _transform(rot, zoom, tx, ty)
    P = jres.max_row_span(WH, WW, 0.7, 1.35)
    ref = np.asarray(jres.two_pass_reference(jnp.asarray(slabs[0]), t, 4, 8,
                                             WH, WW, P))
    out = _port(slabs[1], t, 4, 8, P)
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-4)


@pytest.mark.parametrize("name,rot,zoom,tx,ty", CASES[::2])
def test_plain_matches_pallas_interpret(slabs, name, rot, zoom, tx, ty):
    t = _transform(rot, zoom, tx, ty)
    P = jres.max_row_span(WH, WW, 0.7, 1.35)
    ker = np.asarray(jres.affine_resample_pallas(
        jnp.asarray(slabs[0]), t, 4, 8, wh=WH, ww=WW, P=P,
        x_tiles_scan=jres.scan_tiles_pass1(1.8, 0.85, P),
        y_tiles_scan=jres.scan_tiles_pass2(0.9, 1.35, 128),
        interpret=True,
    ))
    out = _port(slabs[1], t, 4, 8, P)
    # The interpret-mode kernel itself sits up to ~7e-3 (sub-LSB of u8) from
    # two_pass_reference on rotated affines, which the port matches to 1e-4
    # above; tests/test_resample.py holds the kernel to 2e-2 for that reason.
    np.testing.assert_allclose(out, ker, rtol=0, atol=2e-2)


@pytest.mark.parametrize("name,rot,zoom,tx,ty", CASES[::2])
def test_affine_resample_on_cpu_is_the_plain_version(slabs, name, rot, zoom,
                                                     tx, ty):
    """The standalone wrapper (affine_resample_pallas's counterpart) runs
    its plain version on a CPU slab, in the JAX kernel's signature."""
    t = _transform(rot, zoom, tx, ty)
    P = jres.max_row_span(WH, WW, 0.7, 1.35)
    tres.affine_resample.launches = 0
    out = tres.affine_resample(slabs[1], torch.from_numpy(t.copy()), 4, 8,
                               wh=WH, ww=WW, P=P)
    assert out.shape == (WH, WW, 3) and out.dtype == torch.float32
    np.testing.assert_array_equal(out.numpy(), _port(slabs[1], t, 4, 8, P))
    assert tres.affine_resample.launches == 0
    with pytest.raises(ValueError, match="CUDA"):
        tres.affine_resample(slabs[1].to("meta"), t, 4, 8, wh=WH, ww=WW, P=P)


@pytest.mark.parametrize("name,rot,zoom,tx,ty", CASES)
def test_closed_form_equals_staged(slabs, name, rot, zoom, tx, ty):
    t = _transform(rot, zoom, tx, ty)
    P = jres.max_row_span(WH, WW, 0.7, 1.35)
    slab = slabs[1]
    co = tuple(np.float32(c.item()) for c in tres.two_pass_coeffs(torch.from_numpy(t.copy())))
    x0, y0 = 4, 8
    w0 = tres.pass1_row_start(co, x0, y0, WH, WW, P, slab.shape[0])
    CW = 128 * 3
    c0, co2 = tres.col_window(co, x0, w0, WW, P, CW, slab.shape[1])
    rows = slab[w0 : w0 + P, c0 : c0 + CW]
    staged = tres.resample_rows(rows, w0, co2, x0, y0, WH, WW)
    ys, xs = torch.meshgrid(torch.arange(WH) + y0, torch.arange(WW) + x0,
                            indexing="ij")
    closed = tres.resample_pixels(rows, w0, co2, xs, ys)
    for a, b in zip(staged, closed):
        assert torch.equal(a, b)
    # Column windowing changes nothing inside the envelope.
    full = tres.resample_rows(slab[w0 : w0 + P], w0, co, x0, y0, WH, WW)
    for a, b in zip(staged, full):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-4)


def test_fold_coeffs_scalar_matches_host_fold():
    """The in-kernel reflect fold (floor form) agrees with the host fold
    (jnp.mod form) of compose/fused._fold_coeffs away from fold seams."""
    from flowgen.compose import fused as jf

    rng = np.random.default_rng(3)
    for _ in range(20):
        th = rng.uniform(-0.6, 0.6)
        s = rng.uniform(0.8, 1.25)
        t = np.array([[np.cos(th) * s, -np.sin(th) * s, rng.uniform(-900, 900)],
                      [np.sin(th) * s, np.cos(th) * s, rng.uniform(-700, 700)]],
                     np.float32)
        cx, cy = 128.0 + 64.0, 96.0 + 48.0
        ref = np.asarray(jf._fold_coeffs(
            jnp.asarray(t)[None], jnp.float32([[cx]]), jnp.float32([[cy]]),
            512.0, 384.0, 256.0))[0, 0]
        got = tres.fold_coeffs_scalar(t.reshape(6), cx, cy, 512.0, 384.0, 256.0)
        np.testing.assert_allclose(np.array(got, np.float32), ref, rtol=1e-6,
                                   atol=1e-3)
