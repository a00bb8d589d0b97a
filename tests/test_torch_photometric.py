"""The port's photometric augmentation against the JAX package on the CPU.

XLA:CPU's float32 ``erf_inv``, ``log1p`` and ``pow`` against ``_fp``'s
restatements on 200,000 inputs each, bit for bit; ``streams.normal`` and the
7-way split's draws against ``jax.random``; ``augment_batch`` (the kernel's
plain version, which runs on CPU tensors) against the JAX package's, bit for
bit; the cases of ``tests/test_photometric.py`` on the port; and
``generate_batch`` in mode 7 with the stage on against the JAX package's
jitted step (128x96, B=2; the JAX side renders through its scene kernel in
interpret mode) within the image gate of ``tools/check_pallas_tpu.py``:
under 1% of values >= 1 level apart and under 1e-4 >= 2 levels."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flowgen
import flowgen_torch
from flowgen.ops import photometric as jph
from flowgen.pipeline.generator import generate_batch as j_generate
from flowgen.random.streams import root_key as j_root
from flowgen.random.streams import sample_key as j_sample_key
from flowgen_torch import _fp
from flowgen_torch.ops import photometric as tph
from flowgen_torch.pipeline.generator import generate_batch as t_generate
from flowgen_torch.random import streams as ts

torch.set_num_threads(1)

W, H = 128, 96
N = 200_000


def _bits(a):
    return np.asarray(a, np.float32).view(np.int32)


def _fp_inputs(name):
    rng = np.random.default_rng(11)
    if name == "erf_inv":
        x = rng.uniform(-1.0, 1.0, N)
        x[:1000] = 1.0 - rng.uniform(0.0, 1e-3, 1000)
        x[1000:1003] = (np.nextafter(np.float32(-1), np.float32(0)), 0.0,
                        -0.5)
        return (x.astype(np.float32),)
    if name == "log1p":
        u = rng.uniform(-1.0, 1.0, N // 2)
        return (np.concatenate([-(u * u), rng.uniform(-0.999, 5.0, N // 2)]
                               ).astype(np.float32),)
    x = np.maximum(rng.uniform(0.0, 2.0, N), 1e-6)
    x[:2000] = np.exp(rng.uniform(np.log(1e-6), 0.0, 2000))
    return (x.astype(np.float32),
            rng.uniform(0.7, 1.5, N).astype(np.float32))


@pytest.mark.parametrize("name,jfn", [
    ("erf_inv", jax.lax.erf_inv),
    ("log1p", jnp.log1p),
    ("pow", jnp.power),
])
def test_fp_matches_xla_cpu(name, jfn):
    args = _fp_inputs(name)
    want = np.asarray(jax.jit(jfn)(*[jnp.asarray(a) for a in args]))
    got = getattr(_fp, name)(*[torch.from_numpy(a) for a in args]).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(want))


def test_fma_rounds_once():
    """``_fp.fma`` is a true fused multiply-add: a product whose sum with
    the addend lands a hair above a float32 tie in float64 still rounds up,
    where ``_fp._fma`` (a product and a sum rounded in float64) rounds to
    even."""
    a = torch.tensor([1 + 2 ** -12], dtype=torch.float32)
    c = torch.tensor([2.0 ** -80], dtype=torch.float32)
    assert _fp.fma(a, a, c).item() == np.float32(1 + 2 ** -11 + 2 ** -23)
    assert _fp._fma(a, a, c).item() == np.float32(1 + 2 ** -11)


def test_normal_and_split_draws_match_jax():
    key = jax.random.key_data(jax.random.key(3))
    tkey = torch.from_numpy(np.asarray(key).astype(np.int64))
    for shape in ((), (5,), (96, 128, 3)):
        want = np.asarray(jax.random.normal(jax.random.wrap_key_data(key),
                                            shape))
        np.testing.assert_array_equal(_bits(ts.normal(tkey, shape).numpy()),
                                      _bits(want))
    # The per-sample keys and draws of augment_pair, for a batch of samples.
    idx = np.arange(17, 21)
    jk = jax.vmap(lambda i: jax.random.key_data(jax.random.split(
        jax.random.fold_in(j_sample_key(j_root(5), i), jph.AUX_PHOTOMETRIC),
        7)))(jnp.asarray(idx))
    tk = tph.photo_keys(ts.root_key(5), torch.from_numpy(idx))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk).astype(np.int64))
    p = jph.PhotoParams()
    wrap = jax.random.wrap_key_data
    draws = [
        (0, lambda k: jax.random.uniform(k, (3,), minval=p.color_range[0],
                                         maxval=p.color_range[1]),
         lambda k: ts.uniform(k, *p.color_range, (3,))),
        (1, lambda k: jax.random.uniform(k, (), minval=p.gamma_range[0],
                                         maxval=p.gamma_range[1]),
         lambda k: ts.uniform(k, *p.gamma_range)),
        (2, lambda k: jax.random.normal(k, ()), lambda k: ts.normal(k)),
        (3, lambda k: jax.random.uniform(k, (), minval=p.contrast_range[0],
                                         maxval=p.contrast_range[1]),
         lambda k: ts.uniform(k, *p.contrast_range)),
        (4, lambda k: jax.random.uniform(k, (), minval=p.noise_sigma_range[0],
                                         maxval=p.noise_sigma_range[1]),
         lambda k: ts.uniform(k, *p.noise_sigma_range)),
        (5, lambda k: jax.random.normal(k, (4, 6, 3)),
         lambda k: ts.normal(k, (4, 6, 3))),
    ]
    for j, jdraw, tdraw in draws:
        want = np.asarray(jax.vmap(lambda k: jdraw(wrap(k)))(jk[:, j]))
        np.testing.assert_array_equal(_bits(tdraw(tk[:, j]).numpy()),
                                      _bits(want))


def _images(b, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (b, H, W, 3)).astype(np.float32)
            for _ in range(2)]


def test_augment_batch_matches_jax():
    a, b = _images(4)
    idx = np.arange(10, 14)
    want = jax.jit(jph.augment_batch)(j_root(3), jnp.asarray(idx),
                                      jnp.asarray(a), jnp.asarray(b))
    got = tph.augment_batch(ts.root_key(3), torch.from_numpy(idx),
                            torch.from_numpy(a), torch.from_numpy(b))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_bits(g.numpy()), _bits(w))


def test_augment_pair_matches_jax():
    a, b = (x[0] for x in _images(1, seed=1))
    key = jax.random.key(9)
    want = jax.jit(jph.augment_pair)(key, jnp.asarray(a), jnp.asarray(b))
    tkey = torch.from_numpy(np.asarray(jax.random.key_data(key), np.int64))
    got = tph.augment_pair(tkey, torch.from_numpy(a), torch.from_numpy(b))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_bits(g.numpy()), _bits(w))


def _run(photometric, seed=5, batch=2):
    cfg = flowgen_torch.DataGenConfig(
        mode=7, batch_size=batch, width=W, height=H, seed=seed,
        photometric_augment=photometric,
    )
    atlas = flowgen_torch.procedural_atlas(3, height=H, width=W)
    return {k: v.numpy() for k, v in
            t_generate(seed, 0, atlas, cfg, device="cpu").items()}


def test_flow_and_scene_content_unchanged():
    raw = _run(False)
    aug = _run(True)
    np.testing.assert_array_equal(raw["flow0"], aug["flow0"])
    assert not np.allclose(raw["image0"], aug["image0"])
    assert not np.allclose(raw["image1"], aug["image1"])


def test_range_and_determinism():
    a = _run(True)
    b = _run(True)
    for k in ("image0", "image1"):
        assert np.isfinite(a[k]).all()
        assert a[k].min() >= 0.0 and a[k].max() <= 255.0
        np.testing.assert_array_equal(a[k], b[k])
    assert not np.allclose(a["image0"][0], a["image0"][1])


def test_pair_shares_transform_noise_differs():
    img = torch.from_numpy(
        flowgen_torch.procedural_atlas(1, height=64, width=128)[0]
        .astype(np.float32))
    o0, o1 = tph.augment_pair(ts.fold_in(ts.root_key(0), 7), img, img)
    d = (o0 - o1).abs()
    assert float(d.max()) < 8.0 * 0.04 * 255.0
    assert float(d.mean()) > 0.0


def test_stream_layout_untouched():
    assert tph.AUX_PHOTOMETRIC == jph.AUX_PHOTOMETRIC
    assert tph.AUX_PHOTOMETRIC not in {int(s) for s in ts.Stream}
    assert tuple(tph.PhotoParams()) == tuple(jph.PhotoParams())


def test_generate_batch_mode7_matches_jax():
    """End to end through the scene kernel's path, against the JAX
    package's jitted step (its production form: eager dispatch fuses, and
    so rounds, differently). The photometric stage itself is bit-equal
    (above); what differs here comes from the renders, whose 1-level
    differences the jitter scales (max |d| measured: 1.09 levels on one
    value of 73,728)."""
    jc = flowgen.DataGenConfig(mode=7, batch_size=2, width=W, height=H,
                               photometric_augment=True)
    atlas = flowgen.procedural_atlas(3, height=H, width=W)
    want = jax.jit(functools.partial(j_generate, cfg=jc))(
        j_root(0), 1, jnp.asarray(atlas))
    tc = flowgen_torch.DataGenConfig(mode=7, batch_size=2, width=W, height=H,
                                     photometric_augment=True)
    got = t_generate(0, 1, atlas, tc, device="cpu")
    for k in ("image0", "image1"):
        d = np.abs(got[k].numpy() - np.asarray(want[k]))
        assert (d >= 1).mean() < 0.01, k
        assert (d >= 2).mean() < 1e-4, k
    dflow = np.abs(got["flow0"].numpy() - np.asarray(want["flow0"]))
    assert np.median(dflow) < 1e-4
    assert (dflow > 0.01).mean() < 1e-3


@pytest.mark.parametrize("seed", [0, 7])
def test_map_table_holds_the_shared_map_of_every_level(seed):
    """What the kernel's table rests on: the shared map of a whole level L
    of channel c depends on (sample, c, L) alone. For every level of every
    channel, placed anywhere in a frame (-0 standing for 0), ``map_table``'s
    entry equals the map ``_augment`` computes there, bit for bit; and the
    table with the noise added gives ``augment_batch_plain``'s bits."""
    b, h, w = 3, 16, 16
    rng = np.random.default_rng(seed)
    lv = np.stack([np.stack([rng.permutation(256) for _ in range(3)], -1)
                   for _ in range(b)]).reshape(b, h, w, 3).astype(np.float32)
    x = torch.from_numpy(lv)
    x[1][x[1] == 0] = -0.0
    root, idx = ts.root_key(seed), torch.arange(4, 4 + b)
    table = tph.map_table(root, idx)
    assert table.shape == (b, 3, 256) and table.dtype == torch.float32
    keys7 = tph.photo_keys(root, idx)
    color, gamma, bright, contrast, sigma = tph.shared_draws(keys7)
    mapped = tph._shared_map(x, color, gamma, bright, contrast)
    level = torch.from_numpy(lv).long()
    looked_up = torch.stack([table[i].gather(1, level[i].reshape(-1, 3).T).T
                             .reshape(h, w, 3) for i in range(b)])
    np.testing.assert_array_equal(_bits(looked_up.numpy()),
                                  _bits(mapped.numpy()))
    want = tph.augment_batch_plain(root, idx, x, x)
    for f, wf in ((5, want[0]), (6, want[1])):
        noise = _fp.erf_inv(ts.uniform(keys7[:, f], ts.NORMAL_LO, 1.0,
                                       (h, w, 3)))
        got = torch.clamp(_fp.fma(noise, sigma.reshape(-1, 1, 1, 1),
                                  looked_up), 0.0, 1.0) * 255.0
        np.testing.assert_array_equal(_bits(got.numpy()), _bits(wf.numpy()))
