"""threefry2x32 in PyTorch against JAX 0.9 (jax_threefry_partitionable):
keys, fold_in and the per-sample bits tables are bit-equal; the slot draws
match to a few ulp."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flowgen.random import shapers as jsh
from flowgen.random import streams as js
from flowgen_torch.random import shapers as tsh
from flowgen_torch.random import streams as ts

torch.set_num_threads(1)

SEEDS = [0, 1, 12345, 2**31 - 1]
INDICES = [0, 1, 7, 1000]


def test_threefry_partitionable_is_on():
    assert jax.config.jax_threefry_partitionable


@pytest.mark.parametrize("seed", SEEDS)
def test_root_key_matches(seed):
    jk = np.asarray(jax.random.key_data(js.root_key(seed)))
    np.testing.assert_array_equal(ts.root_key(seed).numpy(), jk.astype(np.int64))


@pytest.mark.parametrize("seed", SEEDS)
def test_sample_key_matches(seed):
    for idx in INDICES:
        jk = np.asarray(jax.random.key_data(js.sample_key(js.root_key(seed), idx)))
        tk = ts.sample_key(ts.root_key(seed), torch.tensor(idx)).numpy()
        np.testing.assert_array_equal(tk, jk.astype(np.int64))


@pytest.mark.parametrize("seed", SEEDS)
def test_sample_bits_table_bit_equal(seed):
    jb = np.stack([
        np.asarray(js.sample_bits_table(js.sample_key(js.root_key(seed), i), 5))
        for i in INDICES
    ])
    tb = ts.sample_bits_table(
        ts.sample_key(ts.root_key(seed), torch.tensor(INDICES)), 5
    ).numpy()
    assert tb.shape == jb.shape
    np.testing.assert_array_equal(tb, jb.astype(np.int64))


def test_slot_layout_matches():
    assert ts.SCOPE_STRIDE == js._layout()[1]
    jo = js._layout()[0]
    for s in js.Stream:
        assert ts.SLOT_OFFSET[ts.Stream(int(s))] == jo[s], s.name
        assert ts.Stream(int(s)).name == s.name


def _rows(seed=3, n=64):
    jrow = jnp.stack([
        js.sample_bits_table(js.sample_key(js.root_key(seed), i), 1)[0]
        for i in range(n)
    ])
    trow = ts.sample_bits_table(
        ts.sample_key(ts.root_key(seed), torch.arange(n)), 1
    )[:, 0]
    return jrow, trow


def test_scope_draws_match():
    jrow, trow = _rows()
    S = js.Stream
    jd = [js.ScopeDraws(r) for r in jrow]
    td = ts.ScopeDraws(trow)
    ju = np.array([d.uniform(S.OBJ_INIT_TRANS_X, -306.0, 818.0) for d in jd])
    np.testing.assert_array_equal(
        td.uniform(ts.Stream.OBJ_INIT_TRANS_X, -306.0, 818.0).numpy(), ju
    )
    jv = np.array([d.uniform(S.POLY_R, 20.0, 80.0, (20,)) for d in jd])
    np.testing.assert_array_equal(
        td.uniform(ts.Stream.POLY_R, 20.0, 80.0, (20,)).numpy(), jv
    )
    ji = np.array([d.uniform_int(S.POLY_SPOKES, 3, 20) for d in jd])
    np.testing.assert_array_equal(td.uniform_int(ts.Stream.POLY_SPOKES, 3, 20).numpy(), ji)
    jr = np.array([d.raw_index(S.OBJ_TEX_ID) for d in jd])
    np.testing.assert_array_equal(td.raw_index(ts.Stream.OBJ_TEX_ID).numpy(), jr)
    jn = np.array([d.normal(S.OBJ_TRANS_X) for d in jd])
    tn = td.normal(ts.Stream.OBJ_TRANS_X).numpy()
    # Box-Muller goes through log, sqrt and cos: libm ulps only.
    np.testing.assert_allclose(tn, jn, rtol=4e-7, atol=4e-7)


@pytest.mark.parametrize("name,a,b", [
    ("gaussian", -40.0, 40.0),
    ("gaussian_sq", 0.93, 1.07),
    ("gaussian_cube", -120.0, 120.0),
    ("gaussian_4", -40.0, 40.0),
])
def test_shapers_match(name, a, b):
    x = np.random.default_rng(0).normal(size=4096).astype(np.float32) * 2.5
    jv = np.asarray(getattr(jsh, name)(a, b, jnp.asarray(x)))
    tv = getattr(tsh, name)(a, b, torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(tv, jv)
