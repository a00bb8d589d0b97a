"""Scene sampling in the PyTorch port against the JAX package: the same
(seed, sample indices) give the same scenes, bit for bit: the port's
``_fp.sin``, ``cos`` and ``log`` restate XLA:CPU's float32 functions."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flowgen
import flowgen_torch
from flowgen.params import sampler as jsamp
from flowgen.random.streams import root_key as j_root
from flowgen_torch.params import sampler as tsamp
from flowgen_torch.random.streams import root_key as t_root

torch.set_num_threads(1)

W, H, B = 128, 96, 4


def _leaves(mode, seed=0, base=0):
    jc = flowgen.DataGenConfig(mode=mode, batch_size=B, width=W, height=H)
    tc = flowgen_torch.DataGenConfig(mode=mode, batch_size=B, width=W, height=H)
    js = jax.tree.map(
        np.asarray, jsamp.sample_scene_batch(j_root(seed), base + jnp.arange(B), jc)
    )
    tsc = tsamp.sample_scene_batch(t_root(seed), base + torch.arange(B), tc)
    jl = jax.tree_util.tree_flatten_with_path(js)[0]
    tl = jax.tree_util.tree_leaves(tsc)
    assert len(jl) == len(tl)
    return [(jax.tree_util.keystr(p), a, b.numpy()) for (p, a), b in zip(jl, tl)]


@pytest.mark.parametrize("mode", [1, 7])
def test_sample_scene_batch_matches(mode):
    """Every leaf, integer or float, equals the JAX package's."""
    n_float = 0
    for name, a, b in _leaves(mode):
        assert a.shape == b.shape, name
        n_float += a.dtype.kind == "f"
        np.testing.assert_array_equal(b.astype(a.dtype), a, err_msg=name)
    assert n_float >= 8


def test_sample_scene_other_seed_and_base():
    for name, a, b in _leaves(7, seed=12345, base=1000):
        np.testing.assert_array_equal(b.astype(a.dtype), a, err_msg=name)


@pytest.mark.parametrize("name", ["sin", "cos", "log"])
def test_transcendentals_match_xla(name):
    """``_fp.sin``, ``cos`` and ``log`` equal XLA:CPU's float32 functions
    bit for bit over the sampler's ranges (where ``torch.sin``, ``cos`` and
    ``log`` differ on several percent of inputs)."""
    from flowgen_torch import _fp

    rng = np.random.default_rng(7)
    if name == "log":
        x = np.concatenate([rng.uniform(1e-7, 1.0, 20000),
                            rng.uniform(1.0, 1e6, 5000),
                            [2.0 ** -24, 1.0, 0.0]])
    else:
        x = np.concatenate([rng.uniform(-7.0, 7.0, 20000),
                            rng.uniform(-119.0, 119.0, 5000),
                            rng.uniform(-1e-3, 1e-3, 2000), [0.0]])
    x = x.astype(np.float32)
    ref = np.asarray(getattr(jnp, name)(jnp.asarray(x)))
    got = getattr(_fp, name)(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, ref)


def test_flatten_outline_matches():
    """The index-gather compaction equals the one-hot matmul compaction."""
    rng = np.random.default_rng(1)
    S = 20
    for trial in range(12):
        n = int(rng.integers(3, S + 1))
        verts = rng.uniform(-80, 80, (S, 2)).astype(np.float32)
        types = [0]
        prev = False
        for i in range(1, S):
            curve = (i < n - 1) and rng.random() < 0.4 and not prev
            types.append(0 if prev else (2 if curve else 1))
            prev = curve
        types = np.array(types, np.int32)
        jp, jn = jsamp.flatten_outline(jnp.asarray(verts), jnp.asarray(types),
                                       jnp.int32(n))
        tp, tn = tsamp.flatten_outline(torch.from_numpy(verts),
                                       torch.from_numpy(types),
                                       torch.tensor(n, dtype=torch.int32))
        assert int(tn) == int(jn)
        np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=0, atol=1e-5)


def test_cpu_batch_stays_eager():
    """On the CPU ``sample_scene_batch`` runs the sampler eagerly: the
    counters see one eager call and no graph, and the scenes are the JAX
    package's."""
    before = tsamp.sampler_graph_stats()
    leaves = _leaves(7, seed=77, base=40)
    after = tsamp.sampler_graph_stats()
    assert {k: after[k] - before[k] for k in after} == {
        "capture": 0, "replay": 0, "eager": 1}
    for name, a, b in leaves:
        np.testing.assert_array_equal(b.astype(a.dtype), a, err_msg=name)


def _moves_device(self, *args, **kwargs):
    return "device" in kwargs or any(
        isinstance(a, (torch.device, str)) or torch.is_tensor(a) for a in args)


@pytest.mark.parametrize("mode,slots", [(1, 1), (7, 1), (9, 6)])
def test_warm_sampler_makes_no_tensor_from_host_data(monkeypatch, mode, slots):
    """After one call, a second call of the sampler builds no tensor from
    host data and moves none between devices: on a card each such tensor
    is a host-to-device copy that waits for the device, which a CUDA graph
    cannot capture."""
    cfg = flowgen_torch.DataGenConfig(mode=mode, batch_size=B, width=W,
                                      height=H)
    root, idx = t_root(5), torch.arange(B) + 8

    def sample():
        return tsamp.sample_scene_batch(root, idx, cfg, n_warp_slots=slots)

    want = sample()
    counts = {}

    def counting(name, fn, when=lambda *a, **k: True):
        def wrapped(*args, **kwargs):
            if when(*args, **kwargs):
                counts[name] = counts.get(name, 0) + 1
            return fn(*args, **kwargs)
        return wrapped

    monkeypatch.setattr(torch, "tensor", counting("tensor", torch.tensor))
    monkeypatch.setattr(torch, "as_tensor", counting(
        "as_tensor", torch.as_tensor, lambda x, *a, **k: not torch.is_tensor(x)))
    monkeypatch.setattr(torch, "from_numpy",
                        counting("from_numpy", torch.from_numpy))
    monkeypatch.setattr(torch.Tensor, "to",
                        counting("to", torch.Tensor.to, _moves_device))
    got = sample()
    monkeypatch.undo()
    assert counts == {}
    for a, b in zip(jax.tree_util.tree_leaves(want),
                    jax.tree_util.tree_leaves(got)):
        assert torch.equal(a, b)
