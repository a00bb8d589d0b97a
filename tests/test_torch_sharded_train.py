"""The sharded FlowNetS step (``flowgen_torch/train/flownet.py``:
``shard_model``, ``param_shardings``, the data-averaged train step) against
the single-process step and the JAX package's: the port's counterpart of
``__graft_entry__.py:dryrun_multichip(4)``.

Four ``gloo`` ranks on a ``("data", "model")`` = (2, 2) CPU mesh, spawned
with a ``file://`` store under the test's temporary directory, generate the
global batch (mode 7, 64x128, B=4) sharded over ``data`` and take one
generate-and-train step of FlowNetS (width 8) on weights carried from flax,
its output channels split over ``model``. Tolerances: the loss within 1e-6
relative of the single-process step's (the same arithmetic but the
all-reduce's order), every gradient within 1e-5 relative plus 1e-7
absolute (split convolutions sum their input gradients in another order),
the loss within 1e-5 relative of the JAX package's (XLA:CPU's convolutions
sum in another order)."""

import os

import jax
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

import flowgen_torch
from flowgen.train import flownet as jfn
from flowgen_torch.interop import flownet_params_from_flax
from flowgen_torch.pipeline.generator import make_generate_fn
from flowgen_torch.train import flownet as tfn

torch.set_num_threads(1)

H, W = 64, 128
WIDTH = 8
WORLD = 4


def _cfg():
    return flowgen_torch.DataGenConfig(mode=7, batch_size=4, width=W,
                                       height=H, seed=0)


def _atlas():
    return flowgen_torch.procedural_atlas(4, height=H, width=W)


def _train_worker(rank, store, out_dir):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=WORLD)
    try:
        mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
        model = tfn.create_model(width=WIDTH)
        model.load_state_dict(torch.load(os.path.join(out_dir, "init.pt")))
        specs = tfn.param_shardings(model, mesh)
        tfn.shard_model(model, mesh)
        opt = tfn.make_optimizer(model)
        step = tfn.make_generate_and_train_step(_cfg(), model, opt, mesh=mesh)
        loss = step(0, 0, _atlas())
        named = dict(model.named_parameters())
        res = {
            "loss": float(loss),
            "grads": {k: p.grad.full_tensor() for k, p in named.items()},
            "local_shapes": {k: tuple(p.to_local().shape)
                             for k, p in named.items()},
            "sharded": sorted(k for k, s in specs.items()
                              if any(p.is_shard() for p in s)),
        }
        torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """(flax model, flax params, the single-process result, the ranks')."""
    d = tmp_path_factory.mktemp("sharded_train")
    jm = jfn.create_model(width=WIDTH)
    params = jfn.init_params(jm, jax.random.key(0), H, W)
    sd = flownet_params_from_flax(jax.tree.map(np.asarray, params))
    torch.save(sd, d / "init.pt")
    mp.spawn(_train_worker, args=(str(d / "store"), str(d)), nprocs=WORLD,
             join=True)
    ranks = [torch.load(d / f"rank{r}.pt", weights_only=False)
             for r in range(WORLD)]

    model = tfn.create_model(width=WIDTH)
    model.load_state_dict(sd)
    batch = make_generate_fn(_cfg(), "cpu")(0, 0, _atlas())
    loss = tfn.make_train_step(model, tfn.make_optimizer(model))(batch)
    single = {"loss": float(loss), "batch": batch,
              "grads": {k: p.grad for k, p in model.named_parameters()}}
    return jm, params, single, ranks


def test_loss_matches_the_single_process_step(run):
    _, _, single, ranks = run
    for got in ranks:
        assert abs(got["loss"] - single["loss"]) <= 1e-6 * abs(single["loss"])


def test_gradients_match_the_single_process_step(run):
    _, _, single, ranks = run
    for got in ranks:
        assert set(got["grads"]) == set(single["grads"])
        for k, want in single["grads"].items():
            torch.testing.assert_close(got["grads"][k], want, rtol=1e-5,
                                       atol=1e-7, msg=k)


def test_loss_matches_jax(run):
    """The JAX package's loss on the same global batch and weights."""
    jm, params, single, ranks = run
    batch = {k: v.numpy() for k, v in single["batch"].items()}
    want = float(jfn.loss_fn(jm, params, batch))
    for got in ranks:
        assert abs(got["loss"] - want) <= 1e-5 * abs(want)


def test_each_rank_holds_its_slice(run):
    """Every parameter's local shape: output channels halved over model
    where 2 divides them (a transposed convolution of 130 inputs has 65
    outputs, which stay whole)."""
    _, _, single, ranks = run
    n_split = 0
    for got in ranks:
        for k, want in single["grads"].items():
            shape = list(want.shape)
            dim = 1 if k.startswith("up.") and k.endswith("weight") else 0
            if shape[dim] % 2 == 0:
                shape[dim] //= 2
                n_split += 1
            assert got["local_shapes"][k] == tuple(shape), k
    assert n_split > len(single["grads"])


def _jax_sharded_names(params, mesh):
    """Torch names of the flax leaves that the JAX package's
    ``param_shardings`` splits (interop's layer order)."""
    specs = jfn.param_shardings(params, mesh)
    names = {}
    for i in range(15):
        names[f"Conv_{i}"] = f"enc.{i}" if i < 10 else f"predict.{i - 10}"
    for i in range(4):
        names[f"ConvTranspose_{i}"] = f"up.{i}"
    out = []
    for layer, leaves in specs.items():
        for leaf, s in leaves.items():
            if s.spec != P():
                out.append(f"{names[layer]}.{'weight' if leaf == 'kernel' else 'bias'}")
    return sorted(out)


def test_param_shardings_match_jax_on_the_mesh(run):
    jm, params, _, ranks = run
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("data", "model"))
    want = _jax_sharded_names(params, mesh)
    for got in ranks:
        assert got["sharded"] == want


class _MeshShape:
    """What ``param_shardings`` reads of a DeviceMesh: the dimension names
    and a dimension's size."""

    def __init__(self, **sizes):
        self.mesh_dim_names = tuple(sizes)
        self._sizes = sizes

    def __getitem__(self, name):
        size = self._sizes[name]
        return type("Dim", (), {"size": lambda self: size})()


@pytest.mark.parametrize("n", [1, 2, 3, 4])
def test_param_shardings_rule_matches_jax(n):
    """The rule at other model sizes, FlowNetS of width 12 (channels that 3
    and 4 divide, and predictions of 2 that they do not)."""
    jm = jfn.create_model(width=12)
    params = jfn.init_params(jm, jax.random.key(0), H, W)
    mesh = Mesh(np.array(jax.devices()[:2 * n]).reshape(2, n),
                ("data", "model"))
    want = _jax_sharded_names(params, mesh)
    specs = tfn.param_shardings(tfn.create_model(width=12),
                                _MeshShape(data=2, model=n))
    got = sorted(k for k, s in specs.items() if any(p.is_shard() for p in s))
    assert got == want
    assert all(len(s) == 2 and not s[0].is_shard() for s in specs.values())
