"""Generation over a ``torch.distributed`` mesh (``flowgen_torch/pipeline/
sharding.py``) against the port's single-process batch, bit for bit, and
against the JAX package's sharded batch under the on-device gates.

Two ``gloo`` ranks on a ``"cpu"`` mesh run in spawned processes (a
``file://`` store under the test's temporary directory, so parallel test
workers never share a port); they save what they generated and the tests
compare it here."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp
from jax.sharding import Mesh

import flowgen
import flowgen_torch
from flowgen.pipeline import sharding as jsharding
from flowgen.random.streams import root_key as jroot_key
from flowgen_torch.pipeline import sharding
from flowgen_torch.pipeline.generator import Generator, make_generate_fn

torch.set_num_threads(1)

W, H = 128, 96
WORLD = 2
ATLAS = flowgen_torch.procedural_atlas(4, height=H, width=W)

# (name, DataGenConfig keywords, steps): the global batch is 4 but for the
# windowed case, 8 (so that the JAX package's 8-device mesh can take it).
CASES = [
    ("fused", dict(mode=7), (0, 1)),
    ("windowed", dict(mode=7, render_impl="windowed", batch_size=8), (0,)),
    ("mode9", dict(mode=9), (0, 1, 2)),
    ("photometric", dict(mode=7, photometric_augment=True), (0,)),
]


def _cfg(**kw):
    return flowgen_torch.DataGenConfig(
        **{"batch_size": 4, "width": W, "height": H, "seed": 3, **kw})


def _names(placements):
    """Placements as ("Shard", dim) or ("Replicate",), whatever torch's
    version prints."""
    return [("Shard", p.dim) if p.is_shard() else ("Replicate",)
            for p in placements]


def _generate_worker(rank, store, out_dir):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=WORLD)
    try:
        mesh = init_device_mesh("cpu", (WORLD,), mesh_dim_names=("data",))
        res = {}
        for name, kw, steps in CASES:
            fn = sharding.make_sharded_generate_fn(_cfg(**kw), mesh)
            for step in steps:
                out = fn(3, step, ATLAS)
                res[name, step] = {
                    k: (v.to_local().clone(), v.full_tensor(),
                        _names(v.placements))
                    for k, v in out.items()}
        # A (data, model) = (2, 1) mesh: Shard(0) on data, Replicate on model.
        mesh2 = init_device_mesh("cpu", (WORLD, 1),
                                 mesh_dim_names=("data", "model"))
        out = sharding.make_sharded_generate_fn(_cfg(mode=7), mesh2)(
            3, 0, ATLAS)
        res["2d"] = {k: (v.to_local().clone(), _names(v.placements))
                     for k, v in out.items()}
        # Generator over the mesh, numpy output: the global batch.
        gen = Generator(_cfg(mode=7), atlas=ATLAS, as_numpy=True, mesh=mesh)
        res["generator"] = [gen.retrieve_batch() for _ in range(2)]
        res["meter"] = gen.meter.total_samples
        gen.stop()
        # The atlas from two halves, each process decoding its own.
        half = ATLAS.shape[0] // WORLD
        blk = ATLAS[rank * half:(rank + 1) * half]
        dat = sharding.distribute_atlas(mesh, blk)
        res["atlas"] = (dat.to_local().clone(), _names(dat.placements))
        fn = sharding.make_sharded_generate_fn(_cfg(mode=7), mesh)
        res["from_distributed_atlas"] = fn(3, 0, dat)["image0"].to_local()
        res["paths"] = sharding.texture_paths_for_process(
            [f"t{i}.png" for i in range(5)])
        try:
            sharding.make_sharded_generate_fn(_cfg(mode=7, batch_size=3), mesh)
        except ValueError as e:
            res["error"] = str(e)
        torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """What each of the two ranks generated: a list of two dicts."""
    d = tmp_path_factory.mktemp("sharding")
    mp.spawn(_generate_worker, args=(str(d / "store"), str(d)), nprocs=WORLD,
             join=True)
    return [torch.load(d / f"rank{r}.pt", weights_only=False)
            for r in range(WORLD)]


@pytest.fixture(scope="module")
def single():
    """The port's single-process batches of every case."""
    out = {}
    for name, kw, steps in CASES:
        fn = make_generate_fn(_cfg(**kw), "cpu")
        for step in steps:
            out[name, step] = fn(3, step, ATLAS)
    return out


def _bits_equal(a, b):
    a, b = torch.as_tensor(a), torch.as_tensor(b)
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return a.shape == b.shape and torch.equal(a, b)


@pytest.mark.parametrize("name,step", [(n, s) for n, _, steps in CASES
                                       for s in steps])
def test_sharded_batch_equals_single_process(ranks, single, name, step):
    """Each rank's shard is its rows of the single-process batch, and the
    gathered batch is the whole of it, bit for bit: fused and windowed
    renderers, mode 9 over steps 0-2 (steps 0-1 share a bank epoch, step 2
    starts the next) and photometric augmentation."""
    want = single[name, step]
    b = next(iter(want.values())).shape[0] // WORLD
    for r, got in enumerate(ranks):
        got = got[name, step]
        assert set(got) == set(want)
        for k, v in want.items():
            local, full, _ = got[k]
            assert _bits_equal(local, v[r * b:(r + 1) * b]), (r, k)
            assert _bits_equal(full, v), (r, k)


def test_placements_on_one_and_two_dimensional_meshes(ranks):
    """Shard(0) on the data dimension, Replicate on any other."""
    for got in ranks:
        for local, _, placements in got["fused", 0].values():
            assert placements == [("Shard", 0)] and local.shape[0] == 2
        for local, placements in got["2d"].values():
            assert placements == [("Shard", 0), ("Replicate",)]
    single = make_generate_fn(_cfg(mode=7), "cpu")(3, 0, ATLAS)
    for r, got in enumerate(ranks):
        for k, (local, _) in got["2d"].items():
            assert _bits_equal(local, single[k][2 * r:2 * r + 2])


def test_generator_on_a_mesh_returns_the_global_batch(ranks):
    """``Generator(mesh=...)`` with ``as_numpy`` gives every rank the global
    batch, and its meter counts the global batch size."""
    fn = make_generate_fn(_cfg(mode=7), "cpu")
    for got in ranks:
        for step, batch in enumerate(got["generator"]):
            want = fn(3, step, ATLAS)
            for k, v in want.items():
                np.testing.assert_array_equal(batch[k], v.numpy())
        assert got["meter"] == 8


def test_distribute_atlas_equals_the_concatenated_atlas(ranks):
    single = make_generate_fn(_cfg(mode=7), "cpu")(3, 0, ATLAS)["image0"]
    for r, got in enumerate(ranks):
        atlas, placements = got["atlas"]
        assert placements == [("Replicate",)]
        np.testing.assert_array_equal(atlas.numpy(), ATLAS)
        assert _bits_equal(got["from_distributed_atlas"],
                           single[2 * r:2 * r + 2])


def test_texture_paths_default_to_the_process_group(ranks):
    paths = [f"t{i}.png" for i in range(5)]
    for r, got in enumerate(ranks):
        assert got["paths"] == jsharding.texture_paths_for_process(
            paths, r, WORLD)


@pytest.mark.parametrize("n_paths,n_proc", [(10, 4), (5, 2), (3, 3), (1, 4),
                                            (7, 1), (9, 8)])
def test_texture_paths_match_jax(n_paths, n_proc):
    paths = [f"t{i}.png" for i in range(n_paths)]
    for p in range(n_proc):
        assert (sharding.texture_paths_for_process(paths, p, n_proc)
                == jsharding.texture_paths_for_process(paths, p, n_proc))
    assert (sharding.texture_paths_for_process(paths)
            == jsharding.texture_paths_for_process(paths))


def test_indivisible_batch_error_matches_jax(ranks):
    mesh = Mesh(np.array(jax.devices()[:WORLD]), ("data",))
    cfg = flowgen.DataGenConfig(mode=7, batch_size=3, width=W, height=H)
    with pytest.raises(ValueError) as e:
        jsharding.make_sharded_generate_fn(cfg, mesh)
    for got in ranks:
        assert got["error"] == str(e.value)


def test_sharded_batch_passes_the_gates_against_jax_sharded(ranks):
    """The port's 2-rank windowed batch (B=8) against the JAX package's
    ``make_sharded_generate_fn`` on its 8 virtual CPU devices, the same
    renderer (the windowed one: a Pallas interpret render on 8 devices
    would cost minutes; this one takes about 8 s on a loaded 8-core CPU),
    under the gates of ``tools/check_pallas_tpu.py``."""
    cfg = flowgen.DataGenConfig(mode=7, batch_size=8, width=W, height=H,
                                seed=3, render_impl="windowed")
    mesh = Mesh(np.array(jax.devices()[:8]), ("data",))
    fn = jsharding.make_sharded_generate_fn(cfg, mesh)
    want = {k: np.asarray(v) for k, v in fn(
        jroot_key(3), jnp.int32(0), jnp.asarray(ATLAS, jnp.float32)).items()}
    got = {k: full.numpy() for k, (_, full, _) in ranks[0]["windowed", 0].items()}
    assert set(got) == set(want)
    for k in ("image0", "image1"):
        d = np.abs(got[k] - want[k])
        assert (d >= 1).mean() < 0.01 and (d >= 2).mean() < 1e-4, k
    d = np.abs(got["flow0"] - want["flow0"])
    assert np.median(d) < 1e-4 and (d > 0.01).mean() < 1e-3
