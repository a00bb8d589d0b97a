"""Generation over several devices (port of
``flowgen/pipeline/sharding.py``).

The batch is split over the ``data`` dimension of a
``torch.distributed.device_mesh.DeviceMesh``, one process a device: the
rank at coordinate ``di`` renders the global sample indices
``step*B + di*B_local + [0, B_local)``. Sample content is a pure function
of the global index (counter-based keys), so each rank's rows equal those
rows of the single-device batch bit for bit, for any device count, and the
hot path holds no collective. Outputs are ``DTensor``s placed ``Shard(0)``
on the data dimension and ``Replicate()`` on any other: ``to_local()`` is
the rank's sub-batch, ``full_tensor()`` the global batch.

The texture atlas is read-only and replicated: each process may decode its
slice of a texture list (:func:`texture_paths_for_process`) and one
all-gather at start-up assembles the whole atlas (:func:`distribute_atlas`).
In mode 9 every rank builds the bank epoch itself from the global
configuration: the bank is keyed by ``(root, epoch)`` only, so every rank
builds the same one with no collective, where the JAX package computes it
once and replicates it over its mesh.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, Shard

from ..config import DataGenConfig
from .generator import _generate_fn


def mesh_device(mesh) -> torch.device:
    """This rank's device in ``mesh``: the current CUDA device for a
    ``"cuda"`` mesh, the CPU for a ``"cpu"`` mesh."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def local_tensor(x):
    """The rank's local tensor of a DTensor; anything else as it is."""
    return x.to_local() if isinstance(x, DTensor) else x


def _replicated(mesh):
    return [Replicate()] * mesh.ndim


def make_sharded_generate_fn(cfg: DataGenConfig, mesh, axis: str = "data"):
    """``fn(root, step, atlas) -> batch`` whose values are DTensors sharded
    over ``axis`` of ``mesh`` (``Shard(0)``; ``Replicate()`` on the other
    mesh dimensions). ``cfg.batch_size`` must divide by the axis size.
    ``atlas`` is a plain atlas or TextureDB, or a replicated DTensor atlas
    (:func:`distribute_atlas`)."""
    n = mesh[axis].size()
    if cfg.batch_size % n != 0:
        raise ValueError(
            f"batch_size {cfg.batch_size} not divisible by mesh axis "
            f"'{axis}' of size {n}"
        )
    local = _generate_fn(cfg, mesh_device(mesh), mesh.get_local_rank(axis), n)
    placements = [Shard(0) if name == axis else Replicate()
                  for name in mesh.mesh_dim_names]

    def fn(root, step, atlas):
        out = local(root, step, local_tensor(atlas))
        return {k: DTensor.from_local(v, mesh, placements, run_check=False)
                for k, v in out.items()}

    return fn


def replicate(mesh, x):
    """``x`` (a tensor or array, the same on every rank) as a replicated
    DTensor on this rank's device; nothing is communicated."""
    t = torch.as_tensor(np.asarray(x)) if not torch.is_tensor(x) else x
    return DTensor.from_local(t.to(mesh_device(mesh)), mesh, _replicated(mesh),
                              run_check=False)


def _process_index_count():
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def texture_paths_for_process(paths, process_index=None, process_count=None):
    """Contiguous per-process slice of a texture DB path list for
    :func:`distribute_atlas`. The list is padded by cycling so every process
    decodes the same count (texture lookup is modulo the table size,
    DataGenerator.cpp:158-161, so the repeats only reweight those sources by
    one extra slot). The defaults are this process's rank and the world
    size, or 0 and 1 without a process group."""
    rank, world = _process_index_count()
    p = rank if process_index is None else process_index
    n = world if process_count is None else process_count
    paths = list(paths)
    per = -(-len(paths) // n)
    padded = paths + [paths[i % len(paths)] for i in range(per * n - len(paths))]
    return padded[p * per : (p + 1) * per]


def distribute_atlas(mesh, local_textures, axis: str = "data"):
    """The whole texture atlas from each process's decoded block, by ONE
    all-gather at start-up: ``local_textures`` is this process's ``(T_local,
    H, W, 3)`` block (every process passes the same shape), the result the
    ``(T_local * n_processes, H, W, 3)`` atlas in process-major order
    (process 0's block first) as a replicated DTensor on this rank's
    device. The gather spans every process of the default group, as the
    JAX package's global array spans every process; ``axis`` is accepted
    for its signature. Sampled ``tex_id % T`` content is a function of the
    process count, so choose the decode split once per deployment.
    Generation itself never communicates."""
    dev = mesh_device(mesh)
    block = local_textures
    if not torch.is_tensor(block):
        block = torch.as_tensor(np.ascontiguousarray(block))
    block = block.to(dev).contiguous()
    _, n = _process_index_count()
    out = torch.empty((block.shape[0] * n,) + tuple(block.shape[1:]),
                      dtype=block.dtype, device=dev)
    if n == 1:
        out.copy_(block)
    else:
        dist.all_gather_into_tensor(out, block)
    return DTensor.from_local(out, mesh, _replicated(mesh), run_check=False)
