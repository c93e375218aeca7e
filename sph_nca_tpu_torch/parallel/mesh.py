"""The (data, particle) mesh and the placement of the sharded paths' inputs.

Counterpart of ``sph_nca_tpu/parallel/mesh.py``:

  * axis "data"     — pool-batch data parallelism (B independent rollouts;
                      the gradients are summed across the mesh);
  * axis "particle" — particle-axis sharding: the cell- or curve-sorted
                      particle buffer is split into contiguous ranges, and
                      the SPH passes read across range ends through the
                      exchanges of ``cell_shard`` / ``band_shard``.

The JAX package places globally sharded arrays and lets GSPMD insert the
collectives. The port runs one process per mesh position
(``comm.run_ranks``), so a mesh is a ``torch.distributed.device_mesh.
DeviceMesh`` over the world's ranks (rank = data index * particle +
particle index), and each placement helper returns what THIS rank holds:
its slice of a sharded array, or rank 0's copy of a replicated one. The
spec functions give the same layouts as DTensor placements, one per mesh
axis.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor.placement_types import Replicate, Shard

from . import comm

DATA_AXIS = "data"
PARTICLE_AXIS = "particle"


def factorize(n: int, prefer_data: int = 0) -> Tuple[int, int]:
    """Split n ranks into (data, particle), as square as possible, biased
    toward the data axis (pure data parallelism exchanges no halo)."""
    if prefer_data:
        if n % prefer_data:
            raise ValueError(f"{prefer_data} does not divide {n} ranks")
        return prefer_data, n // prefer_data
    d = int(np.sqrt(n))
    while n % d:
        d -= 1
    return max(d, 1), n // max(d, 1)


def make_mesh(*, data: Optional[int] = None, particle: Optional[int] = None,
              backend: Optional[str] = None) -> DeviceMesh:
    """A (data, particle) mesh over every rank of the initialized world
    (``comm.run_ranks`` initializes it). ``backend``, if given, must be the
    world's: NCCL meshes are CUDA meshes, gloo meshes move host memory (and
    stage CUDA tensors, ``comm``); nothing picks another one."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized process group "
                           "(run the ranks with parallel.comm.run_ranks)")
    world = dist.get_backend()
    if backend is not None and backend != world:
        raise ValueError(f"backend {backend!r} asked for, the world runs "
                         f"{world!r}")
    n = dist.get_world_size()
    if data is None and particle is None:
        data, particle = factorize(n)
    elif data is None:
        data = n // particle
    elif particle is None:
        particle = n // data
    if data * particle != n:
        raise ValueError(f"{data} x {particle} != {n} ranks")
    return init_device_mesh("cuda" if world == "nccl" else "cpu",
                            (data, particle),
                            mesh_dim_names=(DATA_AXIS, PARTICLE_AXIS))


def particle_group(mesh: DeviceMesh):
    return mesh.get_group(PARTICLE_AXIS)


def coords(mesh: DeviceMesh) -> Tuple[int, int]:
    """This rank's (data index, particle index)."""
    return mesh.get_local_rank(DATA_AXIS), mesh.get_local_rank(PARTICLE_AXIS)


# -- sharding specs (DTensor placements, one per mesh axis) -----------------


def batch_state_spec():
    """[B, N, C] pool states: batch over data, particles over particle."""
    return (Shard(0), Shard(1))


def graph_spec():
    """[N, ...] per-particle graph arrays: particles over particle,
    replicated across data."""
    return (Replicate(), Shard(0))


def replicated_spec():
    return (Replicate(), Replicate())


# -- placement: this rank's part ----------------------------------------------


def _chunk(x: torch.Tensor, parts: int, index: int, dim: int,
           what: str) -> torch.Tensor:
    if x.shape[dim] % parts:
        raise ValueError(f"{what}: dim {dim} of size {x.shape[dim]} does not "
                         f"divide the {parts}-way mesh axis")
    size = x.shape[dim] // parts
    return x.narrow(dim, index * size, size)


def particle_slice(x: torch.Tensor, mesh: DeviceMesh,
                   dim: int = 0) -> torch.Tensor:
    """This rank's contiguous range of ``dim`` over the particle axis."""
    k = mesh.size(mesh.mesh_dim_names.index(PARTICLE_AXIS))
    return _chunk(x, k, coords(mesh)[1], dim, "particle_slice")


def particle_gather(x: torch.Tensor, mesh: DeviceMesh,
                    dim: int = 0) -> torch.Tensor:
    """Inverse of ``particle_slice`` on every rank (no gradient)."""
    return comm.gather_raw(x.contiguous(), particle_group(mesh), dim)


def shard_batch(A: torch.Tensor, mesh: DeviceMesh) -> torch.Tensor:
    """This rank's block of a [B, N, C] batch (``batch_state_spec``)."""
    d, p = coords(mesh)
    nd = mesh.size(mesh.mesh_dim_names.index(DATA_AXIS))
    np_ = mesh.size(mesh.mesh_dim_names.index(PARTICLE_AXIS))
    A = _chunk(A, nd, d, 0, "shard_batch")
    return _chunk(A, np_, p, 1, "shard_batch").contiguous()


def shard_graph(graph, mesh: DeviceMesh):
    """This rank's rows of an ``SPHGraph`` (``graph_spec``): every field's
    particle axis over the particle axis. The neighbour indices stay global
    (they index the gathered state)."""
    return type(graph)(*(particle_slice(t, mesh).contiguous()
                         for t in graph))


def replicate(tensors, mesh: DeviceMesh):
    """Rank 0's copy of each tensor of a tuple (``MLPParams``) on every rank
    of the mesh: one broadcast over the world a tensor. Returns new tensors
    in a tuple of the same type. (An optimizer's state is built on each rank
    from the replicated parameters.)"""
    return type(tensors)(*(comm.broadcast_(t.detach().clone(), None)
                           for t in tensors))


def shard_cell_engine(eng, mesh: DeviceMesh):
    """This rank's shard of a ``CellEngine`` built with ``n_shards`` equal to
    the particle axis: its cells and its blocks of both window-size buckets
    (``parallel.cell_shard.CellShard``). The pair tables of the other ranks'
    blocks are not kept."""
    from .cell_shard import CellShard

    return CellShard.of(eng, mesh)
