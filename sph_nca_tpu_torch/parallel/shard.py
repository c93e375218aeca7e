"""Sharded training step on the graph engine: data parallelism over the pool
batch x particle-axis sharding of the graph's rows.

Counterpart of ``sph_nca_tpu/parallel/shard.py``. The JAX package jits one
function with GSPMD shardings (params and optimizer state replicated, the
batch [B, N, C] over (data, particle), the graph's rows over particle) and
lets XLA insert the collectives. Here each rank holds:

  params, optimizer state   a replica (``mesh.replicate``);
  A0                        its block of the batch (``mesh.shard_batch``);
  SPHGraph                  its rows (``mesh.shard_graph``); the neighbour
                            indices stay global.

One step: a K-step rollout in which every NCA step gathers the state (and,
for the post-update mask, the alive lanes) over the particle group and
computes this rank's rows (``models.rollout.rollout(..., exchange=...)``);
the loss as this rank's piece of the batch objective; the backward (the
gather's backward sends each rank's cotangents back to the rows' owners);
the gradients summed over the whole mesh (one all-reduce); the gradient
normalization and the optimizer's update, identical on every rank, so the
replicas stay bit-equal. The pieces sum to the single-process objective,
so the step computes what ``training.trainer``'s update does on the whole
batch, up to the order of float sums.

The fire draws of a step come from ``comm.rank_generator(seed, step,
rank)`` on the global rank, so every rank (data and particle coordinates
alike) draws its own block of the batch independently: the same law as the
single-process step, other streams, so the two agree at ``fire_rate=1``.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch
import torch.distributed as dist

from ..models.nca import MLPParams, SPHNCAConfig
from ..models.rollout import rollout_batch
from ..training.losses import overflow_penalty, rgba_with_margin, target_at
from ..training.trainer import normalize_grads_
from . import comm
from .mesh import DATA_AXIS, PARTICLE_AXIS, coords, particle_group


class ShardedTrainStep(NamedTuple):
    """fn(params, graph, A0, seed, step, n_steps, collect_steps) -> (loss,
    final): params and the optimizer's state are updated in place, ``loss``
    is the whole batch's objective (a float, equal on every rank), ``final``
    this rank's block of the rolled-out batch."""

    fn: Callable
    mesh: object  # DeviceMesh


def mse_loss_piece(img: torch.Tensor, mse_cfg, x: torch.Tensor, batch: int,
                   n: int) -> Callable:
    """This rank's piece of ``training.trainer.make_mse_bundle``'s objective
    (the mean over samples of the MSE, plus the overflow summed over
    samples) for its positions x [n_loc, 2], of a batch of ``batch`` samples
    of ``n`` particles: A [b_loc, n_loc, C] -> scalar. The pieces of all
    ranks sum to the objective."""
    tgt = target_at(x, img, mse_cfg)

    def piece(A: torch.Tensor) -> torch.Tensor:
        rgba = rgba_with_margin(A, mse_cfg.use_alpha, margin=None)
        se = torch.sum((rgba - tgt) ** 2) / (batch * n * rgba.shape[-1])
        return se + mse_cfg.overflow_weight * torch.sum(overflow_penalty(A))

    return piece


def make_sharded_train_step(
    model_cfg: SPHNCAConfig,
    optimizer: torch.optim.Optimizer,
    batch_total_loss: Callable[[torch.Tensor], torch.Tensor],
    h: float,
    mesh,
    max_steps: int,
    *,
    scheduler=None,
    aux_states: int = 4,
    aux_weight: float = 0.1,
    normalize_grads: bool = True,
) -> ShardedTrainStep:
    """The sharded step (the module docstring) for ``optimizer`` over this
    rank's replica of the parameters, with its learning-rate ``scheduler``
    if any (``training.trainer.make_optimizer``).

    ``batch_total_loss(A)`` maps this rank's block [b_loc, n_loc, C] to its
    piece of the batch objective (``mse_loss_piece``); the objective is the
    piece of the final state plus ``aux_weight`` times those of the states
    at ``collect_steps`` (``aux_states`` of them), as the trainer's."""
    group = particle_group(mesh)

    def exchange(X: torch.Tensor) -> torch.Tensor:
        return comm.all_gather(X, group, dim=0)

    def fn(params: MLPParams, graph, A0: torch.Tensor, seed: int, step: int,
           n_steps: int, collect_steps):
        gen = comm.rank_generator(seed, step, dist.get_rank(), A0.device)
        out = rollout_batch(params, model_cfg, graph, A0, gen, max_steps, h,
                            n_steps=n_steps, collect_steps=collect_steps,
                            exchange=exchange)
        total = batch_total_loss(out.final)
        for s in range(aux_states):
            total = total + aux_weight * batch_total_loss(
                out.collected[:, s])
        optimizer.zero_grad(set_to_none=True)
        total.backward()
        grads = [p.grad for p in params]
        flat = comm.all_reduce_(torch.cat([g.reshape(-1) for g in grads]))
        for g, part in zip(grads, flat.split([g.numel() for g in grads])):
            g.copy_(part.view_as(g))
        if normalize_grads:
            normalize_grads_(params)
        optimizer.step()
        if scheduler is not None:
            scheduler.step()
        loss = comm.all_reduce_(total.detach().reshape(1).clone())
        return float(loss), out.final.detach()

    return ShardedTrainStep(fn=fn, mesh=mesh)


# ---------------------------------------------------------------------------
# Dry run of one sharded step on tiny shapes
# ---------------------------------------------------------------------------


def dryrun_train_step(mesh, *, n_side: int = 16, h: float = 0.25,
                      batch: int = 0, steps: int = 4,
                      device="cpu") -> float:
    """Run ONE sharded training step on this rank (the JAX package's
    ``dryrun_train_step``): a 16 x 16 plane, 8 channels, 32 hidden units,
    Adam 3e-3, a ``steps``-step rollout of ``batch`` samples (default: 2 a
    data rank). Returns the (finite) loss of the whole batch."""
    from ..models.nca import init_params
    from ..ops.hashgrid import build_graph, default_dims, suggest_capacity
    from ..training.losses import MSELossConfig
    from ..training.trainer import make_optimizer
    from ..utils.geometry import grange
    from ..utils.seeds import plane_seed
    from .mesh import replicate, shard_batch, shard_graph

    dev = torch.device(device)
    nd = mesh.size(mesh.mesh_dim_names.index(DATA_AXIS))
    if batch == 0:
        batch = nd * 2
    x = grange((n_side, n_side), (-1.0, -1.0), (2.0, 2.0)).reshape(-1, 2)
    dims = default_dims(h)
    mpc, k = suggest_capacity(x, h, dims)
    graph = build_graph(x.to(dev), h, dims, max_per_cell=mpc, k=k)

    cfg = SPHNCAConfig(channels=8, hidden=32, normalize_perception=1.0 / h)
    img = torch.tensor([1.0, 0.5, 0.0, 1.0]).repeat(8, 8, 1).to(dev)
    loss_cfg = MSELossConfig(gmin=(-1, -1), gsize=(2, 2), image_scale=1.0)
    params = init_params(cfg, torch.Generator().manual_seed(0), device=dev)
    params = MLPParams(*(p.requires_grad_(True)
                         for p in replicate(params, mesh)))
    opt, sched = make_optimizer(list(params), 3e-3)
    A_seed = plane_seed(x, cfg.channels, gmin=(-1, -1), gsize=(2, 2),
                        radius=h).to(dev)
    A0 = shard_batch(A_seed.expand((batch,) + A_seed.shape), mesh)
    np_ = mesh.size(mesh.mesh_dim_names.index(PARTICLE_AXIS))
    p_idx = coords(mesh)[1]
    n_loc = x.shape[0] // np_
    piece = mse_loss_piece(img, loss_cfg,
                           x[p_idx * n_loc:(p_idx + 1) * n_loc].to(dev),
                           batch, x.shape[0])
    step = make_sharded_train_step(cfg, opt, piece, h, mesh, steps,
                                   scheduler=sched)
    loss, _ = step.fn(params, shard_graph(graph, mesh), A0, 1, 0, steps,
                      [0, 1, steps - 1, steps])
    if not torch.isfinite(torch.tensor(loss)):
        raise RuntimeError(f"dryrun loss not finite: {loss}")
    return loss
