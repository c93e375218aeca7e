"""Rollouts on the fixed-K graph engine.

Counterpart of ``sph_nca_tpu/models/rollout.py``: ``rollout`` (up to
``max_steps`` steps, ``n_steps`` masking, states collected at
``collect_steps``, each step recomputed in the backward), ``rollout_states``
(the whole trajectory), ``rollout_batch`` (B rollouts on one graph) and
``rollout_rebuild`` (the neighbour lists rebuilt every step, for moving
particles). The JAX package scans the steps in one compiled program; the
port loops in Python, one ``nca_step`` a step.

Every rollout takes one cloud [N, C]; ``rollout`` and ``rollout_batch`` also a
batch [B, N, C] on one graph, stepped as lanes. The fire draws come from a
``torch.Generator``, one [..., N] draw a step, made outside the recomputed
function (``torch.utils.checkpoint`` restores the default generators only),
so the recompute sees the same mask.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import torch
from torch.utils.checkpoint import checkpoint

from ..ops.hashgrid import (
    SPHGraph,
    build_neighbor_list,
    graph_from_neighbor_list,
)
from .nca import (
    MLPParams,
    PerceptionTransform,
    SPHNCAConfig,
    _graph_step,
    nca_step,
)


class RolloutOut(NamedTuple):
    final: torch.Tensor  # [..., N, C] state after n_steps
    collected: Optional[torch.Tensor]  # [S, ..., N, C] at collect_steps


def rollout(
    params: MLPParams,
    cfg: SPHNCAConfig,
    graph: SPHGraph,
    A0: torch.Tensor,
    generator: torch.Generator,
    max_steps: int,
    h,
    *,
    n_steps: Optional[int] = None,
    fire_rate: Optional[float] = None,
    perception_transform: Optional[PerceptionTransform] = None,
    collect_steps: Optional[Sequence[int]] = None,
    remat: bool = True,
    exchange=None,
) -> RolloutOut:
    """Up to ``max_steps`` steps from A0 [N, C] or [B, N, C].

    Steps from ``n_steps`` on are no-ops (the state holds, and no fire draw
    is made). ``collect_steps``: state indices in [0, max_steps] (0 = A0,
    k = the state after k steps) to keep, returned as ``collected``
    [S, ..., N, C]. With ``remat`` each step is recomputed in the backward
    when a gradient is needed. ``exchange`` as in ``models.nca._graph_step``
    (a rank's rows of a sharded graph).
    """
    if fire_rate is None:
        fire_rate = cfg.fire_rate
    collect = [] if collect_steps is None else [int(k) for k in collect_steps]
    if any(not 0 <= k <= max_steps for k in collect):
        raise ValueError(f"collect_steps {collect} outside [0, {max_steps}]")
    end = max_steps if n_steps is None else min(int(n_steps), max_steps)
    remat = remat and torch.is_grad_enabled() and (
        A0.requires_grad or any(p.requires_grad for p in params))

    def step(A, u):
        return _graph_step(params, cfg, graph, A, u, h, fire_rate,
                           perception_transform, exchange)

    A = A0
    buf = [A0] * len(collect)
    for t in range(max_steps):
        if t < end:
            u = torch.rand(A.shape[:-1], generator=generator,
                           device=A.device)
            if remat:
                A = checkpoint(step, A, u, use_reentrant=False,
                               preserve_rng_state=False)
            else:
                A = step(A, u)
        for i, k in enumerate(collect):
            if k == t + 1:
                buf[i] = A
    collected = None
    if collect_steps is not None:
        collected = (torch.stack(buf) if buf
                     else A0.new_empty((0,) + tuple(A0.shape)))
    return RolloutOut(final=A, collected=collected)


def rollout_states(
    params: MLPParams,
    cfg: SPHNCAConfig,
    graph: SPHGraph,
    A0: torch.Tensor,
    generator: torch.Generator,
    n_steps: int,
    h,
    *,
    fire_rate: Optional[float] = None,
    perception_transform: Optional[PerceptionTransform] = None,
) -> torch.Tensor:
    """The whole trajectory [n_steps+1, N, C], A0 included."""
    states = [A0]
    for _ in range(n_steps):
        states.append(nca_step(params, cfg, graph, states[-1], generator, h,
                               fire_rate=fire_rate,
                               perception_transform=perception_transform))
    return torch.stack(states)


def rollout_batch(
    params: MLPParams,
    cfg: SPHNCAConfig,
    graph: SPHGraph,
    A0: torch.Tensor,
    generator: torch.Generator,
    max_steps: int,
    h,
    **kwargs,
) -> RolloutOut:
    """``rollout`` of a batch A0 [B, N, C] sharing one graph, in the JAX
    package's layout: final [B, N, C], collected [B, S, N, C]."""
    out = rollout(params, cfg, graph, A0, generator, max_steps, h, **kwargs)
    collected = out.collected
    if collected is not None:
        collected = collected.transpose(0, 1)
    return RolloutOut(final=out.final, collected=collected)


def rollout_rebuild(
    params: MLPParams,
    cfg: SPHNCAConfig,
    x0: torch.Tensor,
    A0: torch.Tensor,
    generator: torch.Generator,
    n_steps: int,
    h,
    dims,
    *,
    max_per_cell: int,
    k: int,
    advect=None,
    period=None,
    fire_rate: Optional[float] = None,
):
    """A rollout of one cloud whose neighbour lists are rebuilt every step,
    for particles that move (``advect(x, A, t) -> new x`` before each step).
    The lists keep the given capacities (no retry, as inside the JAX scan);
    their drop counts stay on the device.

    Returns (x_final [N, D], A_final [N, C], states [n_steps+1, N, C],
    num_dropped [n_steps] int32): the JAX package's three results and each
    step's ``num_dropped`` (0 everywhere: every list was exact).
    """
    x, A = x0, A0
    states, dropped = [A0], []
    for t in range(n_steps):
        if advect is not None:
            x = advect(x, A, t)
        nl = build_neighbor_list(x, h, dims, max_per_cell=max_per_cell, k=k,
                                 period=period)
        graph = graph_from_neighbor_list(x, h, nl, period=period)
        A = nca_step(params, cfg, graph, A, generator, h,
                     fire_rate=fire_rate)
        states.append(A)
        dropped.append(nl.num_dropped)
    num_dropped = (torch.stack(dropped) if dropped
                   else torch.zeros(0, dtype=torch.int32, device=A0.device))
    return x, A, torch.stack(states), num_dropped
