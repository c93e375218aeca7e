"""NCA step and rollouts over the cell-dense engine (single device).

Counterpart of ``sph_nca_tpu/models/cell_step.py`` (``use_pallas=True``, no
mesh, one shard). Perception and both life masks go through the pair-pass
kernels of ``ops/pair_kernel.py`` (the table kernels when the engine has pair
tables); the update MLP is plain PyTorch. ``nca_step_cells`` takes a
``perception_transform`` (the surface rollout's tangent projection), which
reads the gradient in the [..., C, M, F, D] layout, as the JAX step's
non-d-major branch does. The step and ``rollout_cells`` are differentiable in
the parameters and the state (perception's backward is the gradient-adjoint
kernel); ``rollout_states_cells`` is inference only.

States carry an optional leading batch axis: S [B, C, M, F] runs B samples on
one geometry, each kernel launching once per bucket for the whole batch (the
JAX trainer vmaps the per-sample rollout instead).

The fire-rate mask is drawn per SLOT from a ``torch.Generator``: the same
Bernoulli(fire_rate) law as the JAX package, another stream, so trajectories
match the JAX package exactly only at fire_rate == 1.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch.utils.checkpoint import checkpoint

from ..ops.cells import CellEngine
from ..ops.pair_kernel import mask_blur, perceive_cells, perceive_cells_dmajor
from .nca import ALIVE_THRESHOLD, MLPParams, SPHNCAConfig, apply_mlp

# Recompute each step in the backward instead of keeping its activations
# (torch.utils.checkpoint, as the JAX rollout's jax.checkpoint). At the train
# CLI's defaults on an H100 (chip_smoke.py's train-depth phase) keeping them
# costs 10.2 GiB instead of 1.24 GiB for a 45-step batch of 8 and saves ~28%
# of a BPTT step; the saved activations grow with image size and depth, so
# the rollout recomputes, as the JAX package does.
REMAT = True


def cell_activity_s(S: torch.Tensor, use_alpha: bool) -> torch.Tensor:
    """Activity per slot [C, M]."""
    if use_alpha:
        return S[..., 3]
    return torch.ones_like(S[..., 3])


def _step(params: MLPParams, cfg: SPHNCAConfig, eng: CellEngine,
          S: torch.Tensor, u: torch.Tensor, h: float, fire_rate: float,
          use_kernels: bool, perception_transform=None) -> torch.Tensor:
    """One step given the fire draws u [..., C, M] (uniform in [0, 1))."""
    c = cfg.channels
    f = S.shape[-1]

    if perception_transform is None:
        # the kernel's d-major [..., C, M, D*F] layout is the feature concat
        # order (gA_x block, then gA_y; a z block in 3D is dropped)
        gA_dm, pre_sm = perceive_cells_dmajor(eng, S, cfg.use_alpha,
                                              use_kernels=use_kernels)
        if cfg.normalize_perception > 0:
            gA_dm = h * gA_dm * cfg.normalize_perception
        y = torch.cat([S, gA_dm[..., : 2 * f]], dim=-1)
    else:
        gA, pre_sm = perceive_cells(eng, S, cfg.use_alpha,
                                    use_kernels=use_kernels)
        if cfg.normalize_perception > 0:
            gA = h * gA * cfg.normalize_perception
        gA = perception_transform(gA)
        y = torch.cat([S, gA[..., 0], gA[..., 1]], dim=-1)
    prev_mask = pre_sm > ALIVE_THRESHOLD
    dA = apply_mlp(params, y)

    if cfg.update_rule == "gated":
        gate = torch.sigmoid(dA[..., :c])
        delta = torch.tanh(dA[..., c : 2 * c])
        mult = torch.sigmoid(dA[..., -1:])
        nS = S * gate + delta * mult
    elif cfg.update_rule == "orig":
        nS = S + dA * (cfg.fire_rate / fire_rate)
    else:
        raise ValueError(f"unknown update rule {cfg.update_rule!r}")

    nS = torch.where((u <= fire_rate)[..., None], nS, S)

    # the life masks are stop-gradient (thresholded blurs)
    new_sm = mask_blur(eng, nS.detach(), use_alpha=cfg.use_alpha,
                       use_kernels=use_kernels)
    living = (prev_mask & (new_sm > ALIVE_THRESHOLD)).to(nS.dtype)
    return nS * living[..., None]


def nca_step_cells(
    params: MLPParams,
    cfg: SPHNCAConfig,
    eng: CellEngine,
    S: torch.Tensor,
    generator: torch.Generator,
    h: float,
    fire_rate: Optional[float] = None,
    use_kernels: bool = True,
    perception_transform=None,
) -> torch.Tensor:
    """One NCA step in cell layout: S [..., C, M, F] -> [..., C, M, F].

    ``use_kernels=False`` runs the kernels' plain versions on any device.
    ``perception_transform`` maps the scaled gradient gA [..., C, M, F, D]
    to the features [..., C, M, F, >= 2] whose first two components feed the
    MLP (the surface rollout's tangent projection).
    """
    if fire_rate is None:
        fire_rate = cfg.fire_rate
    u = torch.rand(S.shape[:-1], generator=generator, device=S.device)
    return _step(params, cfg, eng, S, u, h, fire_rate, use_kernels,
                 perception_transform)


def rollout_cells(
    params: MLPParams,
    cfg: SPHNCAConfig,
    eng: CellEngine,
    S0: torch.Tensor,
    generator: torch.Generator,
    n_steps: int,
    h: float,
    *,
    fire_rate: Optional[float] = None,
    collect_steps: Optional[Sequence[int]] = None,
    use_kernels: bool = True,
):
    """``n_steps`` steps in cell layout from S0 [..., C, M, F].

    Returns the final state or, with ``collect_steps``, (final, collected):
    collected [len(collect_steps), ..., C, M, F] holds the state after step
    k for each k in ``collect_steps`` (0 <= k <= n_steps; k = 0 is S0), as
    the JAX rollout's buffer. When a gradient is needed, each step is
    recomputed in the backward (see ``REMAT``); the fire draws are made
    outside the recomputed function, so the recompute sees the same mask.
    """
    if fire_rate is None:
        fire_rate = cfg.fire_rate
    collect = [] if collect_steps is None else [int(k) for k in collect_steps]
    if any(not 0 <= k <= n_steps for k in collect):
        raise ValueError(f"collect_steps {collect} outside [0, {n_steps}]")
    buf = [S0] * len(collect)
    remat = REMAT and torch.is_grad_enabled() and (
        S0.requires_grad or any(p.requires_grad for p in params))

    def step(S, u):
        return _step(params, cfg, eng, S, u, h, fire_rate, use_kernels)

    S = S0
    for t in range(n_steps):
        u = torch.rand(S.shape[:-1], generator=generator, device=S.device)
        if remat:
            S = checkpoint(step, S, u, use_reentrant=False,
                           preserve_rng_state=False)
        else:
            S = step(S, u)
        for i, k in enumerate(collect):
            if k == t + 1:
                buf[i] = S
    if collect_steps is None:
        return S
    return S, (torch.stack(buf) if buf else S0.new_empty((0,) + S0.shape))


@torch.no_grad()
def rollout_states_cells(
    params: MLPParams,
    cfg: SPHNCAConfig,
    eng: CellEngine,
    A0: torch.Tensor,
    generator: torch.Generator,
    n_steps: int,
    h: float,
    *,
    fire_rate: Optional[float] = None,
    use_kernels: bool = True,
) -> torch.Tensor:
    """Full trajectory in PARTICLE order [n_steps+1, N, F]: A0 [N, F] and
    the state after every step."""
    states = A0.new_empty((n_steps + 1,) + tuple(A0.shape))
    states[0] = A0
    S = eng.scatter(A0)
    for t in range(n_steps):
        S = nca_step_cells(params, cfg, eng, S, generator, h,
                           fire_rate=fire_rate, use_kernels=use_kernels)
        states[t + 1] = eng.gather_back(S)
    return states
