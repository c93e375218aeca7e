"""NCA step and rollouts over the cell-dense engine (single device).

Counterpart of ``sph_nca_tpu/models/cell_step.py`` (``use_pallas=True``, no
mesh, one shard, no perception transform). Perception and both life masks go
through the pair-pass kernels of ``ops/pair_kernel.py``; the update MLP is
plain PyTorch. Inference only: everything runs under ``torch.no_grad()``.

The fire-rate mask is drawn per SLOT from a ``torch.Generator``: the same
Bernoulli(fire_rate) law as the JAX package, another stream, so trajectories
match the JAX package exactly only at fire_rate == 1.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..ops.cells import CellEngine
from ..ops.pair_kernel import mask_blur, perceive_cells_dmajor
from .nca import ALIVE_THRESHOLD, MLPParams, SPHNCAConfig, apply_mlp


def cell_activity_s(S: torch.Tensor, use_alpha: bool) -> torch.Tensor:
    """Activity per slot [C, M]."""
    if use_alpha:
        return S[..., 3]
    return torch.ones_like(S[..., 3])


@torch.no_grad()
def nca_step_cells(
    params: MLPParams,
    cfg: SPHNCAConfig,
    eng: CellEngine,
    S: torch.Tensor,
    generator: torch.Generator,
    h: float,
    fire_rate: Optional[float] = None,
    use_kernels: bool = True,
) -> torch.Tensor:
    """One NCA step in cell layout: S [C, M, F] -> [C, M, F].

    ``use_kernels=False`` runs the kernels' plain versions on any device.
    """
    if fire_rate is None:
        fire_rate = cfg.fire_rate
    c = cfg.channels
    f = S.shape[-1]

    # the kernel's d-major [C, M, D*F] layout is the feature concat order
    # (gA_x block, then gA_y; a z block in 3D is dropped)
    gA_dm, pre_sm = perceive_cells_dmajor(eng, S, cfg.use_alpha,
                                          use_kernels=use_kernels)
    prev_mask = pre_sm > ALIVE_THRESHOLD
    if cfg.normalize_perception > 0:
        gA_dm = h * gA_dm * cfg.normalize_perception
    y = torch.cat([S, gA_dm[..., : 2 * f]], dim=-1)
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

    u = torch.rand(S.shape[:2], generator=generator, device=S.device)
    nS = torch.where((u <= fire_rate)[..., None], nS, S)

    new_sm = mask_blur(eng, nS, use_alpha=cfg.use_alpha,
                       use_kernels=use_kernels)
    living = (prev_mask & (new_sm > ALIVE_THRESHOLD)).to(nS.dtype)
    return nS * living[..., None]


@torch.no_grad()
def rollout_cells(
    params: MLPParams,
    cfg: SPHNCAConfig,
    eng: CellEngine,
    S0: torch.Tensor,
    generator: torch.Generator,
    max_steps: int,
    h: float,
    *,
    fire_rate: Optional[float] = None,
    use_kernels: bool = True,
) -> torch.Tensor:
    """``max_steps`` steps in cell layout; returns the final state."""
    S = S0
    for _ in range(max_steps):
        S = nca_step_cells(params, cfg, eng, S, generator, h,
                           fire_rate=fire_rate, use_kernels=use_kernels)
    return S


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
