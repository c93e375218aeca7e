"""3D-surface rollout on the cell engine: tangent frames, tangent diffusion
and tangent-space perception.

Counterpart of the cell-engine part of ``sph_nca_tpu/models/surface.py``
(``normalize``, ``orthogonalize``,
``project_tangent_space_cells``, ``diffuse_cells`` and ``rollout_mesh_cells``;
reference nca.py:302-381). Every pair pass runs through the table kernels of
``ops/pair_kernel.py``, so the engine must be built with ``pair_tables``; its
h serves both perception and diffusion (the reference diffuses at 0.1, every
shipped model's h; like the JAX package, the port does not enforce it).

The fire-rate mask is drawn per slot from a ``torch.Generator``: the law of
the JAX package, another stream, so trajectories match the JAX package only at
fire_rate == 1.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

from ..ops.cells import CellEngine
from ..ops.pair_kernel import blur_cells
from .cell_step import cell_activity_s, nca_step_cells
from .nca import MLPParams, SPHNCAConfig


def normalize(v: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """v / (eps + |v|) (reference nca.py:303-305): a zero vector stays 0."""
    return v / (eps + torch.linalg.vector_norm(v, dim=-1, keepdim=True))


def orthogonalize(n: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Gram-Schmidt t against n, renormalized (reference nca.py:307-310)."""
    nt = torch.sum(n * t, dim=-1, keepdim=True)
    return normalize(t - n * nt)


def project_tangent_space_cells(gA: torch.Tensor, n: torch.Tensor,
                                t: torch.Tensor) -> torch.Tensor:
    """gA [..., C, M, F, 3] in the frame (t, n x t, n) of each slot:
    [..., C, M, F, 3] (reference nca.py:325-330)."""
    b = torch.linalg.cross(n, t, dim=-1)
    tbn = torch.stack([t, b, n], dim=-1)  # [..., C, M, 3, 3]
    return torch.einsum("...fd,...dk->...fk", gA, tbn)


def diffuse_cells(eng: CellEngine, n: torch.Tensor, t: torch.Tensor,
                  S: torch.Tensor, *, lerp_multiplier: float = 1.0,
                  w_multiplier: float = 1.0,
                  use_kernels: bool = True) -> torch.Tensor:
    """Activity-weighted tangent diffusion in cell layout (reference
    nca.py:312-323): blur [m, m t] over the poly6 table, t2 = blurred m t /
    blurred m, lerp back toward t where the slot is active, re-orthogonalize
    against n. The weights are ALWAYS the alpha lane, whatever the model's
    ``use_alpha``, as the reference's diffuse() reads cell_activity at its
    default."""
    w = torch.clamp(cell_activity_s(S, True)[..., None], 0.0, 1.0)
    m = (1.0 - w_multiplier) + w * w_multiplier
    mt = torch.cat([m, m * t], dim=-1)  # [..., C, M, 4]
    mt2 = blur_cells(eng, mt, use_kernels=use_kernels)
    t2 = mt2[..., 1:] / (1e-8 + mt2[..., :1])
    t2 = t2 + (t - t2) * (w * lerp_multiplier)
    return orthogonalize(n, t2)


def rollout_mesh_cells(
    params: MLPParams,
    cfg: SPHNCAConfig,
    eng: CellEngine,
    A0: torch.Tensor,
    n: torch.Tensor,
    t0: torch.Tensor,
    generator: torch.Generator,
    n_steps: int,
    h: float,
    *,
    fire_rate: Optional[float] = None,
    lerp_multiplier: float = 1.0,
    w_multiplier: float = 1.0,
    collect_all: bool = False,
    use_kernels: bool = True,
):
    """Surface rollout on the cell engine (the JAX package's
    ``rollout_mesh_cells``): each step perceives in the tangent frame
    (t, n x t, n), updates, then diffuses the tangent field (detached).

    A0 [N, F], normals n [N, 3] and tangents t0 [N, 3] in particle order;
    returns (final_A [N, F], final_t [N, 3], states [n_steps+1, N, F] or
    None), in particle order. Differentiable in A0 and the parameters.
    ``use_kernels=False`` runs the kernels' plain versions on any device.
    """
    if eng.blk_md is None:
        raise ValueError("rollout_mesh_cells needs an engine built with "
                         "pair_tables (the diffusion blurs over the table)")
    S = eng.scatter(A0)
    nc = eng.scatter(n)
    t = eng.scatter(t0)
    states = [A0] if collect_all else None
    for _ in range(n_steps):
        S = nca_step_cells(
            params, cfg, eng, S, generator, h, fire_rate=fire_rate,
            use_kernels=use_kernels,
            perception_transform=functools.partial(
                project_tangent_space_cells, n=nc, t=t),
        )
        with torch.no_grad():
            t = diffuse_cells(eng, nc, t, S.detach(),
                              lerp_multiplier=lerp_multiplier,
                              w_multiplier=w_multiplier,
                              use_kernels=use_kernels)
        if collect_all:
            states.append(eng.gather_back(S))
    return (eng.gather_back(S), eng.gather_back(t),
            torch.stack(states) if collect_all else None)
