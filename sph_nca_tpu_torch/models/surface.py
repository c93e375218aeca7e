"""3D-surface rollouts on the graph, cell and band engines: tangent frames,
tangent diffusion and tangent-space perception, for one rollout and for B
rollouts at once.

Counterpart of ``sph_nca_tpu/models/surface.py``: the graph engine's
``diffuse``, ``project_tangent_space``, ``tangent_perception`` and
``rollout_mesh`` (one rollout on a model graph and a diffusion graph at
``DIFFUSE_H`` / ``DIFFUSE_DIMS``, plain PyTorch); and the cell- and
band-engine parts (``normalize``, ``orthogonalize``,
``project_tangent_space_cells``, ``diffuse_cells``, ``diffuse_band`` and
``rollout_mesh_cells``; reference nca.py:302-381), and of its batched
rollouts ``rollout_mesh_batched`` (:473) and ``rollout_mesh_batched_dual``
(:602), on either engine, with their pieces
(``normal_components``, ``_diffuse_td`` / ``_diffuse_weights`` /
``_diffuse_mt`` / ``_diffuse_combine``, ``_finish_mesh_batched``, and
the tangent projection ``ops.mlp_kernel.project_td``). The JAX package's
lane-layout wrappers ``diffuse_batched`` (:305) and
``project_tangent_space_lanes`` (:265) have no counterpart of their own: the
port steps only in the sample layout, where ``_diffuse_td`` and
``project_td`` compute the same functions.
On a cell engine every pair pass runs through the table kernels of
``ops/pair_kernel.py``, so the engine must be built with ``pair_tables``; on
a band engine (``ops/bands.py``) through its library products, reached by
the batched rollouts through the engine seam of ``ops/batched.py``.
``rollout_mesh_cells`` and
``rollout_mesh_batched`` diffuse at the engine's h (the reference diffuses at
``DIFFUSE_H`` = 0.1, every shipped model's h; like the JAX package, the port
does not enforce it); ``rollout_mesh_batched_dual`` diffuses on a second
engine.

The batched rollouts step in the port's sample layout: the state
[B, C, M, F], tangents as three [B, C, M] components, normals as three
loop-invariant [C, M] components. The JAX package fuses step t's diffusion
into step t+1's perception pass (a TPU schedule; its docstring calls it the
same function; on a band engine the blur rides the perception's smoothing
product as ``extra`` lanes); the port diffuses at the end of each step, as
the JAX dual rollout does, so one body serves both functions and both
engines. Not ported: ``unroll`` (a ``lax.scan`` knob); the fused schedule's
``extra`` lanes exist in ``ops/bands.perceive_band_batched`` but the
rollouts do not use them.

Numerics with ``mlp_dtype="bfloat16"``: the JAX package rounds the
perception and the normals to bfloat16 before the projection and the
re-orthogonalization; the port rounds the perception on a band engine
(as the JAX band step does), keeps it in float32 on a cell engine, keeps the
normals in float32, and projects in float32 (a documented deviation, as for
the table kernels' right-hand sides).

The fused route. When no gradient is needed, on a band engine with
bfloat16 tables and a bfloat16 MLP of F = 16 channels (all visible in the
inputs), a step's perception stops at the band products' raw moments and
its update is one launch of the fused variant of kernel 2.8
(``ops.mlp_kernel.fused_update``): the gradient's finish, the tangent
projection, the MLP and the rule with the fire select, rounded where the
composition rounds. Training (a gradient, float32), cell engines, float32
MLPs and the sharded band engine run the composition.

The fire-rate mask is drawn per slot (and sample) from a ``torch.Generator``:
the law of the JAX package, another stream, so trajectories match the JAX
package only at fire_rate == 1.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from ..ops import batched as BT
from ..ops.bands import BandEngine, blur_band
from ..ops.cells import CellEngine
from ..ops.hashgrid import SPHGraph
from ..ops.mlp_kernel import F_KERNEL, project_td
from ..ops.neighbor_ops import graph_blur
from ..ops.pair_kernel import blur_cells
from ..utils.profiling import span
from .cell_step import (
    _fused_step_samples,
    _mlp_weights,
    _step_samples,
    nca_step_cells,
)
from .nca import MLPParams, PerceptionTransform, SPHNCAConfig, nca_step

# the reference's tangent-diffusion radius and grid (nca.py:357)
DIFFUSE_H = 0.1
DIFFUSE_DIMS = 20


def normalize(v: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """v / (eps + |v|) (reference nca.py:303-305): a zero vector stays 0."""
    return v / (eps + torch.linalg.vector_norm(v, dim=-1, keepdim=True))


def orthogonalize(n: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Gram-Schmidt t against n, renormalized (reference nca.py:307-310)."""
    nt = torch.sum(n * t, dim=-1, keepdim=True)
    return normalize(t - n * nt)


def _diffuse_blend(t, A, blur, lerp_multiplier, w_multiplier):
    """The tangent diffusion around its blur (reference nca.py:312-323):
    blur [m, m t] with m the activity weights (ALWAYS the alpha lane, as the
    reference's diffuse() reads cell_activity at its default), t2 = blurred
    m t / blurred m, lerp back toward t where the particle is active."""
    w = torch.clamp(A[..., 3:4], 0.0, 1.0)
    m = (1.0 - w_multiplier) + w * w_multiplier
    mt2 = blur(torch.cat([m, m * t], dim=-1))
    t2 = mt2[..., 1:] / (1e-8 + mt2[..., :1])
    return t2 + (t - t2) * (w * lerp_multiplier)


def diffuse(n: torch.Tensor, t: torch.Tensor, A: torch.Tensor,
            diffuse_graph: SPHGraph, *, lerp_multiplier: float = 1.0,
            w_multiplier: float = 1.0) -> torch.Tensor:
    """The tangent diffusion on a graph (the JAX package's ``diffuse``): n,
    t [N, 3], A [N, >= 4] -> the new tangents [N, 3], re-orthogonalized
    against n."""
    t2 = _diffuse_blend(t, A, lambda mt: graph_blur(diffuse_graph, mt),
                        lerp_multiplier, w_multiplier)
    return orthogonalize(n, t2)


def project_tangent_space(gA: torch.Tensor, n: torch.Tensor,
                          t: torch.Tensor) -> torch.Tensor:
    """Perception vectors gA [..., F, 3] in the frame (t, n x t, n) of their
    particle or slot (n, t [..., 3]): out[..., k] = gA . {T, B, N}[k]
    (reference nca.py:325-330). Particle order: gA [..., N, C, 3], n, t
    [..., N, 3]; cell layout (``project_tangent_space_cells``): gA
    [..., C, M, F, 3], n, t [..., C, M, 3]."""
    b = torch.linalg.cross(n, t, dim=-1)
    tbn = torch.stack([t, b, n], dim=-1)  # [..., 3, 3]
    return torch.einsum("...fd,...dk->...fk", gA, tbn)


project_tangent_space_cells = project_tangent_space


def tangent_perception(n: torch.Tensor,
                       t: torch.Tensor) -> PerceptionTransform:
    """The mesh rollouts' perception transform (reference nca.py:332-336)."""
    return functools.partial(project_tangent_space, n=n, t=t)


def rollout_mesh(
    params: MLPParams,
    cfg: SPHNCAConfig,
    graph: SPHGraph,
    diffuse_graph: SPHGraph,
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
):
    """Surface rollout on the graph engine (reference ``sample_mesh``,
    nca.py:338-381): each step perceives in the tangent frame, updates, then
    diffuses the tangent field on ``diffuse_graph`` (detached).

    A0 [N, C], n, t0 [N, 3] -> (final_A, final_t, states [n_steps+1, N, C]
    or None). Differentiable in A0 and the parameters.
    """
    A, t = A0, t0
    states = [A0] if collect_all else None
    for _ in range(n_steps):
        A = nca_step(params, cfg, graph, A, generator, h, fire_rate=fire_rate,
                     perception_transform=tangent_perception(n, t))
        with torch.no_grad():
            t = diffuse(n, t, A, diffuse_graph,
                        lerp_multiplier=lerp_multiplier,
                        w_multiplier=w_multiplier)
        if collect_all:
            states.append(A)
    return A, t, torch.stack(states) if collect_all else None


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
    t2 = _diffuse_blend(
        t, S, lambda mt: blur_cells(eng, mt, use_kernels=use_kernels),
        lerp_multiplier, w_multiplier)
    return orthogonalize(n, t2)


def diffuse_band(eng, n: torch.Tensor, t: torch.Tensor, A: torch.Tensor, *,
                 lerp_multiplier: float = 1.0,
                 w_multiplier: float = 1.0) -> torch.Tensor:
    """The tangent diffusion (reference nca.py:312-323) in particle order
    with the blur on a band engine built at the diffusion radius (the JAX
    package's ``diffuse_band``): n, t [N, 3], A [N, >= 4] -> the new
    tangents [N, 3]. The weights are the alpha lane, as in
    ``diffuse_cells``."""
    t2 = _diffuse_blend(
        t, A, lambda mt: eng.gather_back(blur_band(eng, eng.scatter(mt))),
        lerp_multiplier, w_multiplier)
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


# ---- the batched rollouts (engines with pair tables) ----------------------


def normal_components(nc: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Split vectors [..., 3] into three contiguous [...] components, once
    per rollout (the normals [C, M, 3]; the tangents [B, C, M, 3])."""
    return tuple(nc[..., i].contiguous() for i in range(3))


def _diffuse_weights(S: torch.Tensor) -> torch.Tensor:
    """w = clip(alpha, 0, 1) per slot and sample: S [B, C, M, F] ->
    [B, C, M]. Always the alpha lane: the reference's diffuse() reads
    cell_activity at its default use_alpha=True (nca.py:312-314), whatever
    the model's own flag."""
    return torch.clamp(S[..., 3], 0.0, 1.0)


def _diffuse_mt(w: torch.Tensor, td, w_multiplier: float) -> torch.Tensor:
    """The diffusion blur's input [m, m t_x, m t_y, m t_z] [B, C, M, 4]
    (reference nca.py:315-317)."""
    m = (1.0 - w_multiplier) + w * w_multiplier
    return torch.stack([m] + [m * t for t in td], dim=-1)


def _diffuse_combine(mt2: torch.Tensor, w: torch.Tensor, td, nd,
                     lerp_multiplier: float) -> Tuple[torch.Tensor, ...]:
    """The diffusion's tail (nca.py:318-323): normalize by the blurred mass,
    lerp toward the previous tangent where active, re-orthogonalize against
    the shared normal and renormalize, per sample."""
    denom = 1e-8 + mt2[..., 0]
    lerp = w * lerp_multiplier
    t2d = []
    for i in range(3):
        ti = mt2[..., i + 1] / denom
        t2d.append(ti + (td[i] - ti) * lerp)
    ndot = t2d[0] * nd[0] + t2d[1] * nd[1] + t2d[2] * nd[2]
    t2d = [t2d[i] - nd[i] * ndot for i in range(3)]
    norm = torch.sqrt(t2d[0] ** 2 + t2d[1] ** 2 + t2d[2] ** 2)
    return tuple(t / (1e-8 + norm) for t in t2d)


def _slot_maps(eng, eng_d):
    """The static index pair between two engines' layouts of the same
    particles: ``to_d`` [C_d * M_d] gives each slot of ``eng_d`` the slot of
    ``eng`` that holds its particle, ``from_d`` [C * M] the reverse; a pad
    slot points one past the end, at a zero row (``_permute``)."""
    if eng_d.num_particles != eng.num_particles:
        raise ValueError("the diffusion engine holds "
                         f"{eng_d.num_particles} particles, the perception "
                         f"engine {eng.num_particles}")
    rows = eng.num_cells * eng.slots_per_cell
    rows_d = eng_d.num_cells * eng_d.slots_per_cell
    sp, sd = eng.slot_of_particle, eng_d.slot_of_particle
    to_d = torch.full((rows_d,), rows, dtype=torch.int64, device=sp.device)
    to_d[sd] = sp
    from_d = torch.full((rows,), rows_d, dtype=torch.int64, device=sp.device)
    from_d[sp] = sd
    return to_d, from_d


def _permute(X: torch.Tensor, idx: torch.Tensor, eng_to):
    """X [B, C, M, K] in one engine's layout -> [B, C', M', K] in
    ``eng_to``'s through an index of ``_slot_maps`` (pad slots get 0)."""
    b, c, m, k = X.shape
    flat = torch.cat([X.reshape(b, c * m, k), X.new_zeros(b, 1, k)], dim=1)
    return flat[:, idx].reshape(b, eng_to.num_cells, eng_to.slots_per_cell, k)


def _diffuse_td(eng, nd, td, S: torch.Tensor, *,
                lerp_multiplier: float = 1.0, w_multiplier: float = 1.0,
                use_kernels: bool = True,
                dual=None) -> Tuple[torch.Tensor, ...]:
    """Batched tangent diffusion in the sample layout (the JAX package's
    ``_diffuse_td``, and its ``diffuse_batched`` without the lane layout):
    normals nd (three [C, M]), tangents td (three [B, C, M]), states S
    [B, C, M, F] -> the new tangents (three [B, C, M]). The blur (the table
    blur 2.7, K = 4, on a cell engine; the band blur on a band engine) runs
    at ``eng``'s h or, with ``dual`` = (eng_d, to_d, from_d), on eng_d
    through ``_slot_maps``' index pair."""
    w = _diffuse_weights(S)
    mt = _diffuse_mt(w, td, w_multiplier)
    if dual is None:
        mt2 = BT.blur_samples(eng, mt, use_kernels=use_kernels)
    else:
        eng_d, to_d, from_d = dual
        mt2 = _permute(BT.blur_samples(eng_d, _permute(mt, to_d, eng_d),
                                       use_kernels=use_kernels), from_d, eng)
    return _diffuse_combine(mt2, w, td, nd, lerp_multiplier)


def _finish_mesh_batched(eng, S: torch.Tensor, td):
    """The rollouts' tail: the state [B, C, M, F] and tangents (three
    [B, C, M]) back to particle order, ([B, N, F], [B, N, 3])."""
    return eng.gather_back(S), eng.gather_back(torch.stack(td, dim=-1))


def _rollout_mesh_samples(params: MLPParams, cfg: SPHNCAConfig,
                          eng, eng_d,
                          A0: torch.Tensor, n: torch.Tensor, t0: torch.Tensor,
                          generator: torch.Generator, n_steps: int, h: float,
                          *, fire_rate, lerp_multiplier, w_multiplier,
                          mlp_dtype, remat, collect_all, use_kernels):
    """The body of both batched rollouts: perception on ``eng``, the
    diffusion blur on ``eng_d`` (``eng`` itself, or another engine of the
    same particles reached through one static index pair)."""
    BT.require_tables(eng)
    if not BT.has_w6(eng_d):
        raise ValueError("the diffusion engine needs pair_tables (the "
                         "diffusion blurs over its poly6 table)")
    if fire_rate is None:
        fire_rate = cfg.fire_rate
    needs_grad = torch.is_grad_enabled() and (
        A0.requires_grad or any(p.requires_grad for p in params))
    remat = remat and needs_grad
    with span("rollout"):
        dual = None if eng_d is eng else (eng_d, *_slot_maps(eng, eng_d))
        S = eng.scatter(A0)  # [B, C, M, F]
        nd = normal_components(eng.scatter(n))
        td = normal_components(eng.scatter(t0))
        weights = _mlp_weights(params, cfg, S.shape[-1], h, mlp_dtype)
        # what the fused route takes (ops.mlp_kernel.fused_update)
        fused = (isinstance(eng, BandEngine) and not needs_grad
                 and eng.Tband.dtype == weights[0].dtype == torch.bfloat16
                 and S.shape[-1] == F_KERNEL)

        def step(S, u, *td):
            if fused:
                return _fused_step_samples(cfg, eng, weights, S, u,
                                           fire_rate, use_kernels, nd, td)
            return _step_samples(
                cfg, eng, weights, S, u, fire_rate, use_kernels,
                lambda ga: project_td(ga, nd, td, include_normal=False))

        states = [A0] if collect_all else None
        for _ in range(n_steps):
            with span("rollout.step"):
                u = torch.rand(S.shape[:-1], generator=generator,
                               device=S.device)
                if remat:
                    S = checkpoint(step, S, u, *td, use_reentrant=False,
                                   preserve_rng_state=False)
                else:
                    S = step(S, u, *td)
                # the reference's step ends with T_t = diffuse(A_t,
                # T_{t-1}), detached (nca.py:352-357)
                with torch.no_grad(), span("rollout.diffuse"):
                    td = _diffuse_td(eng, nd, td, S.detach(),
                                     lerp_multiplier=lerp_multiplier,
                                     w_multiplier=w_multiplier,
                                     use_kernels=use_kernels, dual=dual)
            if collect_all:
                states.append(eng.gather_back(S))
        out = _finish_mesh_batched(eng, S, td)
        return out + (torch.stack(states),) if collect_all else out


def rollout_mesh_batched(
    params: MLPParams,
    cfg: SPHNCAConfig,
    eng,
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
    mlp_dtype: Optional[str] = None,
    remat: bool = False,
    collect_all: bool = False,
    use_kernels: bool = True,
):
    """B surface rollouts on one engine, a cell engine with pair tables or a
    band engine (the JAX package's ``rollout_mesh_batched``): per step,
    tangent-projected perception, the update (the fused MLP kernel,
    ``mlp_dtype="bfloat16"`` on bfloat16 inputs), the life masks, then a
    detached per-sample tangent diffusion at the engine's h.

    A0 [B, N, F], shared normals n [N, 3], tangents t0 [B, N, 3], in
    particle order -> (final_A [B, N, F], final_T [B, N, 3]), and states
    [n_steps+1, B, N, F] with ``collect_all``. Differentiable in A0 and the
    parameters (tangents detached); ``remat`` recomputes each step in the
    backward (torch.utils.checkpoint, as ``cell_step.REMAT``).
    ``use_kernels=False`` runs the kernels' plain versions on any device.
    Without a gradient, on a band engine with bfloat16 tables and MLP, each
    step's update is the fused route (the module docstring).
    """
    return _rollout_mesh_samples(
        params, cfg, eng, eng, A0, n, t0, generator, n_steps, h,
        fire_rate=fire_rate, lerp_multiplier=lerp_multiplier,
        w_multiplier=w_multiplier, mlp_dtype=mlp_dtype, remat=remat,
        collect_all=collect_all, use_kernels=use_kernels)


def rollout_mesh_batched_dual(
    params: MLPParams,
    cfg: SPHNCAConfig,
    eng,
    eng_d,
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
    mlp_dtype: Optional[str] = None,
    remat: bool = False,
    collect_all: bool = False,
    use_kernels: bool = True,
):
    """``rollout_mesh_batched`` with the diffusion blur on a second engine
    ``eng_d`` (the JAX package's ``rollout_mesh_batched_dual``): the
    reference diffuses at ``DIFFUSE_H`` whatever the model's h (nca.py:357),
    so a model with h != 0.1 needs two neighbourhoods. ``eng_d`` is built
    on the same particles, in the same order: a band engine, or a cell
    engine with pair tables (its poly6 table is all the blur reads:
    ``build_cell_engine(..., w6_only=True)`` will do); the two engines may
    be of different kinds. ``eng_d is eng`` runs ``rollout_mesh_batched``."""
    return _rollout_mesh_samples(
        params, cfg, eng, eng_d, A0, n, t0, generator, n_steps, h,
        fire_rate=fire_rate, lerp_multiplier=lerp_multiplier,
        w_multiplier=w_multiplier, mlp_dtype=mlp_dtype, remat=remat,
        collect_all=collect_all, use_kernels=use_kernels)
