"""NCA step and rollouts over the cell-dense and band engines (single device).

Counterpart of ``sph_nca_tpu/models/cell_step.py`` (``use_pallas=True``).
Perception and both life masks go through the pair-pass
kernels of ``ops/pair_kernel.py`` (the table kernels when the engine has pair
tables); the update MLP is plain PyTorch. ``nca_step_cells`` takes a
``perception_transform`` (the surface rollout's tangent projection), which
reads the gradient in the [..., C, M, F, D] layout, as the JAX step's
non-d-major branch does. The step and ``rollout_cells`` are differentiable in
the parameters and the state (perception's backward is the gradient-adjoint
kernel); ``rollout_states_cells`` is inference only.

Multi-rank: on this rank's shard of an engine built with ``n_shards`` = the
particle axis (``parallel.mesh.shard_cell_engine``), every step and rollout
here runs on the rank's cells: the passes go through the engine seam of
``ops/batched.py``, which hands a shard its own passes (the kernels on its
blocks, the windows' rows gathered over the particle group,
``parallel/cell_shard.py``), and the fire draws are the whole engine's with
the rank's cells kept (``ops.batched.fire_draws``), so the ranks draw what
the whole engine draws on one device from the same generator.

States carry an optional leading batch axis: S [B, C, M, F] runs B samples on
one geometry, each kernel launching once per bucket for the whole batch (the
JAX trainer vmaps the per-sample rollout instead).

The batched-lane path (``nca_step_cells_batched``, ``_update_core``,
``rollout_cells_batched``; cell engines with pair tables, or band engines)
keeps the JAX package's lane layout [C, M, B*F] at its boundary and steps in
[B, C, M, F] inside (``ops/batched.py``). Its perception and both life masks
go through the engine seam of ``ops/batched.py``: on a cell engine the table
kernels, on a band engine (``ops/bands.py``, C = blocks, M = rows) its
library products, with the perception rounded to the MLP's dtype as the JAX
package's band step rounds it. Its update MLP is the fused kernel of
``ops/mlp_kernel.py`` on per-sample weights with the perception scale folded
into W1's gA rows (the JAX package's ``_update_core_pallas``). The JAX
package's other two implementations of the same function, ``blockdiag`` and
``sublane`` (TPU layouts chosen by ``SPH_NCA_MLP_IMPL``), are not ported, and
the port has no such switch.

The fire-rate mask is drawn per SLOT (per slot and sample on the batched
path) from a ``torch.Generator``: the same Bernoulli(fire_rate) law as the JAX
package, another stream, so trajectories match the JAX package exactly only
at fire_rate == 1.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch.utils.checkpoint import checkpoint

from ..ops import bands as BD
from ..ops import batched as BT
from ..ops.cells import CellEngine
from ..ops.mlp_kernel import fused_update, mlp_fused, update_rule
from ..utils.profiling import span
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

    # the kernel's d-major [..., C, M, D*F] layout is the feature concat
    # order (gA_x block, then gA_y; a z block in 3D is dropped)
    gA_dm, pre_sm = BT.perceive_samples(eng, S, cfg.use_alpha,
                                        use_kernels=use_kernels)
    if cfg.normalize_perception > 0:
        gA_dm = h * gA_dm * cfg.normalize_perception
    if perception_transform is None:
        y = torch.cat([S, gA_dm[..., : 2 * f]], dim=-1)
    else:
        gA = perception_transform(
            gA_dm.unflatten(-1, (-1, f)).transpose(-2, -1))
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
    new_sm = BT.mask_blur_samples(eng, nS.detach(), cfg.use_alpha,
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
    MLP (the surface rollout's tangent projection). On a rank's shard of
    an engine, S [..., C/k, M, F] is its cells (the module docstring).
    """
    if fire_rate is None:
        fire_rate = cfg.fire_rate
    u = BT.fire_draws(eng, S, generator)
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
    """``n_steps`` steps in cell layout from S0 [..., C, M, F] (a rank's
    cells on its shard, as ``nca_step_cells``).

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
        u = BT.fire_draws(eng, S, generator)
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


# ---- the batched-lane path (engines with pair tables) ---------------------


def _mlp_weights(params: MLPParams, cfg: SPHNCAConfig, f: int, h: float,
                 mlp_dtype):
    """The update MLP's per-sample weights for ``mlp_fused``: W1 and W2 in
    the MLP dtype, the perception scale h k folded into W1's gA rows (the
    scale rounded to the MLP dtype on the host, as the JAX step rounds it),
    W2 cut to the rule's outputs; the biases float32. Built once per
    rollout (XLA hoists the same out of the JAX scan)."""
    if cfg.update_rule not in ("gated", "orig"):
        raise ValueError(f"unknown update rule {cfg.update_rule!r}")
    ydt = getattr(torch, mlp_dtype) if mlp_dtype else torch.float32
    scale = torch.tensor(h * cfg.normalize_perception
                         if cfg.normalize_perception > 0 else 1.0,
                         dtype=ydt).item()
    w1 = params.w1.to(ydt)
    w2 = params.w2.to(ydt)
    if cfg.update_rule == "orig":
        w2 = w2[:, :cfg.channels]
    return (torch.cat([w1[:f], w1[f:] * scale]), params.b1.float(),
            w2.contiguous(), params.b2.float()[:w2.shape[-1]].contiguous())


def _update_samples(cfg: SPHNCAConfig, weights, S: torch.Tensor,
                    ga: torch.Tensor, u: torch.Tensor, fire_rate: float,
                    use_kernels: bool) -> torch.Tensor:
    """The batched step's update for states S [..., F], their perception ga
    [..., >= 2F] (per-sample d-major: gA_x, gA_y, ...) and fire draws u
    [...]: the fused update MLP on ``_mlp_weights``, the gated or orig rule,
    and the fire mask (``update_rule``). Returns the pre-life-mask state
    [..., F]."""
    f = S.shape[-1]
    ydt = weights[0].dtype
    outs = mlp_fused(S.to(ydt), ga[..., :2 * f].to(ydt), *weights,
                     use_kernel=use_kernels)
    return update_rule(S, *outs, u, fire_rate, cfg.fire_rate / fire_rate)


def _update_core(params: MLPParams, cfg: SPHNCAConfig, SB2: torch.Tensor,
                 gaB: torch.Tensor, b: int, f: int,
                 generator: torch.Generator, h: float, fire_rate: float,
                 mlp_dtype=None, *, use_kernels: bool = True) -> torch.Tensor:
    """The batched step's update in the JAX package's lane layout: SB2
    [rows, B*F], gaB [..., D*B*F] (d-major lane blocks) -> the pre-life-mask
    state [rows, B*F], with a fire draw per (slot, sample) from
    ``generator``."""
    rows = SB2.shape[0]
    d = gaB.shape[-1] // (b * f)
    ga = gaB.reshape(rows, d, b, f)[:, :2].transpose(1, 2).reshape(
        rows, b, 2 * f)
    u = torch.rand((rows, b), generator=generator, device=SB2.device)
    return _update_samples(cfg, _mlp_weights(params, cfg, f, h, mlp_dtype),
                           SB2.reshape(rows, b, f), ga, u, fire_rate,
                           use_kernels).reshape(rows, b * f)


def _step_samples(cfg: SPHNCAConfig, eng, weights,
                  S: torch.Tensor, u: torch.Tensor, fire_rate: float,
                  use_kernels: bool,
                  perception_transform=None) -> torch.Tensor:
    """One batched step on S [B, C, M, F] given the MLP's weights
    (``_mlp_weights``) and the fire draws u [B, C, M]: perception (table
    kernels 2.4 / 2.5 on a cell engine, the band products on a band engine),
    pre-mask, the update, the post-update mask (detached), each pass through
    the engine seam of ``ops/batched.py``. ``perception_transform`` maps the
    unscaled per-sample d-major gradient ga [B, C, M, D*F] to features
    [B, C, M, >= 2F] whose first 2F lanes feed the MLP (the surface
    rollout's tangent projection returns just those two blocks)."""
    ydt = weights[0].dtype
    with span("step.perceive"):
        ga, pre_sm = BT.perceive_samples(
            eng, S, cfg.use_alpha,
            out_dtype=None if ydt == torch.float32 else ydt,
            use_kernels=use_kernels)
        if perception_transform is not None:
            ga = perception_transform(ga)
        prev_mask = pre_sm > ALIVE_THRESHOLD
    with span("step.update"):
        nS = _update_samples(cfg, weights, S, ga, u, fire_rate, use_kernels)
    return _step_tail(cfg, eng, nS, prev_mask, use_kernels)


def _fused_step_samples(cfg: SPHNCAConfig, eng, weights,
                        S: torch.Tensor, u: torch.Tensor, fire_rate: float,
                        use_kernels: bool, nd, td) -> torch.Tensor:
    """``_step_samples`` with the surface rollouts' tangent projection on a
    ``BandEngine``, by the fused route (``models/surface.py`` chooses it):
    the products' raw moments (``bands.perceive_band_moments``) go to
    ``ops.mlp_kernel.fused_update``, which finishes the gradient, projects
    it onto the frame (the tangents td, three [B, C, M], and n x t, with the
    normals nd, three [C, M]) and applies the MLP and the rule in one
    launch."""
    with span("step.perceive"):
        mom, pre_sm = BD.perceive_band_moments(eng, S, cfg.use_alpha,
                                               weights[0].dtype)
        prev_mask = pre_sm > ALIVE_THRESHOLD
    with span("step.update"):
        nS = fused_update(mom, S, eng.gsum, eng.sig_g, nd, td, weights, u,
                          fire_rate, cfg.fire_rate / fire_rate,
                          use_kernel=use_kernels)
    return _step_tail(cfg, eng, nS, prev_mask, use_kernels)


def _step_tail(cfg: SPHNCAConfig, eng, nS: torch.Tensor,
               prev_mask: torch.Tensor, use_kernels: bool) -> torch.Tensor:
    """A batched step's tail: the post-update mask of the pre-life-mask
    state nS (detached) and the life mask with the pre-step one."""
    with span("step.mask"):
        new_sm = BT.mask_blur_samples(eng, nS.detach(), cfg.use_alpha,
                                      use_kernels=use_kernels)
        living = (prev_mask & (new_sm > ALIVE_THRESHOLD)).to(nS.dtype)
        return nS * living[..., None]


def nca_step_cells_batched(
    params: MLPParams,
    cfg: SPHNCAConfig,
    eng,
    SB: torch.Tensor,
    b: int,
    generator: torch.Generator,
    h: float,
    fire_rate: Optional[float] = None,
    mlp_dtype=None,
    perception_transform=None,
    *,
    use_kernels: bool = True,
) -> torch.Tensor:
    """One NCA step of B same-geometry rollouts in the lane layout:
    SB [C, M, B*F] -> [C, M, B*F]; per sample the function of
    ``nca_step_cells``, with a fire draw per (slot, sample).

    ``mlp_dtype="bfloat16"`` runs the update MLP on bfloat16 inputs and
    weights (float32 sums). ``perception_transform`` maps the unscaled
    gradient lanes gaB [C, M, D*B*F] to d-major lane blocks [C, M, K*B*F],
    K >= 2 (it costs two layout copies a step; the batched rollouts hand
    ``_step_samples`` a transform in the sample layout instead). Needs a
    band engine or a cell engine with pair tables, as the JAX package's.
    """
    BT.require_tables(eng)
    if fire_rate is None:
        fire_rate = cfg.fire_rate
    S = BT.to_samples(SB, b)
    u = BT.fire_draws(eng, S, generator)
    weights = _mlp_weights(params, cfg, S.shape[-1], h, mlp_dtype)
    transform = None
    if perception_transform is not None:
        d, f = eng.xs.shape[-1], S.shape[-1]

        def transform(ga):
            out = perception_transform(BT.dmajor_to_lanes(ga, d))
            return BT.lanes_to_dmajor(out, b, out.shape[-1] // (b * f))
    return BT.to_lanes(_step_samples(cfg, eng, weights, S, u, fire_rate,
                                     use_kernels, transform))


def rollout_cells_batched(
    params: MLPParams,
    cfg: SPHNCAConfig,
    eng,
    SB0: torch.Tensor,
    b: int,
    generator: torch.Generator,
    max_steps: int,
    h: float,
    *,
    n_steps: Optional[Sequence[int]] = None,
    fire_rate: Optional[float] = None,
    collect_steps: Optional[Sequence[int]] = None,
    mlp_dtype=None,
    use_kernels: bool = True,
):
    """``max_steps`` batched steps from SB0 [C, M, B*F].

    ``n_steps`` [B] gives each sample its own length: a sample stops changing
    after its n_steps steps (the progressive-growing rollouts freeze finished
    samples in place). Returns the final state or, with ``collect_steps``,
    (final, collected [len(collect_steps), C, M, B*F]) holding the state
    after step k for each k (k = 0 is SB0). The layout changes to
    [B, C, M, F] once on entry and back once on exit. When a gradient is
    needed each step is recomputed in the backward (``REMAT``); the fire
    draws are made outside the recomputed function.
    """
    BT.require_tables(eng)
    if fire_rate is None:
        fire_rate = cfg.fire_rate
    collect = [] if collect_steps is None else [int(k) for k in collect_steps]
    if any(not 0 <= k <= max_steps for k in collect):
        raise ValueError(f"collect_steps {collect} outside [0, {max_steps}]")
    ends = [max_steps] * b if n_steps is None else [int(n) for n in n_steps]
    if len(ends) != b:
        raise ValueError(f"n_steps has {len(ends)} entries for {b} samples")
    remat = REMAT and torch.is_grad_enabled() and (
        SB0.requires_grad or any(p.requires_grad for p in params))

    with span("rollout"):
        S = BT.to_samples(SB0, b)
        weights = _mlp_weights(params, cfg, S.shape[-1], h, mlp_dtype)
        ends_dev = torch.tensor(ends, device=S.device)  # one copy a rollout

        def step(S, u):
            return _step_samples(cfg, eng, weights, S, u, fire_rate,
                                 use_kernels)

        buf = [S] * len(collect)
        for t in range(max_steps):
            with span("rollout.step"):
                u = BT.fire_draws(eng, S, generator)
                if remat:
                    nS = checkpoint(step, S, u, use_reentrant=False,
                                    preserve_rng_state=False)
                else:
                    nS = step(S, u)
                if any(t >= n for n in ends):
                    nS = torch.where((ends_dev > t)[:, None, None, None],
                                     nS, S)
                S = nS
            for i, k in enumerate(collect):
                if k == t + 1:
                    buf[i] = S
        final = BT.to_lanes(S)
        if collect_steps is None:
            return final
        return final, (BT.to_lanes(torch.stack(buf)) if buf
                       else SB0.new_empty((0,) + SB0.shape))
