"""Batched-lane ops: B rollouts of the same geometry at once, on a cell engine
with pair tables or on a band engine.

Counterpart of ``sph_nca_tpu/ops/batched.py``. The public functions keep the
JAX package's lane layout SB [C, M, B*F] (slot-dense, each slot's lanes
sample-major, feature-minor), so the two packages compare like with like, and
dispatch on the engine as the JAX package's do: a ``BandEngine`` goes to
``ops/bands.py`` (C = blocks, M = rows), whose products read each table once
for the B samples in their columns. On a cell engine the pair-table kernels
take the samples apart, [B, C, M, F], and read the window states through
``win_cells`` with a sample stride; so each function converts to that layout
(``to_samples``), runs the port's table path (``ops/pair_kernel.py``: kernels
2.4 and 2.5 through the ``perceive_cells_dmajor`` Function, 2.6 for the
mask, 2.7 for the blur) and converts back (``to_lanes``).

The batched rollouts (``models/cell_step.py``, ``models/surface.py``) step in
[B, C, M, F] and reach the pair passes through the engine seam
``perceive_samples``, ``mask_blur_samples`` and ``blur_samples``: on a
``CellEngine`` the functions of ``ops/pair_kernel.py`` unchanged, on a
``BandEngine`` those of ``ops/bands.py``, and on a rank's shard of either
(``parallel/cell_shard.CellShard``, ``parallel/band_shard.BandShardEngine``)
the shard's own passes, which exchange the windows' rows over its particle
group.

Every function raises for a cell engine built without pair tables, as the
JAX package's do. Left out: the TPU layout knobs ``block_chunks`` and
``split_d`` (they do not change the function) and ``expand_lanes`` (a TPU
relayout workaround; a broadcast does it here), and ``extra`` of the
perception (a blur riding the band engine's smoothing product, for the JAX
package's fused diffusion schedule, which the port does not run).
``out_dtype`` rounds the band engine's gradient; a cell engine's path emits
float32 and refuses it.

Numerics with bfloat16 tables on a cell engine: the JAX package casts the
volume-premultiplied state (and the blurred values) to the table dtype before
its products and tests alive as Sv_alpha > 0.1 v in that dtype; the port's
kernels keep every right-hand side and the alive test in float32. With
float32 tables the two agree to summation order; with bfloat16 tables the
port is the more accurate (a documented deviation). The band engine casts
its right-hand sides as the JAX package does.
"""

from __future__ import annotations

import torch

from . import bands as BD
from .bands import BandEngine
from .cells import CellEngine
from .gather import gather_injective
from .pair_kernel import blur_cells, mask_blur, perceive_cells_dmajor


def has_tables(eng) -> bool:
    """Whether the engine takes the batched-lane path: a band engine or a
    rank's shard of one (its tables are the engine), or a cell engine (or a
    rank's shard of one) built with pair tables."""
    if hasattr(eng, "blk_md"):
        return eng.blk_md is not None
    return True


def require_tables(eng) -> None:
    if not has_tables(eng):
        raise ValueError("engine was built without pair_tables")


def has_w6(eng) -> bool:
    """Whether the engine can blur: a band engine (or a rank's shard of
    one), or a cell engine (or shard) with its poly6 table."""
    if hasattr(eng, "blk_w6"):
        return eng.blk_w6 is not None
    return True


def batched_scatter(eng, A: torch.Tensor) -> torch.Tensor:
    """[B, N, F] particle order -> SB [C, M, B*F] (pad slots zero)."""
    b, _, f = A.shape
    c, m = eng.num_cells, eng.slots_per_cell
    flat = A.new_zeros((c * m, b, f))
    flat[eng.slot_of_particle] = A.transpose(0, 1)
    return flat.reshape(c, m, b * f)


def batched_gather_back(eng, SB: torch.Tensor,
                        b: int) -> torch.Tensor:
    """SB [C, M, B*F] -> [B, N, F] particle order (its backward copies into
    the distinct slots, no accumulation)."""
    c, m = eng.num_cells, eng.slots_per_cell
    f = SB.shape[-1] // b
    return gather_injective(SB.reshape(c * m, b, f), eng.slot_of_particle,
                            0).transpose(0, 1)


def to_samples(SB: torch.Tensor, b: int) -> torch.Tensor:
    """Lanes [..., C, M, B*F] -> samples [..., B, C, M, F] (contiguous)."""
    *lead, c, m, bf = SB.shape
    return SB.reshape(*lead, c, m, b, bf // b).movedim(-2, -4).contiguous()


def to_lanes(S: torch.Tensor) -> torch.Tensor:
    """Samples [..., B, C, M, F] -> lanes [..., C, M, B*F] (contiguous)."""
    *lead, b, c, m, f = S.shape
    return S.movedim(-4, -2).reshape(*lead, c, m, b * f)


def dmajor_to_lanes(ga: torch.Tensor, d: int) -> torch.Tensor:
    """Per-sample d-major gradients [B, C, M, D*F] -> the JAX package's
    d-major lane blocks [C, M, D*B*F] (lanes [i*B*F, (i+1)*B*F) hold axis
    i)."""
    b, c, m, df = ga.shape
    return ga.reshape(b, c, m, d, df // d).permute(1, 2, 3, 0, 4).reshape(
        c, m, df * b)


def lanes_to_dmajor(gaB: torch.Tensor, b: int, d: int) -> torch.Tensor:
    """Inverse of ``dmajor_to_lanes``."""
    c, m, dbf = gaB.shape
    f = dbf // (d * b)
    return gaB.reshape(c, m, d, b, f).permute(3, 0, 1, 2, 4).reshape(
        b, c, m, d * f)


# ---- the engine seam of the batched rollouts (sample layout) --------------


def perceive_samples(eng, S: torch.Tensor, use_alpha: bool = True, *,
                     out_dtype=None, use_kernels: bool = True):
    """Perception + pre-step life-mask blur of samples S [B, C, M, F]: (ga
    [B, C, M, D*F] per-sample d-major, pre_sm [B, C, M]), differentiable in
    S through ga. A cell engine runs ``perceive_cells_dmajor`` (kernels 2.4
    / 2.5, or 2.1 / 2.2 without tables); a band engine its library products
    (``out_dtype`` rounds its gradient)."""
    if isinstance(eng, BandEngine):
        return BD.perceive_band_samples(eng, S, use_alpha, out_dtype)
    if isinstance(eng, CellEngine):
        return perceive_cells_dmajor(eng, S, use_alpha,
                                     use_kernels=use_kernels)
    return eng.perceive_samples(S, use_alpha, out_dtype=out_dtype,
                                use_kernels=use_kernels)


def mask_blur_samples(eng, S: torch.Tensor, use_alpha: bool = True, *,
                      use_kernels: bool = True) -> torch.Tensor:
    """Life-mask blur of samples S [B, C, M, F] -> sm [B, C, M] (the caller
    thresholds)."""
    if isinstance(eng, BandEngine):
        return BD.mask_blur_band_samples(eng, S, use_alpha)
    if isinstance(eng, CellEngine):
        return mask_blur(eng, S, use_alpha=use_alpha,
                         use_kernels=use_kernels)
    return eng.mask_blur_samples(S, use_alpha, use_kernels=use_kernels)


def blur_samples(eng, X: torch.Tensor, *,
                 use_kernels: bool = True) -> torch.Tensor:
    """SPH blur of per-slot values X [B, C, M, K] -> [B, C, M, K] over the
    engine's smoothing table (kernel 2.7 on a cell engine, K = 4)."""
    if isinstance(eng, BandEngine):
        return BD.blur_band_samples(eng, X)
    if isinstance(eng, CellEngine):
        return blur_cells(eng, X, use_kernels=use_kernels)
    return eng.blur_samples(X, use_kernels=use_kernels)


def fire_draws(eng, S: torch.Tensor, generator: torch.Generator
               ) -> torch.Tensor:
    """The fire draws u [..., C, M] of states S [..., C, M, F], uniform in
    [0, 1) from ``generator``. A rank's shard of an engine (its
    ``shard_cells``: its first cell, the whole engine's cells) draws the
    whole engine's and keeps its own cells, so the ranks draw what the
    whole engine draws on one device from the same generator, and no two
    shards draw alike."""
    part = getattr(eng, "shard_cells", None)
    if part is None:
        return torch.rand(S.shape[:-1], generator=generator, device=S.device)
    first, total = part
    u = torch.rand(S.shape[:-3] + (total, S.shape[-2]), generator=generator,
                   device=S.device)
    return u.narrow(-2, first, S.shape[-3])


# ---- the lane-layout API (the JAX package's) ------------------------------


def perceive_cells_batched(eng, SB: torch.Tensor, b: int,
                           use_alpha: bool = True, *, out_dtype=None,
                           use_kernels: bool = True):
    """Batched perception + pre-step life-mask blur: SB [C, M, B*F] ->
    (gaB [C, M, D*B*F] in d-major lane blocks, pre_sm [C, M, B]),
    differentiable in SB through gaB (the table adjoint on a cell engine).
    ``out_dtype`` (a band engine only) rounds gaB."""
    if isinstance(eng, BandEngine):
        return BD.perceive_band_batched(eng, SB, b, use_alpha, out_dtype)
    require_tables(eng)
    if out_dtype is not None:
        raise ValueError("out_dtype: a cell engine's perception emits "
                         "float32")
    ga, sm = perceive_cells_dmajor(eng, to_samples(SB, b), use_alpha,
                                   use_kernels=use_kernels)
    return dmajor_to_lanes(ga, eng.xs.shape[-1]), sm.permute(1, 2, 0)


def mask_blur_batched(eng, SB: torch.Tensor, b: int,
                      use_alpha: bool = True, *,
                      use_kernels: bool = True) -> torch.Tensor:
    """Batched life-mask blur: SB [C, M, B*F] -> sm [C, M, B] (the caller
    thresholds)."""
    if isinstance(eng, BandEngine):
        return BD.mask_blur_band(eng, SB, b, use_alpha)
    require_tables(eng)
    return mask_blur(eng, to_samples(SB, b), use_alpha=use_alpha,
                     use_kernels=use_kernels).permute(1, 2, 0)


def blur_batched(eng, XB: torch.Tensor, b: int, *,
                 use_kernels: bool = True) -> torch.Tensor:
    """Batched SPH blur of per-slot values XB [C, M, B*K] -> [C, M, B*K]
    (the cell engine's blur kernel takes K = 4, the tangent diffusion's)."""
    if isinstance(eng, BandEngine):
        return BD.blur_band(eng, XB)
    require_tables(eng)
    return to_lanes(blur_cells(eng, to_samples(XB, b),
                               use_kernels=use_kernels))
