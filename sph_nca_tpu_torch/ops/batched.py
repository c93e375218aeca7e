"""Batched-lane cell-engine ops: B rollouts of the same geometry at once.

Counterpart of ``sph_nca_tpu/ops/batched.py`` for a cell engine with pair
tables. The public functions keep the JAX package's lane layout
SB [C, M, B*F] (slot-dense, each slot's lanes sample-major, feature-minor), so
the two packages compare like with like. That layout exists for the TPU's
128-lane vregs; on this card the pair-table kernels take the samples apart,
[B, C, M, F], and read the window states through ``win_cells`` with a sample
stride. So each function converts to that layout (``to_samples``), runs the
port's table path (``ops/pair_kernel.py``: kernels 2.4 and 2.5 through the
``perceive_cells_dmajor`` Function, 2.6 for the mask, 2.7 for the blur) and
converts back (``to_lanes``). The batched rollout (``models/cell_step.py``)
converts once on entry and once on exit and steps in [B, C, M, F]; the
batched surface rollouts (``models/surface.py``) scatter particle-order
states straight into that layout and never build lanes.

Every function raises for an engine built without pair tables, as the JAX
package's do. Left out: the TPU layout knobs ``block_chunks``, ``out_dtype``,
``split_d`` and ``extra`` (they do not change the function on a cell engine,
where the JAX package's ``extra`` lanes fall back to a ``blur_batched`` pass
too; the band engine's batched API, ROADMAP §1 item 3, is where they
matter) and ``expand_lanes`` (a TPU relayout workaround; a broadcast does it
here).

Numerics with bfloat16 tables: the JAX package casts the volume-premultiplied
state (and the blurred values) to the table dtype before its products and
tests alive as Sv_alpha > 0.1 v in that dtype; the port's kernels keep every
right-hand side and the alive test in float32. With float32 tables the two
agree to summation order; with bfloat16 tables the port is the more accurate
(a documented deviation).
"""

from __future__ import annotations

import torch

from .cells import CellEngine
from .pair_kernel import blur_cells, mask_blur, perceive_cells_dmajor


def require_tables(eng: CellEngine) -> None:
    if eng.blk_md is None:
        raise ValueError("engine was built without pair_tables")


def batched_scatter(eng: CellEngine, A: torch.Tensor) -> torch.Tensor:
    """[B, N, F] particle order -> SB [C, M, B*F] (pad slots zero)."""
    b, _, f = A.shape
    c, m = eng.num_cells, eng.slots_per_cell
    flat = A.new_zeros((c * m, b, f))
    flat[eng.slot_of_particle] = A.transpose(0, 1)
    return flat.reshape(c, m, b * f)


def batched_gather_back(eng: CellEngine, SB: torch.Tensor,
                        b: int) -> torch.Tensor:
    """SB [C, M, B*F] -> [B, N, F] particle order."""
    c, m = eng.num_cells, eng.slots_per_cell
    f = SB.shape[-1] // b
    return SB.reshape(c * m, b, f)[eng.slot_of_particle].transpose(0, 1)


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


def perceive_cells_batched(eng: CellEngine, SB: torch.Tensor, b: int,
                           use_alpha: bool = True, *,
                           use_kernels: bool = True):
    """Batched perception + pre-step life-mask blur: SB [C, M, B*F] ->
    (gaB [C, M, D*B*F] in d-major lane blocks, pre_sm [C, M, B]),
    differentiable in SB through gaB (the table adjoint)."""
    require_tables(eng)
    ga, sm = perceive_cells_dmajor(eng, to_samples(SB, b), use_alpha,
                                   use_kernels=use_kernels)
    return dmajor_to_lanes(ga, eng.xs.shape[-1]), sm.permute(1, 2, 0)


def mask_blur_batched(eng: CellEngine, SB: torch.Tensor, b: int,
                      use_alpha: bool = True, *,
                      use_kernels: bool = True) -> torch.Tensor:
    """Batched life-mask blur: SB [C, M, B*F] -> sm [C, M, B] (the caller
    thresholds)."""
    require_tables(eng)
    return mask_blur(eng, to_samples(SB, b), use_alpha=use_alpha,
                     use_kernels=use_kernels).permute(1, 2, 0)


def blur_batched(eng: CellEngine, XB: torch.Tensor, b: int, *,
                 use_kernels: bool = True) -> torch.Tensor:
    """Batched SPH blur of per-slot values XB [C, M, B*K] -> [C, M, B*K]
    (the blur kernel takes K = 4, the tangent diffusion's)."""
    require_tables(eng)
    return to_lanes(blur_cells(eng, to_samples(XB, b),
                               use_kernels=use_kernels))
