"""The cell engine's pair kernels sharded over the particle axis, one rank a
shard.

Counterpart of ``sph_nca_tpu/parallel/cell_shard.py``. The engine is built
with ``build_cell_engine(..., n_shards=k)`` (k = the particle axis), so its
bucket rows are shard-major with equal per-shard counts and each shard's
cells are [its bucket-1 blocks | its bucket-2 blocks]; ``CellShard.of``
keeps a rank's cells and blocks (and their pair tables) and drops the
rest. Each rank runs the bucket kernels of ``ops/pair_kernel.py`` on its own
blocks; the windows cross shard ends, so each pass first gathers the operand
it windows over the particle group:

    perception fwd : gather(S)        C*M*F floats      kernels 2.1 / 2.4
    perception bwd : gather(gbar)     C*M*D*F floats    kernels 2.2 / 2.5
    life-mask blur : gather(alpha)    C*M floats        kernels 2.3 / 2.6
    tangent blur   : gather(X)        C*M*K floats      kernel 2.7

The kernels read the window rows of the gathered state through the blocks'
global ``win_cells`` and their own rows from the rank's cells
(``fused_perception(..., window=...)``). ``perceive_cells_dmajor_sharded``
is a ``torch.autograd.Function`` (the JAX package's custom VJP): its forward
gathers S and runs 2.1 or 2.4, its backward gathers the cotangent and runs
2.2 or 2.5. The leading batch axis of the batched path ([B, C, M, F]) rides
along: the pair tables stay rank-local, and the update MLP (2.8) runs on
each rank's rows.

What the JAX package runs on XLA alone stays out: the GSPMD sharding of the
cell engine's einsum path. The port has no ``Tw`` / ``Tg`` einsum operators
(``ops/cells.py``), so this kernel path is the counterpart.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F

from ..ops import pair_kernel as PK
from ..ops.cells import CellEngine
from . import comm
from .mesh import PARTICLE_AXIS, coords, particle_group


@dataclasses.dataclass
class CellShard:
    """One rank's shard of a ``CellEngine``: its C / k cells and its blocks
    of both buckets, on the engine's device, with the particle group the
    passes exchange over. The block fields keep the ``CellEngine`` names, so
    the functions of ``ops/pair_kernel.py`` run it; their ``win_cells``
    index the whole engine's cells."""

    mesh: object  # DeviceMesh
    num_cells: int  # C of the whole engine
    xs: torch.Tensor  # [C/k, M, D] this rank's cells
    vs: torch.Tensor  # [C/k, M]
    gsum: torch.Tensor  # [C/k, M, D]
    blk_xs: torch.Tensor
    blk_win_cells: torch.Tensor
    blk_xw: torch.Tensor
    blk_vw: torch.Tensor
    blk2_xs: torch.Tensor
    blk2_win_cells: torch.Tensor
    blk2_xw: torch.Tensor
    blk2_vw: torch.Tensor
    h: float
    sig_w: float
    sig_g: float
    blk_md: Optional[torch.Tensor] = None
    blk_w6: Optional[torch.Tensor] = None
    blk2_md: Optional[torch.Tensor] = None
    blk2_w6: Optional[torch.Tensor] = None
    # the rank's own cells are one shard's layout, [b1 | b2]
    n_shards: int = 1
    first_cell: int = 0  # this rank's first cell in the whole engine

    @classmethod
    def of(cls, eng: CellEngine, mesh) -> "CellShard":
        k = mesh.size(mesh.mesh_dim_names.index(PARTICLE_AXIS))
        if eng.n_shards != k:
            raise ValueError(
                f"the engine was built with n_shards={eng.n_shards} for a "
                f"{k}-way particle axis; build it with n_shards={k}")
        r = coords(mesh)[1]

        def rows(t):
            if t is None:
                return None
            n = t.shape[0] // k
            return t[r * n:(r + 1) * n].contiguous()

        blk = {name: rows(getattr(eng, name)) for name in (
            "xs", "vs", "gsum", "blk_xs", "blk_win_cells", "blk_xw",
            "blk_vw", "blk2_xs", "blk2_win_cells", "blk2_xw", "blk2_vw",
            "blk_md", "blk_w6", "blk2_md", "blk2_w6")}
        return cls(mesh=mesh, num_cells=eng.num_cells, h=eng.h,
                   sig_w=eng.sig_w, sig_g=eng.sig_g,
                   first_cell=r * (eng.num_cells // k), **blk)

    @property
    def group(self):
        return particle_group(self.mesh)

    @property
    def device(self) -> torch.device:
        return self.xs.device

    @property
    def slots_per_cell(self) -> int:
        return self.xs.shape[1]

    @property
    def shard_cells(self):
        """(this rank's first cell, the whole engine's cells): the fire
        draws' slice (``ops.batched.fire_draws``)."""
        return self.first_cell, self.num_cells

    # -- the engine seam of ops/batched.py (samples [B, C/k, M, F]) ---------

    def perceive_samples(self, S, use_alpha=True, *, out_dtype=None,
                         use_kernels=True):
        return perceive_cells_dmajor_sharded(self.mesh, self, S, use_alpha,
                                             use_kernels=use_kernels)

    def mask_blur_samples(self, S, use_alpha=True, *, use_kernels=True):
        return mask_blur_sharded(self.mesh, self, S, use_alpha=use_alpha,
                                 use_kernels=use_kernels)

    def blur_samples(self, X, *, use_kernels=True):
        return blur_sharded(self.mesh, self, X, use_kernels=use_kernels)


def _check(mesh, eng) -> None:
    if not isinstance(eng, CellShard) or eng.mesh is not mesh:
        raise ValueError("the sharded cell passes take this rank's shard of "
                         "the engine: parallel.mesh.shard_cell_engine(eng, "
                         "mesh)")


class _PerceiveSharded(torch.autograd.Function):
    """gather(S), then 2.1 / 2.4 on this rank's blocks; the backward
    gathers the cotangent, then 2.2 / 2.5."""

    @staticmethod
    def forward(ctx, S, eng, use_alpha, use_kernels):
        full = comm.gather_raw(S.contiguous(), eng.group, dim=-3)
        ga, sm = PK.fused_perception(eng, S, use_alpha=use_alpha,
                                     d_major=True, use_kernels=use_kernels,
                                     window=full)
        ctx.eng, ctx.use_kernels = eng, use_kernels
        ctx.mark_non_differentiable(sm)
        return ga, sm

    @staticmethod
    def backward(ctx, gbar, _):
        gbar = gbar.contiguous()
        full = comm.gather_raw(gbar, ctx.eng.group, dim=-3)
        da = PK.gradient_adjoint_dmajor(ctx.eng, gbar,
                                        use_kernels=ctx.use_kernels,
                                        window=full)
        return da, None, None, None


def perceive_cells_dmajor_sharded(mesh, eng: CellShard, S: torch.Tensor,
                                  use_alpha: bool = True, *,
                                  use_kernels: bool = True):
    """Sharded fused perception of this rank's cells S [..., C/k, M, F] (at
    most one leading batch axis): (gA [..., C/k, M, D*F] d-major, the
    smoothed alive indicator [..., C/k, M]). Differentiable in S through gA
    (the adjoint is the sharded backward pass); the mask is detached."""
    _check(mesh, eng)
    return _PerceiveSharded.apply(S, eng, use_alpha, use_kernels)


def mask_blur_sharded(mesh, eng: CellShard, S: torch.Tensor, *,
                      use_alpha: bool = True,
                      use_kernels: bool = True) -> torch.Tensor:
    """Sharded life-mask smoothing: S [..., C/k, M, F] -> sm [..., C/k, M].
    Only the alpha lane is gathered; the kernels (2.3 / 2.6) read lane 3 of
    the window state."""
    _check(mesh, eng)
    if use_alpha:
        alpha = comm.gather_raw(S[..., 3:4].contiguous(), eng.group, dim=-3)
    else:  # alive is v > 0: nothing to exchange, the window is not read
        alpha = S.new_zeros(S.shape[:-3] + (eng.num_cells, S.shape[-2], 1))
    return PK.mask_blur(eng, F.pad(alpha, (3, 0)), use_alpha=use_alpha,
                        use_kernels=use_kernels)


def blur_sharded(mesh, eng: CellShard, X: torch.Tensor, *,
                 use_kernels: bool = True) -> torch.Tensor:
    """Sharded SPH blur over the poly6 table (kernel 2.7): X [..., C/k, M,
    K] -> [..., C/k, M, K]."""
    _check(mesh, eng)
    full = comm.gather_raw(X.contiguous(), eng.group, dim=-3)
    return PK.blur_cells(eng, full, use_kernels=use_kernels)
