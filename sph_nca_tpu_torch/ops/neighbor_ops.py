"""SPH operators over fixed-K neighbour lists.

Counterpart of ``sph_nca_tpu/ops/neighbor_ops.py``. Two tiers:

  * ``volume / gradient / divergence / blur / count (x, ..., nl)``: general
    ops that recompute the kernel weights from the positions of one cloud,
    differentiable in ``x`` and ``A`` through autograd (the gather form's
    adjoint);
  * ``graph_gradient / graph_blur / graph_divergence (g, A)`` and the
    pre-gathered forms: the rollout path over an ``SPHGraph`` of precomputed
    edge weights (positions are constants of a rollout), differentiable in
    ``A``.

The graph ops take one cloud [N, C] or a batch [B, N, C] on the one graph
(the JAX package vmaps them). A batch is contracted as lanes: the state
[B, N, C] is laid out once as [N, B*C], gathered once to [N, K, B*C], and
each row's neighbourhood is one small product (``torch.bmm``) with its
edge weights. The products are float32 on float32 inputs: keep TF32 off on
the card, as the entry points do.

Every neighbour gather goes through ``ops.gather.gather_rows``, whose
backward sums each source row's gradient rows in a fixed order over a reverse
map of the list, built once per graph on its first backward (``ops/
gather.py``). PyTorch's own backward of ``X[idx]`` (a sort-based
``index_put_``) took 304 ms a call at the train CLI's shapes on an H100, and
``index_add_`` (2.4 ms) adds atomically, so two runs of one seed parted in the
last bits (``chip_smoke.py`` [graph-train], PERF.md).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import kernels as K
from .gather import gather_rows
from .hashgrid import NeighborList, SPHGraph, minimum_image


def _pair_geometry(x: torch.Tensor, nl: NeighborList, period):
    r = minimum_image(gather_rows(x, nl.idx) - x[:, None, :], period)
    return r, torch.sum(r * r, dim=-1)  # [N, K, D], [N, K]


def _vj(v, nl):
    return gather_rows(v, nl.idx) * nl.valid  # [N, K]


def volume(x: torch.Tensor, h, nl: NeighborList, *,
           smoothing: str = K.DEFAULT_SMOOTHING, period=None) -> torch.Tensor:
    """v_i = 1 / (sigma_W sum_j W(r_ij)), [N]."""
    kern = K.get_smoothing_kernel(smoothing)
    _, d2 = _pair_geometry(x, nl, period)
    w = torch.where(nl.valid, kern.w(d2, h), torch.zeros_like(d2))
    return 1.0 / (kern.norm(h, x.shape[-1]) * torch.sum(w, dim=-1))


def _gv(x, v, h, nl, gradient_kernel, period):
    kern = K.get_gradient_kernel(gradient_kernel)
    r, _ = _pair_geometry(x, nl, period)
    gk = torch.where(nl.valid[..., None], kern.grad(r, h),
                     torch.zeros_like(r))
    return kern.norm(h, x.shape[-1]), gk * _vj(v, nl)[..., None]


def gradient(x: torch.Tensor, v: torch.Tensor, A: torch.Tensor, h,
             nl: NeighborList, *, gradient_kernel: str = K.DEFAULT_GRADIENT,
             period=None) -> torch.Tensor:
    """GA_i = sigma_g sum_j (A_j - A_i) gk(r_ij) v_j: [N, F] -> [N, F, D]."""
    norm, gv = _gv(x, v, h, nl, gradient_kernel, period)
    dA = gather_rows(A, nl.idx) - A[:, None, :]  # [N, K, F]
    return norm * torch.einsum("nkf,nkd->nfd", dA, gv)


def divergence(x: torch.Tensor, v: torch.Tensor, A: torch.Tensor, h,
               nl: NeighborList, *, gradient_kernel: str = K.DEFAULT_GRADIENT,
               period=None) -> torch.Tensor:
    """DA_i = sigma_g sum_j v_j (A_j - A_i) . gk: [N, F, D] -> [N, F]."""
    norm, gv = _gv(x, v, h, nl, gradient_kernel, period)
    dA = gather_rows(A, nl.idx) - A[:, None, :, :]  # [N, K, F, D]
    return norm * torch.einsum("nkfd,nkd->nf", dA, gv)


def blur(x: torch.Tensor, v: torch.Tensor, A: torch.Tensor, h,
         nl: NeighborList, *, smoothing: str = K.DEFAULT_SMOOTHING,
         period=None) -> torch.Tensor:
    """SA_i = sigma_W sum_j A_j W(r_ij) v_j: [N, F] -> [N, F]."""
    kern = K.get_smoothing_kernel(smoothing)
    _, d2 = _pair_geometry(x, nl, period)
    wv = torch.where(nl.valid, kern.w(d2, h), torch.zeros_like(d2)) * _vj(
        v, nl)
    return kern.norm(h, x.shape[-1]) * torch.einsum(
        "nk,nkf->nf", wv, gather_rows(A, nl.idx))


def count(x: torch.Tensor, h, nl: NeighborList, *,
          period=None) -> torch.Tensor:
    """Neighbour count within h (self included), [N] int32."""
    _, d2 = _pair_geometry(x, nl, period)
    return torch.sum(nl.valid & (d2 < h * h), dim=-1).to(torch.int32)


# ---- the rollout path: ops over a prebuilt SPHGraph -------------------------


def to_lanes(A: torch.Tensor) -> Tuple[torch.Tensor, Optional[int]]:
    """[N, C] -> ([N, C], None); [B, N, C] -> ([N, B*C], B)."""
    if A.dim() == 2:
        return A, None
    b, n, c = A.shape
    return A.permute(1, 0, 2).reshape(n, b * c), b


def from_lanes(X: torch.Tensor, b: Optional[int]) -> torch.Tensor:
    """[N, L, ...] lanes back to [N, C, ...] (b None) or [B, N, C, ...]."""
    if b is None:
        return X
    n, lanes = X.shape[:2]
    return X.reshape(n, b, lanes // b, *X.shape[2:]).transpose(0, 1)


def gradient_lanes(g: SPHGraph, X: torch.Tensor,
                   Xj: torch.Tensor) -> torch.Tensor:
    """sum_j X_j gv_ij - X_i gv_sum_i on lanes: X [N, L], its gather Xj
    [N, K, L] -> [N, L, D]."""
    ga = torch.bmm(Xj.transpose(1, 2), g.gv)
    return ga - X[:, :, None] * g.gv_sum[:, None, :]


def blur_lanes(g: SPHGraph, Xj: torch.Tensor) -> torch.Tensor:
    """sum_j wv_ij X_j on lanes: Xj [N, K, L] -> [N, L]."""
    return torch.bmm(g.wv[:, None, :], Xj)[:, 0]


def graph_gradient(g: SPHGraph, A: torch.Tensor) -> torch.Tensor:
    """[..., N, F] -> [..., N, F, D] from the precomputed gv; the NCA's
    perception (sum_j A_j gv_ij - A_i gv_sum_i)."""
    X, b = to_lanes(A)
    return from_lanes(gradient_lanes(g, X, gather_rows(X, g.idx)), b)


def graph_blur(g: SPHGraph, A: torch.Tensor) -> torch.Tensor:
    """[..., N, F] -> [..., N, F] from the precomputed wv."""
    X, b = to_lanes(A)
    return from_lanes(blur_lanes(g, gather_rows(X, g.idx)), b)


def gather_neighbors(g: SPHGraph, A: torch.Tensor) -> torch.Tensor:
    """The neighbour gather of A: [..., N, C] -> [..., N, K, C]."""
    if A.dim() == 2:
        return gather_rows(A, g.idx)
    return gather_rows(A.transpose(0, 1), g.idx).permute(2, 0, 1, 3)


def graph_gradient_from(g: SPHGraph, A: torch.Tensor,
                        Aj: torch.Tensor) -> torch.Tensor:
    """``graph_gradient`` from a pre-gathered Aj = gather_neighbors(g, A)."""
    ga = torch.einsum("...nkf,nkd->...nfd", Aj, g.gv)
    return ga - A[..., None] * g.gv_sum[:, None, :]


def graph_blur_from(g: SPHGraph, Aj: torch.Tensor) -> torch.Tensor:
    """``graph_blur`` from a pre-gathered Aj [..., N, K, C]."""
    return torch.einsum("nk,...nkf->...nf", g.wv, Aj)


def graph_divergence(g: SPHGraph, A: torch.Tensor) -> torch.Tensor:
    """[..., N, F, D] -> [..., N, F] from the precomputed gv."""
    Aj = gather_rows(A.transpose(0, -3), g.idx)  # [N, K, F|B, ...]
    if A.dim() == 4:
        Aj = Aj.permute(2, 0, 1, 3, 4)  # [B, N, K, F, D]
    da = torch.einsum("...nkfd,nkd->...nf", Aj, g.gv)
    return da - torch.einsum("...nfd,nd->...nf", A, g.gv_sum)
