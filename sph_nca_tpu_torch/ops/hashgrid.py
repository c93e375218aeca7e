"""The fixed-K neighbour engine: periodic cell hash -> fixed-K neighbour lists
-> an ``SPHGraph`` of precomputed edge weights; and the cell-grid helpers
that ``ops/cells.build_cell_engine`` uses.

Counterpart of ``sph_nca_tpu/ops/hashgrid.py``. The build runs on the device
of the positions, as torch ops:

  1. per-axis cell indices floor(x / h) mod dims (a periodic hash: aliased
     cells share one slot pool, and every op re-checks |r| < h);
  2. one stable ``argsort`` over the flattened cell ids and ``searchsorted``
     cell boundaries;
  3. per block of ``chunk`` particles, the candidates of the 3^D stencil
     cells (at most ``max_per_cell`` a cell), their minimum-image
     distances, and the ``k`` nearest within h.

Step 3 takes the k smallest keys (d^2, +inf for a candidate that is not a
neighbour) by a stable sort, so ties go to the lower candidate lane, as
``jax.lax.top_k`` breaks them: the lists equal the JAX package's lane for
lane whenever the positions hash alike. Nothing downstream depends on the
lane order. ``num_dropped`` counts the neighbours within h that did not fit
(an over-full cell or more than k neighbours); 0 means the list is exact.
Indices are stored as int32, as the JAX package stores them.

``suggest_capacity`` sizes the build from the native grid analyzer
(``native.capacity``, exact counts on the host); there is no numpy fallback:
a failed g++ build raises. ``build_graph`` retries with 1.5x capacities until
the list is exact (``exact=True``).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from . import kernels as K

Dims = Union[int, Sequence[int]]


def default_dims(h: float, extent: float = 2.0) -> int:
    """Cells per axis, as the CLIs compute it: ceil(extent / h)."""
    return math.ceil(extent / h)


def _dims_tuple(dims: Dims, d: int) -> Tuple[int, ...]:
    if isinstance(dims, int):
        dims = (dims,) * d
    dims = tuple(int(x) for x in dims)
    if len(dims) != d:
        raise ValueError(f"dims {dims} does not match point dimension {d}")
    if any(x < 3 for x in dims):
        # with fewer than 3 cells per axis the 3^D stencil would visit the
        # same cell twice and double-count pairs
        raise ValueError(f"need at least 3 cells per axis, got {dims}")
    return dims


def _strides(dims: Tuple[int, ...]) -> np.ndarray:
    """Flattening strides c_d with hash = sum_d cell_d * c_d."""
    out = np.ones(len(dims), dtype=np.int32)
    for i in range(1, len(dims)):
        out[i] = out[i - 1] * dims[i - 1]
    return out


def _stencil_offsets(d: int) -> np.ndarray:
    """All 3^D offsets in {-1, 0, 1}^D, shape [3^D, D]."""
    grids = np.meshgrid(*([np.array([-1, 0, 1])] * d), indexing="ij")
    return np.stack([g.ravel() for g in grids], axis=-1).astype(np.int32)


def _period(period, x: torch.Tensor) -> Optional[torch.Tensor]:
    if period is None:
        return None
    return torch.as_tensor(period, dtype=x.dtype, device=x.device)


def cell_index(x: torch.Tensor, h, dims: Tuple[int, ...]) -> torch.Tensor:
    """Per-axis periodic cell index floor(x / h) mod dims, [N, D] int64
    (``remainder``, not ``fmod``: coordinates are negative)."""
    dims_t = torch.tensor(dims, dtype=torch.int64, device=x.device)
    return torch.remainder(torch.floor(x / h).to(torch.int64), dims_t)


class NeighborList(NamedTuple):
    """Fixed-size neighbourhoods.

    idx:   [N, K] int32 neighbour indices (self included); lanes with
           ``valid == False`` hold 0.
    valid: [N, K] bool, which lanes are real neighbours (|r| < h).
    num_dropped: [] int32, neighbours within h that did not fit in K (0: the
           list is exact).
    """

    idx: torch.Tensor
    valid: torch.Tensor
    num_dropped: torch.Tensor

    @property
    def k(self) -> int:
        return self.idx.shape[-1]


def minimum_image(r: torch.Tensor, period) -> torch.Tensor:
    """Minimum-image displacement for periodic domains (no-op without a
    period); ``torch.round`` rounds half to even, as ``jnp.round``."""
    if period is None:
        return r
    period = _period(period, r)
    return r - torch.round(r / period) * period


def build_neighbor_list(
    x: torch.Tensor,
    h,
    dims: Dims,
    *,
    max_per_cell: int,
    k: int,
    period=None,
    chunk: int = 4096,
) -> NeighborList:
    """Fixed-K neighbour lists of the points ``x`` [N, D], built on x's
    device.

    ``max_per_cell`` (the slots read from each hash cell; aliased cells share
    them) and ``k`` (the neighbour budget) fix every shape; the candidates
    are processed ``chunk`` particles at a time, so the [chunk, 3^D *
    max_per_cell] candidate tensors stay small. Exactness is checked after
    the fact: ``num_dropped == 0``. It counts real particles only (the JAX
    build also counts its padding rows, phantom particles at the origin,
    when N is not a multiple of ``chunk``).
    """
    if not torch.is_tensor(x):
        raise TypeError("build_neighbor_list takes a torch tensor; its "
                        "device is the build's")
    n, d = x.shape
    dims = _dims_tuple(dims, d)
    mpc, k, chunk = int(max_per_cell), int(k), max(int(chunk), 1)
    num_stencil = 3**d
    if k > num_stencil * mpc:
        raise ValueError(f"k={k} exceeds the {num_stencil * mpc} candidates "
                         f"of {num_stencil} cells x max_per_cell={mpc}")
    dev = x.device
    per = _period(period, x)
    h = float(h)
    strides = torch.from_numpy(_strides(dims).astype(np.int64)).to(dev)
    dims_t = torch.tensor(dims, dtype=torch.int64, device=dev)

    ci = cell_index(x, h, dims)  # [N, D]
    cell = (ci * strides).sum(-1)  # [N]
    order = torch.argsort(cell, stable=True)
    cell_sorted = cell[order]
    cell_ids = torch.arange(int(np.prod(dims)), dtype=torch.int64, device=dev)
    starts = torch.searchsorted(cell_sorted, cell_ids, side="left")
    counts = torch.searchsorted(cell_sorted, cell_ids, side="right") - starts
    dropped = torch.clamp(counts - mpc, min=0).sum()

    offsets = torch.from_numpy(_stencil_offsets(d).astype(np.int64)).to(dev)
    slot = torch.arange(mpc, dtype=torch.int64, device=dev)
    idx = torch.empty((n, k), dtype=torch.int32, device=dev)
    valid = torch.empty((n, k), dtype=torch.bool, device=dev)
    for s in range(0, n, chunk):
        ci_b, x_b = ci[s:s + chunk], x[s:s + chunk]
        b = ci_b.shape[0]
        ncell = (torch.remainder(ci_b[:, None, :] + offsets, dims_t)
                 * strides).sum(-1)  # [B, S]
        cand_pos = starts[ncell][:, :, None] + slot  # [B, S, M]
        in_cell = (slot < counts[ncell][:, :, None]).reshape(b, -1)
        cand_idx = order[torch.clamp(cand_pos, 0, n - 1)].reshape(b, -1)
        r = minimum_image(x[cand_idx] - x_b[:, None, :], per)
        d2 = torch.sum(r * r, dim=-1)
        cand_valid = in_cell & (d2 < h * h)
        key = torch.where(cand_valid, d2, torch.full_like(d2, math.inf))
        sel = torch.sort(key, dim=1, stable=True).indices[:, :k]
        v_b = torch.gather(cand_valid, 1, sel)
        i_b = torch.gather(cand_idx, 1, sel)
        idx[s:s + b] = torch.where(v_b, i_b, torch.zeros_like(i_b))
        valid[s:s + b] = v_b
        dropped = dropped + (cand_valid.sum() - v_b.sum())
    return NeighborList(idx=idx, valid=valid,
                        num_dropped=dropped.to(torch.int32))


def suggest_capacity(
    x,
    h,
    dims: Dims,
    *,
    period=None,
    slack: float = 1.25,
    align: int = 8,
) -> Tuple[int, int]:
    """(max_per_cell, k) for concrete positions: the exact max hash-cell
    occupancy and max neighbour count (``native.capacity``, on the host),
    each padded by ``slack`` and rounded up to a multiple of ``align``."""
    from .. import native

    if torch.is_tensor(x):
        x = x.detach().cpu().numpy()
    x = np.asarray(x)
    dims = _dims_tuple(dims, x.shape[1])
    max_occ, max_nbrs = native.capacity(x, float(h), dims, period=period)

    def pad(v: int) -> int:
        v = int(math.ceil(v * slack))
        return ((v + align - 1) // align) * align

    return pad(max_occ), pad(max_nbrs)


class SPHGraph(NamedTuple):
    """Static-geometry SPH graph with precomputed edge weights (positions are
    constants of a rollout, so every per-step op is gathers and sums).

    idx:    [N, K] int32 neighbour indices
    valid:  [N, K] bool
    v:      [N]       particle volumes
    wv:     [N, K]    sigma_W * W(r_ij) * v_j          (blur weights)
    gv:     [N, K, D] sigma_g * gk(r_ij) * v_j         (gradient weights)
    gv_sum: [N, D]    sum_k gv (the gradient's self term)
    """

    idx: torch.Tensor
    valid: torch.Tensor
    v: torch.Tensor
    wv: torch.Tensor
    gv: torch.Tensor
    gv_sum: torch.Tensor

    @property
    def n(self) -> int:
        return self.idx.shape[0]

    @property
    def k(self) -> int:
        return self.idx.shape[-1]

    @property
    def device(self) -> torch.device:
        return self.idx.device

    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in self)


def build_graph(
    x: torch.Tensor,
    h,
    dims: Dims,
    *,
    max_per_cell: int,
    k: int,
    period=None,
    smoothing: str = K.DEFAULT_SMOOTHING,
    gradient_kernel: str = K.DEFAULT_GRADIENT,
    exact: bool = True,
) -> SPHGraph:
    """Neighbour lists, volumes and edge weights for ``x`` on x's device.

    With ``exact`` (the default), a list that dropped a neighbour is built
    again at 1.5x both capacities (rounded up to 8) until it is exact;
    ``exact=False`` keeps a deliberately undersized K.
    """
    nl = build_neighbor_list(x, h, dims, max_per_cell=max_per_cell, k=k,
                             period=period)
    if exact:
        while int(nl.num_dropped) > 0:
            max_per_cell = int(math.ceil(max_per_cell * 1.5 / 8)) * 8
            k = int(math.ceil(k * 1.5 / 8)) * 8
            nl = build_neighbor_list(x, h, dims, max_per_cell=max_per_cell,
                                     k=k, period=period)
    return graph_from_neighbor_list(x, h, nl, period=period,
                                    smoothing=smoothing,
                                    gradient_kernel=gradient_kernel)


def graph_from_neighbor_list(
    x: torch.Tensor,
    h,
    nl: NeighborList,
    *,
    period=None,
    smoothing: str = K.DEFAULT_SMOOTHING,
    gradient_kernel: str = K.DEFAULT_GRADIENT,
) -> SPHGraph:
    """The ``SPHGraph`` of a neighbour list: v_i = 1 / (sigma_W sum_j W),
    wv = sigma_W W v_j, gv = sigma_g gk v_j on the valid lanes (0 else), in
    x's dtype."""
    dim = x.shape[-1]
    skern = K.get_smoothing_kernel(smoothing)
    gkern = K.get_gradient_kernel(gradient_kernel)
    valid = nl.valid
    r = minimum_image(x[nl.idx] - x[:, None, :], period)  # [N, K, D]
    d2 = torch.sum(r * r, dim=-1)
    w = torch.where(valid, skern.w(d2, h), torch.zeros_like(d2))
    v = 1.0 / (skern.norm(h, dim) * torch.sum(w, dim=-1))
    vj = v[nl.idx] * valid
    wv = skern.norm(h, dim) * w * vj
    gk = torch.where(valid[..., None], gkern.grad(r, h), torch.zeros_like(r))
    gv = gkern.norm(h, dim) * gk * vj[..., None]
    return SPHGraph(idx=nl.idx, valid=valid, v=v, wv=wv, gv=gv,
                    gv_sum=torch.sum(gv, dim=1))
