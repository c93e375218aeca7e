"""Carry update-MLP weights and fixed-K graphs from the JAX package across to
the port.

The JAX ``MLPParams`` and the port's share one layout ([in, out] weights), so
the four arrays (as numpy, e.g. ``np.asarray(jax_params.w1)``) move over as
they are. The JAX ``NeighborList`` and ``SPHGraph`` share the port's fields
and layouts too (int32 indices, bool lanes, float32 weights). Tests use this
to feed both packages the same weights and the very same neighbour lanes.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import resolve_device
from ..models.nca import MLPParams
from ..ops.hashgrid import NeighborList, SPHGraph


def params_from_jax_numpy(w1, b1, w2, b2, device="cuda") -> MLPParams:
    """numpy w1 [3C, H], b1 [H], w2 [H, out], b2 [out] -> float32
    MLPParams on ``device``."""
    dev = resolve_device(device)
    w1, b1, w2, b2 = (np.asarray(a, np.float32) for a in (w1, b1, w2, b2))
    if (w1.ndim != 2 or w2.ndim != 2 or b1.shape != (w1.shape[1],)
            or w2.shape[0] != w1.shape[1] or b2.shape != (w2.shape[1],)):
        raise ValueError(
            f"inconsistent MLP shapes: w1 {w1.shape}, b1 {b1.shape}, "
            f"w2 {w2.shape}, b2 {b2.shape}"
        )
    return MLPParams(*(torch.tensor(a, device=dev) for a in (w1, b1, w2, b2)))


def _idx_valid(idx, valid, dev):
    idx, valid = np.asarray(idx, np.int32), np.asarray(valid, bool)
    if idx.ndim != 2 or valid.shape != idx.shape:
        raise ValueError(f"inconsistent lanes: idx {idx.shape}, valid "
                         f"{valid.shape}")
    return torch.tensor(idx, device=dev), torch.tensor(valid, device=dev)


def neighbor_list_from_jax_numpy(idx, valid, num_dropped,
                                 device="cuda") -> NeighborList:
    """A JAX ``NeighborList``'s arrays (numpy idx [N, K], valid [N, K],
    num_dropped []) -> the port's on ``device``."""
    dev = resolve_device(device)
    idx, valid = _idx_valid(idx, valid, dev)
    return NeighborList(idx=idx, valid=valid, num_dropped=torch.tensor(
        int(num_dropped), dtype=torch.int32, device=dev))


def graph_from_jax_numpy(idx, valid, v, wv, gv, gv_sum,
                         device="cuda") -> SPHGraph:
    """A JAX ``SPHGraph``'s arrays (numpy idx, valid [N, K], v [N], wv
    [N, K], gv [N, K, D], gv_sum [N, D]) -> the port's on ``device``, its
    weights in their own float dtype."""
    dev = resolve_device(device)
    idx, valid = _idx_valid(idx, valid, dev)
    v, wv, gv, gv_sum = (torch.tensor(np.asarray(a), device=dev)
                         for a in (v, wv, gv, gv_sum))
    n, k = idx.shape
    if (v.shape != (n,) or wv.shape != (n, k) or gv.shape[:2] != (n, k)
            or gv_sum.shape != (n, gv.shape[2])):
        raise ValueError(f"inconsistent graph: idx {tuple(idx.shape)}, v "
                         f"{tuple(v.shape)}, wv {tuple(wv.shape)}, gv "
                         f"{tuple(gv.shape)}, gv_sum {tuple(gv_sum.shape)}")
    return SPHGraph(idx=idx, valid=valid, v=v, wv=wv, gv=gv, gv_sum=gv_sum)
