"""Ragged-batch helpers (counterpart of ``sph_nca_tpu/utils/batching.py``).

The port batches dense [B, N, ...] tensors; these helpers keep the
reference's pack / sections convention and pad genuinely ragged point clouds
to one shape with a mask. ``pack`` and ``unpack`` take tensors (``unpack``
returns views of ``packed``); ``pad_ragged`` takes and returns numpy arrays,
as the JAX package's does.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch


def pack(*xx: torch.Tensor) -> Tuple[torch.Tensor, List[int]]:
    """Concatenate along axis 0 -> (packed, sections)."""
    packed = torch.cat([torch.as_tensor(x) for x in xx], dim=0)
    return packed, [int(x.shape[0]) for x in xx]


def unpack(packed: torch.Tensor,
           sections: Sequence[int]) -> List[torch.Tensor]:
    """Split a packed tensor back into its sections."""
    out = []
    start = 0
    for s in sections:
        out.append(packed[start:start + s])
        start += s
    return out


def pad_ragged(xs: Sequence[np.ndarray], pad_value: float = 0.0
               ) -> Tuple[np.ndarray, np.ndarray]:
    """Ragged list of [n_i, ...] -> dense [B, N_max, ...] (the first
    array's dtype) + bool mask [B, N_max]."""
    n_max = max(x.shape[0] for x in xs)
    b = len(xs)
    out = np.full((b, n_max) + xs[0].shape[1:], pad_value, xs[0].dtype)
    mask = np.zeros((b, n_max), bool)
    for i, x in enumerate(xs):
        out[i, :x.shape[0]] = x
        mask[i, :x.shape[0]] = True
    return out, mask
