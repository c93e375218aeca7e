"""Cell-grid helpers used by the cell-engine build.

Counterpart of the helpers of ``sph_nca_tpu/ops/hashgrid.py`` that
``ops/cells.build_cell_engine`` uses. The fixed-K neighbour-list engine is not
ported yet.
"""

from __future__ import annotations

from typing import Sequence, Tuple, Union

import numpy as np

Dims = Union[int, Sequence[int]]


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
