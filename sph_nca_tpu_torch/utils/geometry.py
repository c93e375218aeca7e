"""Regular particle grids (counterpart of ``grange`` in
``sph_nca_tpu/utils/geometry.py``)."""

from __future__ import annotations

from typing import Sequence

import torch


def grange(gshape: Sequence[int], gmin, gsize, grid_offset: float = 0.5,
           device="cpu") -> torch.Tensor:
    """Regular grid of particle positions, shape [*gshape, D], float32:
    pos = gmin + gsize * (index + grid_offset) / gshape."""
    gmin = torch.as_tensor(gmin, dtype=torch.float32, device=device)
    gsize = torch.as_tensor(gsize, dtype=torch.float32, device=device)
    axes = [torch.arange(s, dtype=torch.float32, device=device)
            for s in gshape]
    idx = torch.stack(torch.meshgrid(*axes, indexing="ij"), dim=-1)
    shape = torch.as_tensor(gshape, dtype=torch.float32, device=device)
    return gmin + gsize * (idx + grid_offset) / shape
