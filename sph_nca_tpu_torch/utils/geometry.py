"""Regular particle grids and differentiable grid sampling (counterpart of
``grange``, ``bilinear_sample`` and ``trilinear_sample`` in
``sph_nca_tpu/utils/geometry.py``)."""

from __future__ import annotations

import itertools
from typing import Sequence

import torch


def grange(gshape: Sequence[int], gmin, gsize, grid_offset: float = 0.5,
           device="cpu") -> torch.Tensor:
    """Regular grid of particle positions, shape [*gshape, D], float32:
    pos = gmin + gsize * (index + grid_offset) / gshape.

    On the CPU unless ``device`` says otherwise: the grid feeds the engines'
    builds, which run on the host (the cell and band builds take host
    positions and put their tables on the card), so this is not a device
    entry point."""
    gmin = torch.as_tensor(gmin, dtype=torch.float32, device=device)
    gsize = torch.as_tensor(gsize, dtype=torch.float32, device=device)
    axes = [torch.arange(s, dtype=torch.float32, device=device)
            for s in gshape]
    idx = torch.stack(torch.meshgrid(*axes, indexing="ij"), dim=-1)
    shape = torch.as_tensor(gshape, dtype=torch.float32, device=device)
    return gmin + gsize * (idx + grid_offset) / shape


def _linear_sample(p: torch.Tensor, grid: torch.Tensor, gmin, gsize, d: int,
                   grid_center_offset: float) -> torch.Tensor:
    """n-linear interpolation for d in {2, 3}: p [P, d] sample positions,
    grid [g0..g_{d-1}, *value] -> [P, *value]. Out-of-range corners are
    clamped to the edge. Differentiable in p and grid."""
    gmin = torch.as_tensor(gmin, dtype=p.dtype, device=p.device)
    gsize = torch.as_tensor(gsize, dtype=p.dtype, device=p.device)
    gshape = torch.tensor(grid.shape[:d], dtype=p.dtype, device=p.device)
    hi = torch.tensor(grid.shape[:d], device=p.device) - 1
    cell = gsize / gshape

    gp = (p - gmin) / cell  # grid-space position in [0, g)
    gi = torch.floor(gp - grid_center_offset).to(torch.int64)

    value_dims = grid.dim() - d
    out = 0.0
    for offset in itertools.product((0, 1), repeat=d):
        ogi = gi + torch.tensor(offset, device=p.device)
        # weight = prod_d (1 - |gp - (ogi + center_offset)|)
        w = torch.prod(1.0 - torch.abs(gp - (ogi + grid_center_offset)),
                       dim=-1)
        cgi = torch.minimum(torch.clamp(ogi, min=0), hi)
        gv = grid[tuple(cgi[..., i] for i in range(d))]  # [P, *value]
        out = out + w[(...,) + (None,) * value_dims] * gv
    return out


def bilinear_sample(p: torch.Tensor, grid: torch.Tensor, gmin, gsize,
                    grid_center_offset: float = 0.5) -> torch.Tensor:
    """Sample a 2D grid of values at positions p [P, 2] -> [P, *value]."""
    return _linear_sample(p, grid, gmin, gsize, 2, grid_center_offset)


def trilinear_sample(p: torch.Tensor, grid: torch.Tensor, gmin, gsize,
                     grid_center_offset: float = 0.5) -> torch.Tensor:
    """Sample a 3D grid of values at positions p [P, 3] -> [P, *value]."""
    return _linear_sample(p, grid, gmin, gsize, 3, grid_center_offset)
