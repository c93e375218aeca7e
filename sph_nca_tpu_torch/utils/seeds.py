"""Seeding (counterpart of ``sph_nca_tpu/utils/seeds.py``, radial seed)."""

from __future__ import annotations

from typing import Optional

import torch


def radial_seed_weights(x: torch.Tensor, center: torch.Tensor,
                        radius: float) -> torch.Tensor:
    """w = clamp(1 - d^2/R^2, 0, 1)^3 around ``center``."""
    d2 = torch.sum((x - center) ** 2, dim=-1)
    w = torch.clamp(1.0 - d2 / radius**2, 0.0, 1.0)
    return w * w * w


def add_radial_seed(x: torch.Tensor, A: torch.Tensor, center, radius: float,
                    texture: Optional[torch.Tensor] = None) -> torch.Tensor:
    """A + texture * w (texture defaults to ones); returns a new tensor."""
    center = torch.as_tensor(center, dtype=x.dtype, device=x.device)
    w = radial_seed_weights(x, center, radius)
    if texture is None:
        texture = torch.ones_like(A)
    return A + texture * w[..., None]


def plane_seed(x: torch.Tensor, channels: int, *, gmin, gsize,
               radius: float) -> torch.Tensor:
    """The image-mode seed: zeros plus a radial seed at the domain centre
    (the random-feature seed is not ported yet)."""
    A = torch.zeros((x.shape[0], channels), dtype=x.dtype, device=x.device)
    center = (torch.as_tensor(gmin, dtype=x.dtype)
              + torch.as_tensor(gsize, dtype=x.dtype) / 2.0)
    return add_radial_seed(x, A, center, radius)
