"""Image-mode training loss (counterpart of the MSE part of
``sph_nca_tpu/training/losses.py``).

mse:  mean((rgba - img(x))^2) + w_overflow * sum(max(|A| - 1, 0))

Every function takes states with any leading batch axes, A [..., N, C], and
reduces over the last two axes (one value per sample).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..models.nca import to_rgba
from ..utils.geometry import bilinear_sample


def overflow_penalty(A: torch.Tensor) -> torch.Tensor:
    """sum(max(|A| - 1, 0)) over all particles and channels."""
    return torch.sum(torch.clamp(A.abs() - 1.0, min=0.0), dim=(-2, -1))


def rgba_with_margin(A: torch.Tensor, use_alpha: bool,
                     margin: Optional[float]) -> torch.Tensor:
    """to_rgba with a straight-through clamp: the forward clamps to
    [-margin, 1 + margin], the backward is the identity."""
    rgba = to_rgba(A, use_alpha)
    if margin is None:
        return rgba
    clamped = torch.clamp(rgba, 0.0 - margin, 1.0 + margin)
    return rgba + (clamped - rgba).detach()


class MSELossConfig(NamedTuple):
    """Image-mode loss config."""

    gmin: tuple  # domain min, e.g. (-1, -1)
    gsize: tuple  # domain size, e.g. (2, 2)
    image_scale: float  # target_size / image_size
    overflow_weight: float = 0.05
    use_alpha: bool = True


def target_at(x: torch.Tensor, img: torch.Tensor,
              cfg: MSELossConfig) -> torch.Tensor:
    """The target image bilinearly sampled at positions x [N, 2] -> [N, 4].

    The image spans [gmin*s, gmin*s + gsize*s] (s = image_scale), so with
    s < 1 it occupies the domain's centre and positions outside sample the
    clamped edge pixels."""
    img_gmin = torch.tensor(cfg.gmin, dtype=torch.float32,
                            device=x.device) * cfg.image_scale
    img_gsize = torch.tensor(cfg.gsize, dtype=torch.float32,
                             device=x.device) * cfg.image_scale
    return bilinear_sample(x, img, img_gmin, img_gsize)


def mse_loss(x: torch.Tensor, A: torch.Tensor, img: torch.Tensor,
             cfg: MSELossConfig) -> torch.Tensor:
    """MSE against the target image sampled at the particle positions, plus
    the overflow penalty: A [..., N, C] -> [...]."""
    rgba = rgba_with_margin(A, cfg.use_alpha, margin=None)
    loss = torch.mean((rgba - target_at(x, img, cfg)) ** 2, dim=(-2, -1))
    if cfg.overflow_weight > 0:
        loss = loss + cfg.overflow_weight * overflow_penalty(A)
    return loss
