"""Seeding (counterpart of ``sph_nca_tpu/utils/seeds.py``, radial seed, and
the radial surface seed of the JAX test CLI's surface mode)."""

from __future__ import annotations

from typing import Optional, Tuple

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


def surface_radial_seed(x: torch.Tensor, normals: torch.Tensor, channels: int,
                        n_seeds: int, radius: float,
                        generator: torch.Generator
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The radial seed of a surface rollout, as the JAX test CLI's surface
    mode makes it (``--initial_feature radial``): ``n_seeds`` seed points by
    farthest-point sampling from point 0, a radial seed of ``radius`` around
    each, and at each seed point a tangent orthogonal to its normal, drawn
    from a standard normal (``generator``); zero tangents elsewhere.
    x, normals [N, 3] -> (A0 [N, channels], t0 [N, 3])."""
    from ..models.surface import orthogonalize
    from .meshes import farthest_point_sampling

    A = torch.zeros((x.shape[0], channels), dtype=x.dtype, device=x.device)
    t = torch.zeros_like(normals)
    for i in farthest_point_sampling(x, n_seeds).tolist():
        A = add_radial_seed(x, A, x[i], radius)
        draw = torch.randn(3, generator=generator,
                           device=generator.device).to(x.device)
        t[i] = orthogonalize(normals[i], draw)
    return A, t
