"""SPH smoothing / gradient kernel functions (poly6 and spiky).

Counterpart of ``sph_nca_tpu/ops/kernels.py``. Elementwise over arbitrary
leading batch dimensions; every kernel has compact support ``h``.

Conventions (identical to the JAX package):
  * smoothing kernels return the *unnormalized* value; the per-``h``
    normalization constant is applied once by the calling op.
  * the "gradient kernel" is the spiky-kernel vector
    ``gk(r) = 3 (h-d)^2 * r / d`` for 0 < d < h (zero at d == 0 and d >= h).

The ``d2 > 0`` guards keep autograd finite at r == 0: every neighbourhood
holds the self pair.
"""

from __future__ import annotations

import math

import torch


def poly6_w(d2: torch.Tensor, h) -> torch.Tensor:
    """Unnormalized poly6 kernel, W = max(h^2 - d^2, 0)^3."""
    c = torch.clamp(h * h - d2, min=0.0)
    return c * c * c


def poly6_norm(h, dim: int) -> float:
    """Poly6 normalization sigma_W for 2D / 3D."""
    if dim == 2:
        return 4.0 / (math.pi * h**8)
    if dim == 3:
        return 315.0 / (64.0 * math.pi * h**9)
    raise NotImplementedError(f"poly6 normalization for dim={dim}")


def spiky_grad(r: torch.Tensor, h) -> torch.Tensor:
    """Spiky gradient-kernel vector ``3 (h-d)^2 * r/d`` (0 at d==0, d>=h).

    ``r``: displacement vectors ``x_j - x_i`` with shape [..., D].
    """
    d2 = torch.sum(r * r, dim=-1, keepdim=True)
    d = torch.sqrt(torch.where(d2 > 0.0, d2, torch.ones_like(d2)))
    inside = (d2 > 0.0) & (d < h)
    mag = torch.where(inside, 3.0 * (h - d) ** 2 / d, torch.zeros_like(d))
    return mag * r


def spiky_norm(h, dim: int) -> float:
    """Spiky-gradient normalization sigma_g for 2D / 3D."""
    if dim == 2:
        return 10.0 / (math.pi * h**5)
    if dim == 3:
        return 15.0 / (math.pi * h**6)
    raise NotImplementedError(f"spiky normalization for dim={dim}")
