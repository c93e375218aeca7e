"""SPH smoothing / gradient kernel functions and their registry.

Counterpart of ``sph_nca_tpu/ops/kernels.py``: the smoothing kernels poly6,
Wendland C2 and Wendland C4, the spiky gradient kernel, and the lookup
``get_smoothing_kernel`` / ``get_gradient_kernel``. Elementwise over
arbitrary leading batch dimensions; every kernel has compact support ``h``.
The cell engine's pair kernels run poly6 / spiky only; the band engine
(``ops/bands.py``) takes every registered smoothing kernel.

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
from typing import Callable, NamedTuple

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


def wendland_c2_w(d2: torch.Tensor, h) -> torch.Tensor:
    """Unnormalized Wendland C2 kernel, (1-q)^4 (4q+1) for q = d/h < 1,
    W(0) = 1."""
    q = torch.sqrt(torch.where(d2 > 0.0, d2, torch.ones_like(d2))) / h
    w = torch.where(q < 1.0, (1.0 - q) ** 4 * (4.0 * q + 1.0),
                    torch.zeros_like(q))
    return torch.where(d2 > 0.0, w, torch.ones_like(w))


def wendland_c2_norm(h, dim: int) -> float:
    """Wendland C2 normalization sigma_W for 2D / 3D."""
    if dim == 2:
        return 7.0 / (math.pi * h**2)
    if dim == 3:
        return 21.0 / (2.0 * math.pi * h**3)
    raise NotImplementedError(f"wendlandC2 normalization for dim={dim}")


def wendland_c4_w(d2: torch.Tensor, h) -> torch.Tensor:
    """Unnormalized Wendland C4 kernel, (1-q)^6 (35q^2+18q+3)/3 for q < 1,
    W(0) = 1."""
    q2 = d2 / (h * h)
    q = torch.sqrt(torch.where(q2 > 0.0, q2, torch.ones_like(q2)))
    w = torch.where(q < 1.0,
                    (1.0 - q) ** 6 * (35.0 * q2 + 18.0 * q + 3.0) / 3.0,
                    torch.zeros_like(q))
    return torch.where(q2 > 0.0, w, torch.ones_like(w))


def wendland_c4_norm(h, dim: int) -> float:
    """Wendland C4 normalization sigma_W for 2D / 3D."""
    if dim == 2:
        return 9.0 / (math.pi * h**2)
    if dim == 3:
        return 495.0 / (32.0 * math.pi * h**3)
    raise NotImplementedError(f"wendlandC4 normalization for dim={dim}")


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


class SmoothingKernel(NamedTuple):
    """A smoothing kernel: unnormalized W(d^2, h) and its normalization."""

    name: str
    w: Callable
    norm: Callable[[float, int], float]


class GradientKernel(NamedTuple):
    """A gradient kernel: vector gk(r, h) and its normalization."""

    name: str
    grad: Callable
    norm: Callable[[float, int], float]


_SMOOTHING_KERNELS = {
    "poly6": SmoothingKernel("poly6", poly6_w, poly6_norm),
    "wendlandC2": SmoothingKernel("wendlandC2", wendland_c2_w,
                                  wendland_c2_norm),
    "wendlandC4": SmoothingKernel("wendlandC4", wendland_c4_w,
                                  wendland_c4_norm),
}

_GRADIENT_KERNELS = {
    "spiky": GradientKernel("spiky", spiky_grad, spiky_norm),
}

DEFAULT_SMOOTHING = "poly6"
DEFAULT_GRADIENT = "spiky"


def get_smoothing_kernel(name: str = DEFAULT_SMOOTHING) -> SmoothingKernel:
    try:
        return _SMOOTHING_KERNELS[name]
    except KeyError:
        raise ValueError(
            f"unknown smoothing kernel {name!r}; "
            f"available: {sorted(_SMOOTHING_KERNELS)}") from None


def get_gradient_kernel(name: str = DEFAULT_GRADIENT) -> GradientKernel:
    try:
        return _GRADIENT_KERNELS[name]
    except KeyError:
        raise ValueError(
            f"unknown gradient kernel {name!r}; "
            f"available: {sorted(_GRADIENT_KERNELS)}") from None
