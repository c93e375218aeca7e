"""Dense O(N^2) SPH operators: every pair, no neighbour lists.

Counterpart of ``sph_nca_tpu/ops/dense.py``, the oracle that the neighbour
ops are held against (and an exact, fully differentiable path for small
clouds):

  volume     v_i  = 1 / (sigma_W * sum_j W(x_j - x_i))
  gradient   GA_i = sigma_g * sum_j (A_j - A_i) gk(x_j - x_i) v_j
  divergence DA_i = sigma_g * sum_j v_j dot(A_j - A_i, gk)
  blur       SA_i = sigma_W * sum_j A_j W(x_j - x_i) v_j
  count      c_i  = sum_j [|x_j - x_i|^2 < h^2]

Sums run over every j, i itself included. One point cloud [N, ...] a call;
``period`` gives minimum-image displacements. The contractions are float32
products on float32 inputs: keep TF32 off on the card
(``torch.backends.cuda.matmul.allow_tf32 = False``), as the entry points do.
"""

from __future__ import annotations

import torch

from . import kernels as K
from .hashgrid import minimum_image


def displacements(x: torch.Tensor, period=None) -> torch.Tensor:
    """All-pairs displacement r[i, j] = x[j] - x[i], [N, N, D]."""
    return minimum_image(x[None, :, :] - x[:, None, :], period)


def _d2(x, period):
    r = displacements(x, period)
    return torch.sum(r * r, dim=-1)


def volume(x: torch.Tensor, h: float, *,
           smoothing: str = K.DEFAULT_SMOOTHING, period=None) -> torch.Tensor:
    """Particle volume (inverse number density), [N]."""
    kern = K.get_smoothing_kernel(smoothing)
    inv_v = kern.norm(h, x.shape[-1]) * torch.sum(
        kern.w(_d2(x, period), h), dim=-1)
    return 1.0 / inv_v


def gradient(x: torch.Tensor, v: torch.Tensor, A: torch.Tensor, h: float, *,
             gradient_kernel: str = K.DEFAULT_GRADIENT,
             period=None) -> torch.Tensor:
    """SPH gradient of features A [N, F] -> [N, F, D]."""
    kern = K.get_gradient_kernel(gradient_kernel)
    gk = kern.grad(displacements(x, period), h) * v[None, :, None]
    dA = A[None, :, :] - A[:, None, :]  # [N, N, F]
    return kern.norm(h, x.shape[-1]) * torch.einsum("ijf,ijd->ifd", dA, gk)


def divergence(x: torch.Tensor, v: torch.Tensor, A: torch.Tensor, h: float,
               *, gradient_kernel: str = K.DEFAULT_GRADIENT,
               period=None) -> torch.Tensor:
    """SPH divergence of vector features A [N, F, D] -> [N, F]."""
    kern = K.get_gradient_kernel(gradient_kernel)
    gk = kern.grad(displacements(x, period), h) * v[None, :, None]
    dA = A[None, :, :, :] - A[:, None, :, :]  # [N, N, F, D]
    return kern.norm(h, x.shape[-1]) * torch.einsum("ijfd,ijd->if", dA, gk)


def blur(x: torch.Tensor, v: torch.Tensor, A: torch.Tensor, h: float, *,
         smoothing: str = K.DEFAULT_SMOOTHING, period=None) -> torch.Tensor:
    """SPH smoothing of A [N, F] -> [N, F]."""
    kern = K.get_smoothing_kernel(smoothing)
    wv = kern.w(_d2(x, period), h) * v[None, :]  # [N, N]
    return kern.norm(h, x.shape[-1]) * torch.matmul(wv, A)


def count(x: torch.Tensor, h: float, *, period=None) -> torch.Tensor:
    """Neighbour count within h (self included), [N] int32."""
    return torch.sum(_d2(x, period) < h * h, dim=-1).to(torch.int32)
