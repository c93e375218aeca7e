"""SPHNCA model pieces: config, update-MLP parameters and the MLP.

Counterpart of ``sph_nca_tpu/models/nca.py``. One NCA step:
    activity   = A[..., 3]                      (or ones if not use_alpha)
    prev_mask  = blur(activity > 0.1) > 0.1
    gA         = sph_gradient(A)                 # perception
    gA         = h * k * gA                      (if normalize_perception k>0)
    y          = concat[A, gA_x, gA_y]           # 3C features
    dA         = Linear(3C->hidden) -> ReLU -> Linear(hidden->out)
    gated:     nA = A * sig(dA[:C]) + tanh(dA[C:2C]) * sig(dA[-1:])
    orig:      nA = A + dA * fire_rate0 / fire_rate
    nA         = where(U(0,1) <= fire_rate, nA, A)   # stochastic update
    new_mask   = blur(activity(nA) > 0.1) > 0.1
    nA        *= prev_mask & new_mask
The cell- and band-engine forms of the step are ``models/cell_step.py``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from .. import resolve_device

DEFAULT_CHANNELS = 16
DEFAULT_HIDDEN = 256
ALIVE_THRESHOLD = 0.1


@dataclasses.dataclass(frozen=True)
class SPHNCAConfig:
    """Static model configuration."""

    channels: int = DEFAULT_CHANNELS
    hidden: int = DEFAULT_HIDDEN
    fire_rate: float = 0.5
    update_rule: str = "gated"  # 'gated' | 'orig'
    use_alpha: bool = True
    # k in gA <- h * gA * k; <= 0 disables
    normalize_perception: float = -1.0
    # SPH smoothing kernel name: the band engine takes poly6, wendlandC2 and
    # wendlandC4; the cell engine implements poly6 only
    smoothing: str = "poly6"

    @property
    def in_features(self) -> int:
        return 3 * self.channels

    @property
    def out_features(self) -> int:
        if self.update_rule == "gated":
            return 2 * self.channels + 1
        if self.update_rule == "orig":
            return self.channels
        raise ValueError(f"unknown update rule {self.update_rule!r}")


class MLPParams(NamedTuple):
    """Two-layer update MLP, weights stored [in, out]."""

    w1: torch.Tensor  # [3C, H]
    b1: torch.Tensor  # [H]
    w2: torch.Tensor  # [H, out]
    b2: torch.Tensor  # [out]


def init_params(cfg: SPHNCAConfig, generator: torch.Generator,
                device="cuda") -> MLPParams:
    """Initialize like torch.nn.Linear: every weight and bias
    U(-1/sqrt(fan_in), 1/sqrt(fan_in)); the 'orig' rule zero-inits the last
    layer. Drawn from ``generator`` (on its own device), then moved to
    ``device``."""
    device = resolve_device(device)
    fi, hid, out = cfg.in_features, cfg.hidden, cfg.out_features

    def uniform(shape, fan_in):
        bound = 1.0 / math.sqrt(fan_in)
        u = torch.rand(shape, generator=generator,
                       device=generator.device)
        return (u * (2.0 * bound) - bound).to(device)

    p = MLPParams(
        w1=uniform((fi, hid), fi),
        b1=uniform((hid,), fi),
        w2=uniform((hid, out), hid),
        b2=uniform((out,), hid),
    )
    if cfg.update_rule == "orig":
        p = p._replace(w2=torch.zeros_like(p.w2), b2=torch.zeros_like(p.b2))
    return p


def num_params(p: MLPParams) -> int:
    return sum(t.numel() for t in p)


def apply_mlp(p: MLPParams, y: torch.Tensor) -> torch.Tensor:
    """y [N, 3C] -> dA [N, out]: two fp32 GEMMs + ReLU.

    Plain ``torch.matmul`` (the JAX package leaves this product to XLA
    outside any Pallas kernel). Entry points keep TF32 off, so on the GPU the
    products run in full fp32.
    """
    hid = torch.relu(torch.matmul(y, p.w1) + p.b1)
    return torch.matmul(hid, p.w2) + p.b2


def cell_activity(A: torch.Tensor, use_alpha: bool = True) -> torch.Tensor:
    """Alpha channel as activity."""
    if use_alpha:
        return A[..., 3]
    return torch.ones_like(A[..., 3])


def to_rgba(A: torch.Tensor, use_alpha: bool = True) -> torch.Tensor:
    """rgb = A[..., :3], a = activity."""
    return torch.cat([A[..., :3], cell_activity(A, use_alpha)[..., None]],
                     dim=-1)
