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
``nca_step`` is that step on the fixed-K graph engine (``ops/hashgrid.
SPHGraph``): one cloud [N, C] or a batch [B, N, C] on one graph, the batch
contracted as lanes (``ops/neighbor_ops.py``), the update MLP in plain
float32 (``apply_mlp``). The graph path reaches no CUDA kernel of the port:
the JAX package's graph step is XLA gathers and einsums too. The cell- and
band-engine forms of the step are ``models/cell_step.py``.

The fire mask is drawn per particle (and sample) from a ``torch.Generator``:
the JAX package's Bernoulli(fire_rate) law, another stream, so trajectories
match the JAX package exactly only at fire_rate == 1.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple, Optional

import torch

from .. import resolve_device
from ..ops.hashgrid import SPHGraph
from ..ops.neighbor_ops import (
    blur_lanes,
    from_lanes,
    gather_rows,
    gradient_lanes,
    graph_blur,
    graph_gradient,
    to_lanes,
)

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


def life_mask(graph: SPHGraph, activity: torch.Tensor) -> torch.Tensor:
    """blur(activity > 0.1) > 0.1 on the graph, stop-gradient: activity
    [..., N] -> bool [..., N]."""
    m = (activity.detach() > ALIVE_THRESHOLD).to(graph.wv.dtype)[..., None]
    return graph_blur(graph, m)[..., 0] > ALIVE_THRESHOLD


# A perception transform maps the scaled gradient gA [..., N, C, D] to
# features [..., N, C, >= 2] whose components 0 and 1 feed the MLP (the
# surface mode's tangent-space projection).
PerceptionTransform = Callable[[torch.Tensor], torch.Tensor]


def perceive(cfg: SPHNCAConfig, graph: SPHGraph, A: torch.Tensor, h,
             transform: Optional[PerceptionTransform] = None
             ) -> torch.Tensor:
    """SPH-gradient perception and the feature concat [A, gA_0, gA_1]:
    [..., N, C] -> [..., N, 3C] (in 3D only the first two components of the
    possibly transformed gradient feed the MLP)."""
    return _features(cfg, A, graph_gradient(graph, A), h, transform)


def _features(cfg: SPHNCAConfig, A: torch.Tensor, gA: torch.Tensor, h,
              transform: Optional[PerceptionTransform]) -> torch.Tensor:
    """The MLP's input from the state and its raw gradient gA [..., C, D]:
    the perception scale h k, the transform, [A, gA_0, gA_1]."""
    if cfg.normalize_perception > 0:
        gA = h * gA * cfg.normalize_perception
    if transform is not None:
        gA = transform(gA)
    return torch.cat([A, gA[..., 0], gA[..., 1]], dim=-1)


def _alive_lanes(X: torch.Tensor, b: Optional[int], c: int,
                 use_alpha: bool) -> torch.Tensor:
    """(activity > 0.1) as float lanes: X [..., B*C] -> [..., B] (or
    [..., 1] for one cloud), detached; blurred, the life mask (the JAX
    package's ``_mask_blur`` on the gathered state)."""
    a = X.detach().unflatten(-1, (-1, c))
    return (cell_activity(a, use_alpha) > ALIVE_THRESHOLD).to(X.dtype)


def _graph_step(params: MLPParams, cfg: SPHNCAConfig, graph: SPHGraph,
                A: torch.Tensor, u: torch.Tensor, h, fire_rate: float,
                perception_transform=None, exchange=None) -> torch.Tensor:
    """One step given the fire draws u [..., N] (uniform in [0, 1)): the
    state is gathered once for the perception and the pre-update life mask,
    and only the alive column is gathered for the post-update mask.

    ``exchange`` maps this process's lanes [n, L] to the lanes [N, L] the
    graph's indices read (a rank's rows of a sharded graph gather every
    rank's, ``parallel/shard.py``); by default the graph holds every row."""
    c = cfg.channels
    full = exchange or (lambda t: t)
    X, b = to_lanes(A)  # [N, L]
    Xj = gather_rows(full(X), graph.idx)  # [N, K, L]
    pre = blur_lanes(graph, _alive_lanes(Xj, b, c, cfg.use_alpha))
    gA = from_lanes(gradient_lanes(graph, X, Xj), b)  # [..., N, C, D]
    dA = apply_mlp(params, _features(cfg, A, gA, h, perception_transform))

    if cfg.update_rule == "gated":
        gate = torch.sigmoid(dA[..., :c])
        delta = torch.tanh(dA[..., c:2 * c])
        mult = torch.sigmoid(dA[..., -1:])
        nA = A * gate + delta * mult
    elif cfg.update_rule == "orig":
        nA = A + dA * (cfg.fire_rate / fire_rate)
    else:
        raise ValueError(f"unknown update rule {cfg.update_rule!r}")
    nA = torch.where((u <= fire_rate)[..., None], nA, A)

    nX, _ = to_lanes(nA)
    post = blur_lanes(graph, gather_rows(
        full(_alive_lanes(nX, b, c, cfg.use_alpha)), graph.idx))
    living = (pre > ALIVE_THRESHOLD) & (post > ALIVE_THRESHOLD)  # [N, B|1]
    living = living[:, 0] if b is None else living.T
    return nA * living[..., None].to(nA.dtype)


def nca_step(params: MLPParams, cfg: SPHNCAConfig, graph: SPHGraph,
             A: torch.Tensor, generator: torch.Generator, h,
             fire_rate: Optional[float] = None,
             perception_transform: Optional[PerceptionTransform] = None
             ) -> torch.Tensor:
    """One NCA step on the graph engine: A [N, C] or [B, N, C] -> the same
    shape, with a fire draw per particle (and sample) from ``generator``.
    Differentiable in A and the parameters; the life masks are
    stop-gradient."""
    if fire_rate is None:
        fire_rate = cfg.fire_rate
    u = torch.rand(A.shape[:-1], generator=generator, device=A.device)
    return _graph_step(params, cfg, graph, A, u, h, fire_rate,
                       perception_transform)
