"""The JAX trainer's optimizers, written as optax 0.2.6 defines them
(counterpart of ``_OPTIMIZERS`` and ``make_optimizer`` in
``sph_nca_tpu/training/trainer.py``).

Each sits in optax's chain after the gradient normalization and before the
learning rate of the linear schedule (``scale_by_learning_rate``, applied
here as ``p -= lr * u`` with the schedule's lr in ``param_groups``). The
update directions u, with optax's defaults (which are not torch.optim's):

  adam     ``torch.optim.Adam``: m / (sqrt(v) + 1e-8), bias-corrected
  adamw    Adam's direction + 1e-4 p (the decay added before the lr)
  sgd      g
  rmsprop  nu = 0.9 nu + 0.1 g^2 from 0; u = g / sqrt(nu + 1e-8) (eps inside
           the root, no bias correction, no momentum)
  adagrad  s = s + g^2 from 0.1; u = g / sqrt(s + 1e-7) where s > 0, else 0
  lion     u = sign(0.1 g + 0.9 mu) + 1e-3 p; then mu = 0.01 g + 0.99 mu
  lamb     Adam's direction with eps 1e-6, times the trust ratio
           |p| / |u| per tensor (1 where either norm is 0)

Each rule keeps its per-tensor state under optax's names (``mu``, ``nu``,
``sum_of_squares``) and its update count in ``count``: ``io/checkpoint.py``
writes them as optax's state tree and reads them back. Names are matched
case-insensitively; an unknown name gives Adam, as in the JAX package.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch


class OptaxRule(torch.optim.Optimizer):
    """One optax gradient transformation followed by the learning rate.

    ``MOMENTS`` maps each per-tensor state name to its initial value;
    ``count`` is the number of updates made."""

    MOMENTS: Dict[str, float] = {}

    def __init__(self, params, lr: float, **hyper):
        super().__init__(params, dict(lr=lr, **hyper))
        self.count = 0

    def moments(self, p: torch.Tensor) -> Dict[str, torch.Tensor]:
        """The tensor's state, initialized on first use."""
        st = self.state[p]
        for name, value in self.MOMENTS.items():
            if name not in st:
                st[name] = torch.full_like(p, value,
                                           memory_format=torch.preserve_format)
        return st

    def direction(self, g, p, st, group, count: int) -> torch.Tensor:
        raise NotImplementedError

    @torch.no_grad()
    def step(self, closure=None):
        count = self.count + 1  # optax's count after this update
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                u = self.direction(p.grad, p, self.moments(p), group, count)
                p.sub_(group["lr"] * u)
        self.count = count


def _adam_direction(g, st, group, count: int) -> torch.Tensor:
    """optax's ``scale_by_adam``: the moments in place, then the
    bias-corrected m / (sqrt(v) + eps)."""
    b1, b2, eps = group["b1"], group["b2"], group["eps"]
    st["mu"] = (1 - b1) * g + b1 * st["mu"]
    st["nu"] = (1 - b2) * (g * g) + b2 * st["nu"]
    mu_hat = st["mu"] / (1 - b1 ** count)
    nu_hat = st["nu"] / (1 - b2 ** count)
    return mu_hat / (torch.sqrt(nu_hat) + eps)


class AdamW(OptaxRule):
    MOMENTS = {"mu": 0.0, "nu": 0.0}

    def __init__(self, params, lr, b1=0.9, b2=0.999, eps=1e-8,
                 weight_decay=1e-4):
        super().__init__(params, lr, b1=b1, b2=b2, eps=eps,
                         weight_decay=weight_decay)

    def direction(self, g, p, st, group, count):
        return _adam_direction(g, st, group, count) + group[
            "weight_decay"] * p


class SGD(OptaxRule):
    def direction(self, g, p, st, group, count):
        return g


class RMSProp(OptaxRule):
    MOMENTS = {"nu": 0.0}

    def __init__(self, params, lr, decay=0.9, eps=1e-8, initial_scale=0.0):
        self.MOMENTS = {"nu": initial_scale}
        super().__init__(params, lr, decay=decay, eps=eps)

    def direction(self, g, p, st, group, count):
        d = group["decay"]
        st["nu"] = (1 - d) * (g * g) + d * st["nu"]
        return torch.rsqrt(st["nu"] + group["eps"]) * g


class Adagrad(OptaxRule):
    MOMENTS = {"sum_of_squares": 0.1}

    def __init__(self, params, lr, initial_accumulator_value=0.1, eps=1e-7):
        self.MOMENTS = {"sum_of_squares": initial_accumulator_value}
        super().__init__(params, lr, eps=eps)

    def direction(self, g, p, st, group, count):
        s = g * g + st["sum_of_squares"]
        st["sum_of_squares"] = s
        inv = torch.where(s > 0, torch.rsqrt(s + group["eps"]),
                          torch.zeros_like(s))
        return inv * g


class Lion(OptaxRule):
    MOMENTS = {"mu": 0.0}

    def __init__(self, params, lr, b1=0.9, b2=0.99, weight_decay=1e-3):
        super().__init__(params, lr, b1=b1, b2=b2, weight_decay=weight_decay)

    def direction(self, g, p, st, group, count):
        b1, b2 = group["b1"], group["b2"]
        u = torch.sign((1.0 - b1) * g + b1 * st["mu"])
        st["mu"] = (1 - b2) * g + b2 * st["mu"]
        return u + group["weight_decay"] * p


class Lamb(OptaxRule):
    MOMENTS = {"mu": 0.0, "nu": 0.0}

    def __init__(self, params, lr, b1=0.9, b2=0.999, eps=1e-6,
                 weight_decay=0.0):
        super().__init__(params, lr, b1=b1, b2=b2, eps=eps,
                         weight_decay=weight_decay)

    def direction(self, g, p, st, group, count):
        u = _adam_direction(g, st, group, count) + group[
            "weight_decay"] * p
        p_norm = torch.linalg.vector_norm(p)
        u_norm = torch.linalg.vector_norm(u)
        ratio = torch.where((p_norm == 0) | (u_norm == 0),
                            torch.ones_like(p_norm), p_norm / u_norm)
        return u * ratio


OPTIMIZERS = {
    "adam": torch.optim.Adam,
    "adamw": AdamW,
    "sgd": SGD,
    "rmsprop": RMSProp,
    "adagrad": Adagrad,
    "lion": Lion,
    "lamb": Lamb,
}

# each optimizer's inner chain as optax lays out its state, one entry per
# transform: the rule's fields, EMPTY for a stateless transform (weight
# decay, the trust ratio, an identity), SCHEDULE for the schedule's count
EMPTY = ()
SCHEDULE = "schedule"
LAYOUTS: Dict[str, Tuple] = {
    "adam": (("count", "mu", "nu"), SCHEDULE),
    "adamw": (("count", "mu", "nu"), EMPTY, SCHEDULE),
    "sgd": (EMPTY, SCHEDULE),
    "rmsprop": (("nu",), SCHEDULE, EMPTY),
    "adagrad": (("sum_of_squares",), SCHEDULE),
    "lion": (("count", "mu"), EMPTY, SCHEDULE),
    "lamb": (("count", "mu", "nu"), EMPTY, EMPTY, SCHEDULE),
}


def optimizer_name(name: str) -> str:
    """The canonical name of ``--optimizer``: case-insensitive, an unknown
    name falls back to Adam."""
    name = name.lower()
    return name if name in OPTIMIZERS else "adam"
