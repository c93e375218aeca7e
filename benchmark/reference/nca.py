"""The SPH-NCA step, surface rollouts and one training iteration, in plain
PyTorch from the model's equations (the reference's ``nca.py``, ``train.py``
and ``test.py``):

    alive_i    = alpha_i > a                            (a: the threshold)
    prev_mask  = blur(alive) > a
    g          = h k gradient(A)                       (k = 1 / h)
    plane:     y = [A | g_x | g_y]
    surface:   y = [A | g . t | g . (n x t)]            (tangent frame)
    O          = relu(y W1 + b1) W2 + b2                (48 -> 256 -> 33)
    nA         = A sigmoid(O[:16]) + tanh(O[16:32]) sigmoid(O[32])
    nA         = where(u <= fire_rate, nA, A)
    nA        *= prev_mask & (blur(alive(nA)) > a)
    surface:   t <- diffuse(t) with the weights m = clip(alpha, 0, 1):
               t2 = blur(m t) / (1e-8 + blur(m)); t2 += (t - t2) m;
               t = normalize(t2 - n (n . t2))           (no gradient)

Precision: the MLP's inputs, weights and hidden units are rounded to the
precision under test (``sph.quantize``), with float32 sums; so are the pair
weights and the values they multiply. Everything else is float32.

``rule_of`` reads the rule from a configuration file and refuses one it
does not implement (another update rule, smoothing or gradient kernel,
optimizer, or widths that do not fit the gated rule).

The fire draws u: one uniform number a particle and step from a
``torch.Generator`` seeded as the program's, drawn in the program's row
order (``geometry.band_ranks``) and mapped back to particles.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from .sph import Operators, quantize

# what this reference implements, by a configuration file's keys
IMPLEMENTS = {"update_rule": "gated", "smoothing": "poly6",
              "gradient_kernel": "spiky", "optimizer": "adam"}


class Rule(NamedTuple):
    fire_rate: float
    alive: float  # the life threshold
    scale: float  # h k, the perception's factor


def rule_of(spec: dict, scale: float) -> Rule:
    """The update rule of a configuration file, or ValueError where it
    names what this reference does not implement."""
    for key, value in IMPLEMENTS.items():
        if key in spec and spec[key] != value:
            raise ValueError(f"the reference implements {key} {value!r}, "
                             f"not {spec[key]!r}")
    c = spec["channels"]
    if spec["mlp_inputs"] != 3 * c or spec["mlp_outputs"] != 2 * c + 1:
        raise ValueError("the gated rule maps 3C inputs to 2C + 1 outputs")
    return Rule(float(spec["fire_rate"]), float(spec["alive_threshold"]),
                scale)

MLP_BLOCK = 1 << 19  # rows of one MLP block


class Weights(NamedTuple):
    w1: torch.Tensor  # [3C, H]
    b1: torch.Tensor  # [H]
    w2: torch.Tensor  # [H, 2C + 1]
    b2: torch.Tensor  # [2C + 1]


def mlp(p: Weights, y: torch.Tensor, precision: str) -> torch.Tensor:
    """y [..., 3C] -> O [..., 2C + 1], in blocks of rows."""
    w1, w2 = quantize(p.w1, precision), quantize(p.w2, precision)
    rows = y.reshape(-1, y.shape[-1])
    outs = []
    for s in range(0, rows.shape[0], MLP_BLOCK):
        H = torch.relu(quantize(rows[s:s + MLP_BLOCK], precision) @ w1
                       + p.b1)
        outs.append(quantize(H, precision) @ w2 + p.b2)
    return torch.cat(outs).reshape(*y.shape[:-1], -1)


class FireDraws:
    """The program's fire draws, one [B, blocks, rows] draw a step, given to
    the particles in the program's row order."""

    def __init__(self, seed, rank: np.ndarray, shape, batch: int, device):
        """``seed``: an int, or a ``torch.Generator`` to draw from."""
        self.gen = seed if isinstance(seed, torch.Generator) else \
            torch.Generator(device=device).manual_seed(int(seed))
        self.rank = torch.as_tensor(rank, device=device)
        self.shape = (batch,) + tuple(shape)
        self.device = device

    def next(self) -> torch.Tensor:
        u = torch.rand(self.shape, generator=self.gen, device=self.device)
        return u.reshape(self.shape[0], -1)[:, self.rank]


def _update(p, A, y, u, fire_rate, precision):
    O = mlp(p, y, precision)
    c = A.shape[-1]
    nA = (A * torch.sigmoid(O[..., :c])
          + torch.tanh(O[..., c:2 * c]) * torch.sigmoid(O[..., 2 * c:]))
    return torch.where((u <= fire_rate)[..., None], nA, A)


def _masked(ops: Operators, A, nA, prev, threshold, seen=None):
    post = ops.blur(alive(nA.detach(), ops.precision, threshold))[..., 0]
    if seen is not None:
        seen.update(post=post, alpha=quantize(nA[..., 3], ops.precision))
    return nA * (prev & (post > threshold)).to(nA.dtype)[..., None]


def alive(A: torch.Tensor, precision: str, threshold: float) -> torch.Tensor:
    """[B, N, 1]: 1 where the alpha lane passes the threshold, both rounded
    to the precision (the values the products see; 0.1 is not a bfloat16
    number)."""
    t = quantize(torch.tensor(threshold, device=A.device), precision)
    return (quantize(A[..., 3:4], precision) > t).float()


def surface_step(ops, p, A, t, n, u, rule: Rule, seen=None):
    """One surface step: A [B, N, C], tangents t [B, N, 3], normals n
    [N, 3] -> (A, t). ``seen``, a dict, receives the values the life masks
    test, [B, N] each: ``pre`` and ``post``, the blurred life before and
    after the update, and ``alpha``, the updated alpha lane."""
    q = ops.precision
    pre = ops.blur(alive(A, q, rule.alive))[..., 0]
    prev = pre > rule.alive
    if seen is not None:
        seen["pre"] = pre
    g = rule.scale * ops.gradient(A)  # [B, N, C, 3]
    b = torch.linalg.cross(n.expand_as(t), t, dim=-1)
    y = torch.cat([A, torch.einsum("bnfd,bnd->bnf", g, t),
                   torch.einsum("bnfd,bnd->bnf", g, b)], dim=-1)
    A = _masked(ops, A, _update(p, A, y, u, rule.fire_rate, q), prev,
                rule.alive, seen)
    m = torch.clamp(A[..., 3:4], 0.0, 1.0)
    mt = ops.blur(torch.cat([m, m * t], dim=-1))
    t2 = mt[..., 1:] / (1e-8 + mt[..., :1])
    t2 = t2 + (t - t2) * m
    t2 = t2 - n * torch.sum(n * t2, dim=-1, keepdim=True)
    return A, t2 / (1e-8 + torch.linalg.vector_norm(t2, dim=-1,
                                                    keepdim=True))


@torch.no_grad()
def surface_rollout(ops, p, A0, T0, n, draws: FireDraws, steps: int,
                    rule: Rule):
    """``steps`` surface steps from A0 [B, N, C], T0 [B, N, 3]."""
    A, t = A0.float(), T0.float()
    for _ in range(steps):
        A, t = surface_step(ops, p, A, t, n, draws.next(), rule)
    return A, t


def plane_step(ops, p, A, u, rule: Rule):
    """One plane step: A [B, N, C] -> [B, N, C] (the gradient's x and y
    axes feed the MLP)."""
    q = ops.precision
    prev = ops.blur(alive(A, q, rule.alive))[..., 0] > rule.alive
    g = rule.scale * ops.gradient(A)
    y = torch.cat([A, g[..., 0], g[..., 1]], dim=-1)
    return _masked(ops, A, _update(p, A, y, u, rule.fire_rate, q), prev,
                   rule.alive)


def plane_rollout(ops, p, A0, draws: FireDraws, steps: int, collect,
                  rule: Rule, remat: bool = True):
    """``steps`` plane steps from A0, each recomputed in the backward where
    ``remat`` -> (final, [state after step k for k in collect]) (k = 0 is
    A0)."""
    A, kept = A0, {0: A0}
    for s in range(steps):
        u = draws.next()
        A = (checkpoint(plane_step, ops, p, A, u, rule, use_reentrant=False)
             if remat else plane_step(ops, p, A, u, rule))
        kept[s + 1] = A
    return A, [kept[int(k)] for k in collect]


def mse(A, target, overflow_weight):
    """Per-sample (mean (rgba - target)^2, sum max(|A| - 1, 0))."""
    rgba = A[..., :4]
    err = torch.mean((rgba - target) ** 2, dim=(-2, -1))
    return err, torch.sum(torch.clamp(A.abs() - 1.0, min=0.0), dim=(-2, -1))


def batch_loss(A, target, overflow_weight):
    err, over = mse(A, target, overflow_weight)
    return torch.mean(err) + overflow_weight * torch.sum(over)


class Adam:
    """Adam (b1 0.9, b2 0.999, eps 1e-8, bias-corrected), where
    ``normalize`` after the per-tensor normalization g / (|g| + 1e-8), at
    lr * factor(count)."""

    def __init__(self, params, lr, end_factor, decay_steps, normalize):
        self.params = params
        self.lr, self.end, self.decay = lr, end_factor, decay_steps
        self.normalize = normalize
        self.m = [torch.zeros_like(t) for t in params]
        self.v = [torch.zeros_like(t) for t in params]
        self.count = 0

    @torch.no_grad()
    def step(self, grads):
        lr = self.lr * (1.0 + (self.end - 1.0)
                        * min(self.count, self.decay) / self.decay)
        self.count += 1
        normed = ([g / (torch.linalg.vector_norm(g) + 1e-8) for g in grads]
                  if self.normalize else list(grads))
        for t, g, m, v in zip(self.params, normed, self.m, self.v):
            m.mul_(0.9).add_(g, alpha=0.1)
            v.mul_(0.999).addcmul_(g, g, value=0.001)
            denom = (v.sqrt() / (1 - 0.999 ** self.count) ** 0.5).add_(1e-8)
            t.addcdiv_(m, denom, value=-lr / (1 - 0.9 ** self.count))


class PlaneTrainer:
    """Training iterations on the plane (the reference's train.py loop):
    draw B states from the pool without replacement, rank them by the
    per-sample loss and put the seed in the worst one's place, roll the
    batch out for a drawn number of steps, take the loss of the final state
    and of ``aux_states`` drawn intermediate states, and update with
    ``Adam``; the rolled-out states go back to the pool.

    Its draws are the program's laws on the program's seeds: the pool's
    index draws from ``numpy.random.default_rng(pool_seed)``, the depth and
    the aux states from ``default_rng(train_seed)``, the fire masks from a
    ``torch.Generator`` seeded with ``train_seed``. ``iterate`` runs one
    iteration from a drawn batch, which lets the check start it from the
    program's own state (``resume``)."""

    def __init__(self, ops, weights: Weights, x2, img, pool, seed_state,
                 spec: dict, *, pool_seed: int, train_seed: int, rank, shape,
                 batch: int, rule: Rule, device):
        self.ops, self.spec, self.b, self.rule = ops, spec, batch, rule
        self.initial = [t.detach().clone() for t in weights]
        self.params = [t.detach().clone().requires_grad_(True)
                       for t in weights]
        self.adam = Adam(self.params, spec["lr"], spec["lr_end_factor"],
                         spec["lr_decay_steps"], spec["normalize_grads"])
        self.pool, self.seed_state = pool, seed_state
        self.pool_rng = np.random.default_rng(pool_seed)
        self.np_rng = np.random.default_rng(train_seed)
        self.draws = FireDraws(train_seed, rank, shape, batch, device)
        self.target = bilinear_target(x2, img, spec["image_scale"])
        self.raw_grads = None  # the last iteration's, before normalizing
        self.first_raw_grads = None
        self.last_steps = 0

    def resume(self, adam_state, np_state, fire_state) -> None:
        """Continue from a program's state: Adam's moments and count
        ([(m, v)] by leaf, count), the host draws' and the fire
        generator's states."""
        moments, self.adam.count = adam_state
        self.adam.m = [m.clone() for m, _ in moments]
        self.adam.v = [v.clone() for _, v in moments]
        self.np_rng.bit_generator.state = np_state
        self.draws.gen.set_state(fire_state)

    def iteration(self) -> float:
        idx = torch.as_tensor(
            self.pool_rng.permutation(self.pool.shape[0])[:self.b],
            device=self.pool.device)
        loss, final, order = self.iterate(self.pool[idx])
        self.pool[idx[order]] = final.detach()
        return loss

    def iterate(self, A0):
        """One iteration from the drawn batch A0 [B, N, C] -> (loss, the
        final states in ranked order, the ranking)."""
        spec, w = self.spec, self.spec["overflow_weight"]
        lo, hi = spec["steps_range"]
        n = self.last_steps = int(self.np_rng.integers(lo, hi))
        collect = self.np_rng.integers(0, n + 1, size=spec["aux_states"])
        with torch.no_grad():
            err, over = mse(A0, self.target, w)
            order = torch.argsort(-(err + w * over), stable=True)
        A0 = A0[order]
        A0[0] = self.seed_state
        p = Weights(*self.params)
        final, kept = plane_rollout(self.ops, p, A0, self.draws, n, collect,
                                    self.rule, spec["remat"])
        total = batch_loss(final, self.target, w)
        for A in kept:
            total = total + spec["aux_weight"] * batch_loss(A, self.target, w)
        grads = torch.autograd.grad(total, self.params)
        self.raw_grads = [g.clone() for g in grads]
        if self.first_raw_grads is None:
            self.first_raw_grads = self.raw_grads
        self.adam.step(grads)
        return float(total.detach()), final.detach(), order


def bilinear_target(x2, img, image_scale: float):
    """The target image, spanning [-s, s]^2 for s = image_scale, sampled at
    the particles' plane positions x2 [N, 2] -> [N, 4]."""
    from .geometry import bilinear

    return bilinear(x2, img, -image_scale, 2.0 * image_scale)
