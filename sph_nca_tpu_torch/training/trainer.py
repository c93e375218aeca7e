"""Plane-mode trainer on the band, cell and graph engines (counterpart of
``sph_nca_tpu/training/trainer.py``).

One iteration: sample B states from the pool, rank them by per-sample loss
and put a fresh seed in the worst one's place, roll the batch out for a
progressive-growing number of steps through the kernels (each step
recomputed in the backward), take the loss (MSE, OT or CLIP) on the final state plus
``aux_states`` random intermediate states, and update the MLP with
per-parameter gradient normalization g / (|g| + 1e-8) before the optimizer
(Adam by default, or any of the JAX trainer's optax optimizers:
``training/optim.py``), whose learning rate falls linearly from lr to
lr * lr_end_factor over lr_decay_steps iterations.

As in the JAX trainer, a band engine (the train CLI's default) or a cell
engine with pair tables takes the batched-lane rollout
(``rollout_cells_batched``: the band products or the table kernels, and the
fused update-MLP kernel); a cell engine without tables takes the recompute
kernels through ``rollout_cells`` on the batch; an ``SPHGraph`` (the fixed-K
graph engine) takes ``models.rollout.rollout_batch``, plain PyTorch, as the
JAX trainer does. The rollout runs exactly n
steps (the JAX trainer rounds its length up to a bucket and freezes the
samples after n). With a ``DevicePool`` the rolled-out states go back to the
pool on the device.

Draws: the step schedule and the aux states from ``numpy.random.
default_rng(seed)`` (the JAX trainer's host draws); the fire masks from
``Trainer.generator`` and the losses' draws (the OT subsamples of the
ranking and of every loss term, in that order, and the CLIP loss's
random crops) from ``Trainer.loss_generator``, both ``torch.Generator`` on the device (the JAX trainer
splits its key into rank, rollout and loss keys: the same laws, other
streams). ``rng_state`` / ``set_rng_state`` and ``opt_state_tree`` /
``load_opt_state`` carry all of it through a checkpoint.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

# the module, not its names: io.checkpoint imports training.optim, so
# importing the io package first reaches this line before checkpoint is whole
from ..io import checkpoint as ckpt
from ..models.cell_step import rollout_cells, rollout_cells_batched
from ..models.nca import MLPParams, SPHNCAConfig, init_params
from ..models.rollout import rollout_batch
from ..ops.batched import batched_gather_back, batched_scatter, has_tables
from ..ops.hashgrid import SPHGraph
from ..utils.profiling import span
from .losses import (
    CLIPLossConfig,
    OTLossConfig,
    clip_loss,
    mse_loss,
    ot_loss,
    overflow_penalty,
    rgba_with_margin,
    target_at,
)
from .optim import OPTIMIZERS, optimizer_name

# the loss generator's seed is the trainer's seed plus this offset, so its
# stream is not the fire masks'
LOSS_SEED_OFFSET = 1 << 32


class LossBundle(NamedTuple):
    """Loss functions for one training mode.

    per_sample(x, A [B, N, C], generator) -> [B]   (pool ranking and
        reporting)
    batch_total(x, A [B, N, C], generator) -> scalar  (the trained
        objective)

    ``generator`` is the trainer's loss generator; the MSE bundle draws
    nothing and ignores it.
    """

    per_sample: Callable[..., torch.Tensor]
    batch_total: Callable[..., torch.Tensor]


def make_mse_bundle(img: torch.Tensor, mse_cfg) -> LossBundle:
    """Image-mode losses. The trained objective follows the reference's
    packed batch: mean over samples of the MSE plus w * the overflow SUMMED
    over samples."""

    def per_sample(x, A, generator=None):
        return mse_loss(x, A, img, mse_cfg)

    def batch_total(x, A_batch, generator=None):
        img_x = target_at(x, img, mse_cfg)
        rgba = rgba_with_margin(A_batch, mse_cfg.use_alpha, margin=None)
        mse_b = torch.mean((rgba - img_x) ** 2, dim=(-2, -1))
        of_b = overflow_penalty(A_batch)
        return torch.mean(mse_b) + mse_cfg.overflow_weight * torch.sum(of_b)

    return LossBundle(per_sample=per_sample, batch_total=batch_total)


def make_ot_bundle(target_img: torch.Tensor, feature_fn,
                   ot_cfg: OTLossConfig) -> LossBundle:
    """Exemplar-mode losses: ``target_img`` [H, W, >=3] is the exemplar on
    the particle grid; its features are computed once, without a gradient.
    The trained objective is the mean of the per-sample losses."""
    target_rgb = target_img[..., :3]
    with torch.no_grad():
        target_feats = [f[0] for f in feature_fn(target_rgb[None])]

    def per_sample(x, A, generator):
        return ot_loss(x, A, target_feats, target_rgb, feature_fn, generator,
                       ot_cfg)

    def batch_total(x, A_batch, generator):
        return torch.mean(per_sample(x, A_batch, generator))

    return LossBundle(per_sample=per_sample, batch_total=batch_total)


def make_clip_bundle(text_features: torch.Tensor, encode_image,
                     clip_cfg: CLIPLossConfig) -> LossBundle:
    """Text-mode losses: ``text_features`` [E] are the prompt's unit
    features, computed once; ``encode_image`` is the image tower. The
    trained objective is the mean of the per-sample losses."""

    def per_sample(x, A, generator):
        return clip_loss(x, A, text_features, encode_image, generator,
                         clip_cfg)

    def batch_total(x, A_batch, generator):
        return torch.mean(per_sample(x, A_batch, generator))

    return LossBundle(per_sample=per_sample, batch_total=batch_total)


def normalize_grads_(params) -> None:
    """Per-parameter g <- g / (|g| + 1e-8), in place."""
    with torch.no_grad():
        for p in params:
            p.grad.div_(torch.linalg.vector_norm(p.grad) + 1e-8)


def linear_lr_factor(count: int, end_factor: float,
                     decay_steps: int) -> float:
    """The learning-rate factor after ``count`` updates: 1 falling linearly
    to ``end_factor`` over ``decay_steps`` (optax's ``linear_schedule``)."""
    return 1.0 + (end_factor - 1.0) * min(count, decay_steps) / decay_steps


def make_optimizer(params, lr: float = 3e-3, *, end_factor: float = 0.1,
                   decay_steps: int = 2000, name: str = "adam"):
    """The optimizer ``name`` (``training.optim.optimizer_name``: any case,
    Adam for an unknown name) and its linear schedule (1 -> end_factor over
    decay_steps). The schedule is a ``LambdaLR`` in closed form, so its
    learning rate at a position depends on the position alone: a
    checkpoint's update count restores it exactly."""
    opt = OPTIMIZERS[optimizer_name(name)](params, lr=lr)
    sched = torch.optim.lr_scheduler.LambdaLR(
        opt, lambda k: linear_lr_factor(k, end_factor, decay_steps))
    return opt, sched


def set_schedule_position(sched, count: int) -> None:
    """Put a ``make_optimizer`` schedule after ``count`` updates."""
    sched.last_epoch = count - 1
    with warnings.catch_warnings():
        # the step-order warning is about a training loop; this moves the
        # schedule to a position, before the restored optimizer's next step
        warnings.filterwarnings("ignore", message="Detected call of")
        sched.step()


def progressive_steps(i: int, steps_range: Tuple[int, int],
                      steps_increment: int, rng: np.random.Generator) -> int:
    """Rollout length for training iteration i: 1, 1, ..., growing by one
    every ``steps_increment`` iterations up to the range's mean, then drawn
    from [lo, hi)."""
    lo, hi = steps_range
    mean = (lo + hi) // 2
    if steps_increment > 0 and i < mean * steps_increment:
        return i // steps_increment + 1
    return int(rng.integers(lo, hi))


@dataclasses.dataclass
class TrainConfig:
    """Training hyper-parameters (defaults = the reference's train.py)."""

    batch_size: int = 8
    pool_size: int = 1024
    training_iter: int = 8000
    steps_range: Tuple[int, int] = (32, 48)
    steps_increment: int = 5
    lr: float = 3e-3
    lr_end_factor: float = 0.1
    lr_decay_steps: int = 2000
    normalize_grads: bool = True
    aux_states: int = 4  # random intermediate states in the loss
    aux_weight: float = 0.1
    degrade_prob: float = 0.0
    erase_radius: float = 0.0
    optimizer: str = "adam"  # any name of training.optim.OPTIMIZERS
    seed: int = 0


class Trainer:
    """Trainer for plane mode on one engine (band, cell or graph): the pool,
    the rollouts and the loss share one geometry.

    ``x`` holds the loss-space positions [N, 2] (the plane, without the z
    the engine's 3D positions carry). Host draws (steps, aux states) come
    from ``numpy.random.default_rng(seed)`` as in the JAX trainer; the
    initial parameters and the fire masks from torch generators seeded with
    ``seed``.
    """

    def __init__(
        self,
        model_cfg: SPHNCAConfig,
        train_cfg: TrainConfig,
        eng,
        x: torch.Tensor,
        loss: LossBundle,
        h: float,
        *,
        params: Optional[MLPParams] = None,
    ):
        self.model_cfg = model_cfg
        self.cfg = train_cfg
        self.eng = eng
        self.device = eng.device
        self.x = x.to(self.device)
        self.loss = loss
        self.h = h

        self.np_rng = np.random.default_rng(train_cfg.seed)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(train_cfg.seed)
        self.loss_generator = torch.Generator(device=self.device)
        self.loss_generator.manual_seed(train_cfg.seed + LOSS_SEED_OFFSET)
        if params is None:
            params = init_params(
                model_cfg, torch.Generator().manual_seed(train_cfg.seed),
                device=self.device)
        self.params = MLPParams(*(p.detach().to(self.device).clone()
                                  .requires_grad_(True) for p in params))
        self.opt_name = optimizer_name(train_cfg.optimizer)
        self.optimizer, self.scheduler = make_optimizer(
            list(self.params), train_cfg.lr,
            end_factor=train_cfg.lr_end_factor,
            decay_steps=train_cfg.lr_decay_steps, name=self.opt_name)
        self.last_steps = 0  # rollout length of the last iteration

    # -- checkpoint and resume state ----------------------------------------

    def rng_state(self) -> Dict[str, Any]:
        """The host stream's state and the device generators' states (uint8
        tensors), for an exact resume."""
        return {"np_rng": self.np_rng.bit_generator.state,
                "torch": {"fire": self.generator.get_state(),
                          "loss": self.loss_generator.get_state()}}

    def set_rng_state(self, np_rng_state, torch_states) -> None:
        self.np_rng.bit_generator.state = np_rng_state
        self.generator.set_state(torch_states["fire"])
        self.loss_generator.set_state(torch_states["loss"])

    def opt_state_tree(self) -> dict:
        """The optimizer's state in the layout of the JAX trainer's optax
        state (see ``io.checkpoint.optax_state_tree``)."""
        return ckpt.optax_state_tree(self.optimizer, self.params,
                                     self.cfg.normalize_grads,
                                     self.opt_name)

    def load_opt_state(self, tree: dict) -> None:
        """Restore the optimizer's state and the schedule's position from an
        optax state tree (a checkpoint's ``opt_state``) of the same
        optimizer."""
        count = ckpt.load_optax_state(self.optimizer, self.params, tree,
                                      self.opt_name)
        set_schedule_position(self.scheduler, count)

    def _rollout(self, A0: torch.Tensor, n: int, collect):
        """(final [B, N, C], collected [S, B, N, C]) in particle order."""
        eng, bsz = self.eng, A0.shape[0]
        if isinstance(eng, SPHGraph):
            out = rollout_batch(self.params, self.model_cfg, eng, A0,
                                self.generator, n, self.h,
                                collect_steps=collect)
            return out.final, list(out.collected.unbind(1))
        if has_tables(eng):
            final, coll = rollout_cells_batched(
                self.params, self.model_cfg, eng, batched_scatter(eng, A0),
                bsz, self.generator, n, self.h, n_steps=[n] * bsz,
                collect_steps=collect)
            return (batched_gather_back(eng, final, bsz),
                    [batched_gather_back(eng, c, bsz) for c in coll])
        final, coll = rollout_cells(
            self.params, self.model_cfg, eng, eng.scatter(A0),
            self.generator, n, self.h, collect_steps=collect)
        return eng.gather_back(final), list(eng.gather_back(coll))

    def run_iteration(self, i: int, pool) -> float:
        """One training iteration on a ``Pool`` or a ``DevicePool``; returns
        the loss. Recorded as the span ``train.iteration`` with, in order,
        ``train.sample``, ``train.rank``, ``train.rollout``, ``train.loss``,
        ``train.backward``, ``train.optimizer``, ``train.pool_update`` and
        ``train.sync`` (the loss read back, the host's wait for the
        card)."""
        with span("train.iteration"):
            cfg = self.cfg
            with span("train.sample"):
                idx, A0 = pool.sample(cfg.batch_size,
                                      degrade_prob=cfg.degrade_prob,
                                      erase_radius=cfg.erase_radius)
                seed_A = pool.initial_feature()
                n = progressive_steps(i, cfg.steps_range, cfg.steps_increment,
                                      self.np_rng)
                collect = self.np_rng.integers(0, n + 1, size=cfg.aux_states)
                self.last_steps = n
                A0 = torch.as_tensor(A0, device=self.device)

            gen = self.loss_generator
            with span("train.rank"):
                with torch.no_grad():
                    # replace-worst: rank by per-sample loss, descending and
                    # stable, and swap the worst for a fresh seed
                    order = torch.argsort(
                        -self.loss.per_sample(self.x, A0, gen), stable=True)
                A0 = A0[order]
                A0[0] = (seed_A if torch.is_tensor(seed_A)
                         else torch.tensor(seed_A))

            with span("train.rollout"):
                final, collected = self._rollout(A0, n, collect)
            with span("train.loss"):
                total = self.loss.batch_total(self.x, final, gen)
                for s in range(cfg.aux_states):
                    total = total + cfg.aux_weight * self.loss.batch_total(
                        self.x, collected[s], gen)

            with span("train.backward"):
                self.optimizer.zero_grad(set_to_none=True)
                total.backward()
            with span("train.optimizer"):
                if cfg.normalize_grads:
                    normalize_grads_(self.params)
                self.optimizer.step()
                self.scheduler.step()
            with span("train.pool_update"):
                pool.update(torch.as_tensor(idx, device=self.device)[order],
                            final.detach())
            with span("train.sync"):
                return total.item()
