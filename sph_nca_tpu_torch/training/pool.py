"""Persistent-CA sample pools (counterparts of ``Pool`` and ``DevicePool`` in
``sph_nca_tpu/training/pool.py``).

``Pool`` is a numpy ring of NCA states [total_size, N, C] on the host;
``DevicePool`` keeps the ring on the device, so a training iteration moves no
state between host and device. Positions are stored once: the geometry never
changes during training. For the same ``rng`` both make the same numpy draws
as the JAX package's pools, so all sample the same slots. Damage for
regeneration training: ``degrade_prob`` re-randomizes random particles,
``erase_radius`` zeroes a random disk per sample (on the device for
``DevicePool``, from a torch generator seeded by the numpy rng, as the JAX
package derives its keys).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .. import resolve_device


class Pool:
    def __init__(
        self,
        seed_x: np.ndarray,  # [N, D]
        seed_A: np.ndarray,  # [N, C]
        total_size: int,
        *,
        randomized_feat: bool = False,
        rng: Optional[np.random.Generator] = None,
    ):
        self.rng = rng if rng is not None else np.random.default_rng(0)
        self.x = np.asarray(seed_x, np.float32)
        self.seed_A = np.asarray(seed_A, np.float32)
        self.total_size = total_size
        self.num_points, self.num_features = self.seed_A.shape
        self.randomized_feat = randomized_feat

        self.A = np.empty(
            (total_size, self.num_points, self.num_features), np.float32
        )
        for i in range(total_size):
            self.A[i] = self.initial_feature()

    def initial_feature(self) -> np.ndarray:
        """A fresh seed state."""
        if self.randomized_feat:
            return self.rng.random(
                (self.num_points, self.num_features), dtype=np.float32
            )
        return self.seed_A

    def sample(
        self,
        batch_size: int,
        *,
        degrade_prob: float = 0.0,
        erase_radius: float = 0.0,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Draw a batch without replacement -> (idx [B], A [B, N, C]).

        Worst-sample replacement is the caller's job: it needs the loss."""
        idx = self.rng.permutation(self.total_size)[:batch_size]
        A = self.A[idx].copy()

        if degrade_prob > 0.0:
            mask = self.rng.random(A.shape[:2]) < degrade_prob
            A[mask] = self.rng.random(
                (int(mask.sum()), self.num_features), dtype=np.float32
            )
        if erase_radius > 0.0:
            for b in range(batch_size):
                i = self.rng.integers(self.num_points)
                d2 = np.sum((self.x - self.x[i]) ** 2, axis=-1)
                A[b, d2 < erase_radius**2] = 0.0
        return idx, A

    def update(self, idx, A) -> None:
        """Write rolled-out states back; ``idx`` and ``A`` may be numpy
        arrays or tensors on any device."""
        if torch.is_tensor(idx):
            idx = idx.cpu().numpy()
        if torch.is_tensor(A):
            A = A.detach().cpu().numpy()
        self.A[idx] = np.asarray(A, np.float32)


class DevicePool:
    """Device-resident pool: the ring [total_size, N, C] lives on
    ``device``; sample and update are device gathers and scatters, and only
    the index draws (the same numpy draws as ``Pool``) are made on the host.
    Random states and damage come from torch generators seeded by
    ``rng.integers(2**63)``, one draw per use, as the JAX package seeds its
    keys."""

    def __init__(
        self,
        seed_x: np.ndarray,  # [N, D]
        seed_A: np.ndarray,  # [N, C]
        total_size: int,
        *,
        randomized_feat: bool = False,
        rng: Optional[np.random.Generator] = None,
        device="cuda",
    ):
        self.rng = rng if rng is not None else np.random.default_rng(0)
        self.device = resolve_device(device)
        self.x = torch.tensor(np.asarray(seed_x, np.float32),
                              device=self.device)
        self.seed_A = torch.tensor(np.asarray(seed_A, np.float32),
                                   device=self.device)
        self.total_size = total_size
        self.num_points, self.num_features = self.seed_A.shape
        self.randomized_feat = randomized_feat
        shape = (total_size, self.num_points, self.num_features)
        if randomized_feat:
            self.A = torch.rand(shape, generator=self._generator(),
                                device=self.device)
        else:
            self.A = self.seed_A.expand(shape).clone()

    def _generator(self) -> torch.Generator:
        seed = int(self.rng.integers(2**63))
        return torch.Generator(device=self.device).manual_seed(seed)

    def initial_feature(self) -> torch.Tensor:
        """A fresh seed state, on the device."""
        if self.randomized_feat:
            return torch.rand((self.num_points, self.num_features),
                              generator=self._generator(), device=self.device)
        return self.seed_A

    def sample(
        self,
        batch_size: int,
        *,
        degrade_prob: float = 0.0,
        erase_radius: float = 0.0,
    ) -> Tuple[np.ndarray, torch.Tensor]:
        """Draw a batch without replacement -> (idx [B] on the host, A
        [B, N, C] on the device)."""
        idx = self.rng.permutation(self.total_size)[:batch_size]
        A = self.A[torch.as_tensor(idx, device=self.device)]
        if degrade_prob > 0.0 or erase_radius > 0.0:
            A = _damage(A, self.x, self._generator(), float(degrade_prob),
                        float(erase_radius))
        return idx, A

    def update(self, idx, A: torch.Tensor) -> None:
        """Write rolled-out states back on the device; ``idx`` may be a host
        array or a device tensor."""
        self.A[torch.as_tensor(idx, device=self.device)] = A.to(self.A.dtype)

    def state_np(self) -> np.ndarray:
        return self.A.cpu().numpy()

    def load_state(self, A: np.ndarray) -> None:
        self.A = torch.tensor(np.asarray(A, np.float32), device=self.device)


def _damage(A: torch.Tensor, x: torch.Tensor, gen: torch.Generator,
            degrade_prob: float, erase_radius: float) -> torch.Tensor:
    """Device-side damage: re-randomize a ``degrade_prob`` share of each
    sample's particles, zero a disk of ``erase_radius`` around a random
    particle per sample."""
    b, n, _ = A.shape
    if degrade_prob > 0.0:
        mask = torch.rand((b, n), generator=gen, device=A.device) < degrade_prob
        repl = torch.rand(A.shape, generator=gen, device=A.device)
        A = torch.where(mask[..., None], repl, A)
    if erase_radius > 0.0:
        centers = x[torch.randint(0, n, (b,), generator=gen, device=A.device)]
        d2 = torch.sum((x[None] - centers[:, None]) ** 2, dim=-1)
        A = torch.where((d2 < erase_radius**2)[..., None], 0.0, A)
    return A
