"""Persistent-CA sample pool on the host (counterpart of ``Pool`` in
``sph_nca_tpu/training/pool.py``).

A numpy ring of NCA states [total_size, N, C]. Positions are stored once:
the geometry never changes during training. For the same ``rng`` the pool
makes the same numpy draws as the JAX package's ``Pool``, so both sample the
same slots. Damage for regeneration training: ``degrade_prob`` re-randomizes
random particles, ``erase_radius`` zeroes a random disk per sample.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


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

    def update(self, idx: np.ndarray, A: np.ndarray) -> None:
        """Write rolled-out states back."""
        self.A[idx] = np.asarray(A, np.float32)
