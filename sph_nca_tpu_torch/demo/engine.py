"""Pure-numpy SPH-NCA forward inference: the demo's independent oracle.

The port's own copy of ``sph_nca_tpu/demo/engine.py`` (the card's machine
has numpy but no JAX, so it cannot import the JAX package's), unchanged in
its arithmetic: a periodic modulo hash grid, the smoothing kernels written
from the math, per-particle neighbour lists and edge weights, one NCA step in
float32 numpy. It shares no code with ``sph_nca_tpu_torch.ops``, so it stays
an independent check of the forward path: ``chip_smoke.py`` [demo-parity]
holds the demo server's states on the card against it, and
``tests/test_torch_demo.py`` checks that it steps bit for bit as the JAX
package's copy does.

It loops over particles in Python: use it at a few thousand particles at
most (``chip_smoke.py`` runs it at 32x32).
"""

from __future__ import annotations

import numpy as np


class NumpyHashGrid:
    """Periodic modulo cell grid with per-cell index buckets."""

    def __init__(self, x: np.ndarray, h: float, dims: int):
        self.h = h
        self.d = x.shape[-1]
        self.dims = dims
        ci = np.mod(np.floor(x / h).astype(np.int64), dims)
        strides = dims ** np.arange(self.d)
        self.cell = ci @ strides
        order = np.argsort(self.cell, kind="stable")
        self.order = order
        sorted_cells = self.cell[order]
        num_cells = dims**self.d
        self.start = np.searchsorted(sorted_cells, np.arange(num_cells), "left")
        self.end = np.searchsorted(sorted_cells, np.arange(num_cells), "right")
        self._strides = strides
        self._ci = ci
        # stencil offsets
        mesh = np.meshgrid(*([np.array([-1, 0, 1])] * self.d), indexing="ij")
        self._offsets = np.stack([m.ravel() for m in mesh], -1)

    def neighbors(self, i: int, x: np.ndarray, period=None) -> np.ndarray:
        """Indices within radius h of particle i (self included)."""
        cand = []
        for off in self._offsets:
            c = np.mod(self._ci[i] + off, self.dims) @ self._strides
            cand.append(self.order[self.start[c] : self.end[c]])
        cand = np.concatenate(cand) if cand else np.zeros(0, np.int64)
        r = x[cand] - x[i]
        if period is not None:
            r = r - np.round(r / period) * period
        d2 = np.sum(r * r, -1)
        return cand[d2 < self.h * self.h]


def poly6(d2, h):
    return np.maximum(h * h - d2, 0.0) ** 3


def poly6_norm(h, d):
    if d == 2:
        return 4.0 / (np.pi * h**8)
    return 315.0 / (64.0 * np.pi * h**9)


def wendland_c2(d2, h):
    q = np.sqrt(d2) / h
    return np.where(q < 1.0, (1.0 - q) ** 4 * (4.0 * q + 1.0), 0.0)


def wendland_c2_norm(h, d):
    if d == 2:
        return 7.0 / (np.pi * h**2)
    return 21.0 / (2.0 * np.pi * h**3)


def wendland_c4(d2, h):
    q2 = d2 / (h * h)
    q = np.sqrt(q2)
    return np.where(
        q < 1.0, (1.0 - q) ** 6 * (35.0 * q2 + 18.0 * q + 3.0) / 3.0, 0.0
    )


def wendland_c4_norm(h, d):
    if d == 2:
        return 9.0 / (np.pi * h**2)
    return 495.0 / (32.0 * np.pi * h**3)


SMOOTHING = {
    "poly6": (poly6, poly6_norm),
    "wendlandC2": (wendland_c2, wendland_c2_norm),
    "wendlandC4": (wendland_c4, wendland_c4_norm),
}


def spiky_norm(h, d):
    if d == 2:
        return 10.0 / (np.pi * h**5)
    return 15.0 / (np.pi * h**6)


class NumpyEngine:
    """Forward-only SPH-NCA inference over a static point cloud."""

    def __init__(
        self,
        x: np.ndarray,  # [N, D]
        weights: dict,  # {'w1','b1','w2','b2'} with w1 [in, hidden]
        *,
        h: float,
        fire_rate: float = 0.5,
        update_rule: str = "gated",
        channels: int = 16,
        use_alpha: bool = True,
        normalize_perception: float = -1.0,
        period=None,
        seed: int = 0,
        smoothing: str = "poly6",
    ):
        self.x = np.asarray(x, np.float32)
        self.n, self.d = self.x.shape
        self.h = h
        self.channels = channels
        self.fire_rate = fire_rate
        self.update_rule = update_rule
        self.use_alpha = use_alpha
        self.normalize_perception = normalize_perception
        self.period = period
        self.w = weights
        self.rng = np.random.default_rng(seed)

        dims = int(np.ceil(2.0 / h))
        self.grid = NumpyHashGrid(self.x, h, dims)
        # static neighborhood: precompute neighbor lists + kernel weights
        self.nbrs = [
            self.grid.neighbors(i, self.x, period) for i in range(self.n)
        ]
        w_fn, w_norm = SMOOTHING[smoothing]
        sig_w = w_norm(h, self.d)
        sig_g = spiky_norm(h, self.d)
        inv_v = np.zeros(self.n, np.float32)
        for i, js in enumerate(self.nbrs):
            r = self._disp(i, js)
            inv_v[i] = sig_w * w_fn(np.sum(r * r, -1), h).sum()
        self.v = 1.0 / inv_v
        # per-edge weights
        self.wv = []
        self.gv = []
        for i, js in enumerate(self.nbrs):
            r = self._disp(i, js)
            d2 = np.sum(r * r, -1)
            self.wv.append(sig_w * w_fn(d2, h) * self.v[js])
            dd = np.sqrt(d2)
            mag = np.where(
                (dd > 0) & (dd < h),
                3.0 * (h - dd) ** 2 / np.maximum(dd, 1e-20),
                0.0,
            )
            self.gv.append(
                sig_g * mag[:, None] * r * (self.v[js])[:, None]
            )

    def _disp(self, i, js):
        r = self.x[js] - self.x[i]
        if self.period is not None:
            r = r - np.round(r / self.period) * self.period
        return r

    # -- ops ---------------------------------------------------------------

    def blur(self, A: np.ndarray) -> np.ndarray:
        out = np.zeros_like(A)
        for i, js in enumerate(self.nbrs):
            out[i] = self.wv[i] @ A[js]
        return out

    def gradient(self, A: np.ndarray) -> np.ndarray:
        out = np.zeros((self.n, A.shape[-1], self.d), A.dtype)
        for i, js in enumerate(self.nbrs):
            dA = A[js] - A[i]
            out[i] = dA.T @ self.gv[i]
        return out

    def activity(self, A):
        return A[:, 3] if self.use_alpha else np.ones(self.n, A.dtype)

    def life_mask(self, A):
        m = (self.activity(A) > 0.1).astype(np.float32)[:, None]
        return self.blur(m)[:, 0] > 0.1

    def step(self, A: np.ndarray, fire_rate=None) -> np.ndarray:
        """One NCA step (math per reference nca.py:87-117)."""
        if fire_rate is None:
            fire_rate = self.fire_rate
        c = self.channels
        prev = self.life_mask(A)

        gA = self.gradient(A)
        if self.normalize_perception > 0:
            gA = self.h * gA * self.normalize_perception
        y = np.concatenate([A, gA[..., 0], gA[..., 1]], axis=-1)
        hdn = np.maximum(y @ self.w["w1"] + self.w["b1"], 0.0)
        dA = hdn @ self.w["w2"] + self.w["b2"]

        if self.update_rule == "gated":
            gate = 1.0 / (1.0 + np.exp(-dA[:, :c]))
            delta = np.tanh(dA[:, c : 2 * c])
            mult = 1.0 / (1.0 + np.exp(-dA[:, -1:]))
            nA = A * gate + delta * mult
        else:
            nA = A + dA * (self.fire_rate / fire_rate)

        update = self.rng.random(self.n) <= fire_rate
        nA = np.where(update[:, None], nA, A)

        new = self.life_mask(nA)
        return nA * (prev & new).astype(nA.dtype)[:, None]

    def rgba(self, A: np.ndarray) -> np.ndarray:
        return np.concatenate([A[:, :3], self.activity(A)[:, None]], axis=-1)
