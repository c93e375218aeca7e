"""Procedural surfaces, mesh normalization and farthest-point sampling.

Counterpart of ``fibonacci_sphere``, ``sphere_normals``, ``torus_points``,
``normalize_mesh`` and ``farthest_point_sampling`` in
``sph_nca_tpu/utils/meshes.py``: the first four are numpy (the same
arithmetic, so the same points), the sampler runs in torch on the points'
device.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def normalize_mesh(v: np.ndarray, scale: float = 1.0,
                   axis_swap: bool = True) -> np.ndarray:
    """The reference's mesh normalization (test.py:157-160): axes [z, x, y],
    centered, max-|coord| scaled to ``scale``."""
    v = v[..., [2, 0, 1]] if axis_swap else v
    v = v - v.mean(axis=-2)
    v = v / np.abs(v).max()
    return (v * scale).astype(np.float32)


def fibonacci_sphere(n: int, radius: float = 0.8) -> np.ndarray:
    """Quasi-uniform points on a sphere surface, [n, 3]."""
    i = np.arange(n, dtype=np.float64)
    phi = np.pi * (3.0 - np.sqrt(5.0))
    y = 1.0 - 2.0 * (i + 0.5) / n
    r = np.sqrt(np.maximum(1.0 - y * y, 0.0))
    theta = phi * i
    pts = np.stack([r * np.cos(theta), y, r * np.sin(theta)], axis=-1)
    return (radius * pts).astype(np.float32)


def sphere_normals(x: np.ndarray) -> np.ndarray:
    n = x / np.linalg.norm(x, axis=-1, keepdims=True)
    return n.astype(np.float32)


def torus_points(n: int, R: float = 0.6, r: float = 0.25,
                 seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Quasi-uniform torus samples -> (points [n, 3], normals [n, 3])."""
    rng = np.random.default_rng(seed)
    pts, nrm = [], []
    while sum(len(p) for p in pts) < n:
        m = 2 * n
        u = rng.random(m) * 2 * np.pi
        v = rng.random(m) * 2 * np.pi
        # rejection-sample for uniform area: accept with p ~ R + r cos v
        acc = rng.random(m) < (R + r * np.cos(v)) / (R + r)
        u, v = u[acc], v[acc]
        cx = (R + r * np.cos(v)) * np.cos(u)
        cy = (R + r * np.cos(v)) * np.sin(u)
        cz = r * np.sin(v)
        pts.append(np.stack([cx, cy, cz], -1))
        nrm.append(
            np.stack(
                [np.cos(v) * np.cos(u), np.cos(v) * np.sin(u), np.sin(v)], -1
            )
        )
    p = np.concatenate(pts)[:n].astype(np.float32)
    nn = np.concatenate(nrm)[:n].astype(np.float32)
    return p, nn


def _sq_dist(x: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """|x - p|^2 [N] in float32, each axis added as one fused multiply-add
    (exact in float64, one rounding to float32), the way XLA evaluates the
    JAX package's ``sum((x - p) ** 2)``: on symmetric surfaces near-ties are
    common, and they must break the same way."""
    dx = (x - p).double()
    acc = (dx[:, 0] * dx[:, 0]).float()
    for k in range(1, dx.shape[1]):
        acc = (dx[:, k] * dx[:, k] + acc.double()).float()
    return acc


def farthest_point_sampling(x: torch.Tensor, m: int,
                            start: int = 0) -> torch.Tensor:
    """Greedy farthest-point sampling: m indices [m] int64 into x [N, D].

    Starts at ``start``; each next index maximizes the squared distance to
    the nearest one already chosen (argmax takes the first maximum), as the
    JAX package's loop does.
    """
    n = x.shape[0]
    sel = torch.zeros(m, dtype=torch.int64, device=x.device)
    sel[0] = start
    mind = torch.full((n,), float("inf"), dtype=torch.float32,
                      device=x.device)
    for i in range(1, m):
        mind = torch.minimum(mind, _sq_dist(x, x[sel[i - 1]]))
        sel[i] = torch.argmax(mind)
    return sel
