"""Inputs both sides share, and the one layout fact the reference needs.

Plain numpy and PyTorch. The point clouds, normals, the plane's grid and its
radial seed are written out here from their published definitions (the
reference's ``test.py`` surface mode samples a sphere-like mesh; its
``train.py`` puts a 128x128 grid on [-1, 1]^2 with a radial seed at the
centre), so the benchmark makes them itself and hands the same arrays to the
program and to the reference.

``band_ranks`` is a frozen copy of the band engine's row order (a stable
sort of the cells' Hilbert indices). The program draws its fire masks in
that order, one uniform number a row; the reference needs the order only to
give each particle the number the program gave it. It reads nothing the
program built.
"""

from __future__ import annotations

import numpy as np
import torch


def fibonacci_sphere(n: int, radius: float) -> np.ndarray:
    """Quasi-uniform points on a sphere, [n, 3] float32."""
    i = np.arange(n, dtype=np.float64)
    phi = np.pi * (3.0 - np.sqrt(5.0))
    y = 1.0 - 2.0 * (i + 0.5) / n
    r = np.sqrt(np.maximum(1.0 - y * y, 0.0))
    theta = phi * i
    pts = np.stack([r * np.cos(theta), y, r * np.sin(theta)], axis=-1)
    return (radius * pts).astype(np.float32)


def sphere_normals(x: np.ndarray) -> np.ndarray:
    return (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(np.float32)


def h_for_neighbours(n: int, radius: float, neighbours: int) -> float:
    """The h whose disk holds ``neighbours`` points of an n-point sphere."""
    return float(np.sqrt(neighbours * 4.0 * np.pi * radius ** 2 / n / np.pi))


def plane_grid(side: int) -> torch.Tensor:
    """Cell centres of a side x side grid on [-1, 1]^2, [side^2, 2] float32,
    in row-major (i, j) order."""
    ax = torch.arange(side, dtype=torch.float32)
    idx = torch.stack(torch.meshgrid(ax, ax, indexing="ij"), dim=-1)
    return (-1.0 + 2.0 * (idx + 0.5) / side).reshape(-1, 2)


def radial_seed(x2: torch.Tensor, channels: int, radius: float
                ) -> torch.Tensor:
    """Zeros plus (1 - d^2 / R^2)^3 (clamped to [0, 1]) in every channel
    around the domain's centre (0, 0): [N, channels]."""
    d2 = torch.sum(x2 * x2, dim=-1)
    w = torch.clamp(1.0 - d2 / radius ** 2, 0.0, 1.0) ** 3
    return w[:, None].expand(-1, channels).clone()


def bilinear(p: torch.Tensor, img: torch.Tensor, lo: float, size: float
             ) -> torch.Tensor:
    """img [H, W, K] spanning [lo, lo + size]^2 sampled at p [P, 2], pixel
    centres at half steps, edges clamped: [P, K]."""
    g = torch.tensor(img.shape[:2], dtype=p.dtype, device=p.device)
    gp = (p - lo) / (size / g)
    base = torch.floor(gp - 0.5)
    hi = torch.tensor(img.shape[:2], device=p.device) - 1
    out = torch.zeros(p.shape[0], img.shape[-1], dtype=p.dtype,
                      device=p.device)
    for oi in (0, 1):
        for oj in (0, 1):
            corner = base + torch.tensor([oi, oj], dtype=p.dtype,
                                         device=p.device)
            w = torch.prod(1.0 - torch.abs(gp - (corner + 0.5)), dim=-1)
            c = torch.minimum(torch.clamp(corner.long(), min=0), hi)
            out = out + w[:, None] * img[c[:, 0], c[:, 1]]
    return out


def _hilbert(c: np.ndarray) -> np.ndarray:
    """Hilbert index of integer cells c [n, D] (Skilling's transpose
    form, AIP CP 707:381, 2004)."""
    X = np.array(c, np.int64, copy=True)
    n, d = X.shape
    nbits = max(1, int(np.max(X)).bit_length())
    M = np.int64(1) << (nbits - 1)
    Q = M
    while Q > 1:
        P = Q - 1
        for i in range(d):
            hi = (X[:, i] & Q) != 0
            t = np.where(hi, 0, (X[:, 0] ^ X[:, i]) & P)
            X[:, 0] = np.where(hi, X[:, 0] ^ P, X[:, 0]) ^ t
            X[:, i] ^= t
        Q >>= 1
    for i in range(1, d):
        X[:, i] ^= X[:, i - 1]
    t = np.zeros(n, np.int64)
    Q = M
    while Q > 1:
        t = np.where((X[:, d - 1] & Q) != 0, t ^ (Q - 1), t)
        Q >>= 1
    for i in range(d):
        X[:, i] ^= t
    code = np.zeros(n, np.int64)
    for bit in range(nbits):
        for i in range(d):
            code |= ((X[:, i] >> bit) & 1) << (bit * d + (d - 1 - i))
    return code


def band_ranks(x: np.ndarray, h: float, rows: int = 64):
    """The band engine's row of each particle and its (blocks, rows) shape:
    particles sorted stably by the Hilbert index of their h-cell (an open
    domain), blocks of ``rows`` consecutive particles."""
    x = np.asarray(x, np.float64)
    fl = np.floor(x / np.full(x.shape[1], float(h))).astype(np.int64)
    order = np.argsort(_hilbert(fl - fl.min(axis=0)), kind="stable")
    rank = np.empty(len(x), np.int64)
    rank[order] = np.arange(len(x))
    return rank, (-(-len(x) // rows), rows)
