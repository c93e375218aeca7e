"""Mesh I/O and sampling, procedural surfaces and farthest-point sampling.

Counterpart of ``sph_nca_tpu/utils/meshes.py``: ``load_obj``,
``normalize_mesh``, ``face_normals_areas``, ``vertex_normals``,
``sample_surface`` (the same numpy ``Generator`` draws, in the same order),
``save_ply``, ``load_ply_points``, ``fibonacci_sphere``, ``sphere_normals``
and ``torus_points`` are numpy with the same arithmetic, so their outputs are
bit-equal to the JAX package's; ``farthest_point_sampling`` runs in torch on
the points' device.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch


def load_obj(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Parse an OBJ file -> (vertices [V, 3] f32, faces [F, 3] i32).

    Handles 'v' and 'f' records; f entries may be v, v/vt, v/vt/vn, v//vn;
    polygons are fan-triangulated; negative indices are supported.
    """
    verts, faces = [], []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            if parts[0] == "v":
                verts.append([float(p) for p in parts[1:4]])
            elif parts[0] == "f":
                idx = []
                for p in parts[1:]:
                    vi = int(p.split("/")[0])
                    idx.append(vi - 1 if vi > 0 else len(verts) + vi)
                for i in range(1, len(idx) - 1):
                    faces.append([idx[0], idx[i], idx[i + 1]])
    return np.asarray(verts, np.float32), np.asarray(faces, np.int32)


def normalize_mesh(v: np.ndarray, scale: float = 1.0,
                   axis_swap: bool = True) -> np.ndarray:
    """The reference's mesh normalization (test.py:157-160): axes [z, x, y],
    centered, max-|coord| scaled to ``scale``."""
    v = v[..., [2, 0, 1]] if axis_swap else v
    v = v - v.mean(axis=-2)
    v = v / np.abs(v).max()
    return (v * scale).astype(np.float32)


def face_normals_areas(v: np.ndarray,
                       f: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Per-face unit normals [F, 3] and areas [F]."""
    e1 = v[f[:, 1]] - v[f[:, 0]]
    e2 = v[f[:, 2]] - v[f[:, 0]]
    cr = np.cross(e1, e2)
    nrm = np.linalg.norm(cr, axis=-1)
    area = 0.5 * nrm
    n = cr / np.maximum(nrm, 1e-20)[:, None]
    return n.astype(np.float32), area.astype(np.float32)


def vertex_normals(v: np.ndarray, f: np.ndarray) -> np.ndarray:
    """Area-weighted vertex normals [V, 3]."""
    fn, area = face_normals_areas(v, f)
    vn = np.zeros_like(v)
    w = fn * area[:, None]
    for c in range(3):
        np.add.at(vn, f[:, c], w)
    nrm = np.linalg.norm(vn, axis=-1, keepdims=True)
    return (vn / np.maximum(nrm, 1e-20)).astype(np.float32)


def sample_surface(v: np.ndarray, f: np.ndarray, n: int,
                   rng: Optional[np.random.Generator] = None
                   ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Uniform area-weighted surface samples -> (points [n, 3], face index
    [n], barycentric weights [n, 3]): an area CDF searched with uniform
    draws, then barycentric weights by the square-root trick."""
    rng = rng if rng is not None else np.random.default_rng(0)
    _, area = face_normals_areas(v, f)
    cdf = np.cumsum(area)
    cdf = cdf / cdf[-1]
    fi = np.searchsorted(cdf, rng.random(n))
    # uniform barycentric: u = 1-sqrt(r1), w2 = r2*sqrt(r1)
    r1 = np.sqrt(rng.random(n)).astype(np.float32)
    r2 = rng.random(n).astype(np.float32)
    w = np.stack([1.0 - r1, r1 * (1.0 - r2), r1 * r2], axis=-1)
    tri = v[f[fi]]  # [n, 3, 3]
    pts = np.einsum("nc,ncd->nd", w, tri).astype(np.float32)
    return pts, fi.astype(np.int64), w


_PLY_RECORD = [("xyz", np.float32, 3), ("rgba", np.uint8, 4)]


def save_ply(path: str, points: np.ndarray, rgba: np.ndarray) -> None:
    """Binary little-endian PLY with x/y/z float and rgba uchar per point
    (rgba in [0, 1] floats or uint8; rgb gets alpha 255)."""
    points = np.asarray(points, np.float32)
    rgba = np.asarray(rgba)
    if rgba.dtype != np.uint8:
        rgba = (np.clip(rgba, 0, 1) * 255).astype(np.uint8)
    if rgba.shape[-1] == 3:
        rgba = np.concatenate([rgba, np.full_like(rgba[:, :1], 255)],
                              axis=-1)
    n = points.shape[0]
    header = (
        "ply\nformat binary_little_endian 1.0\n"
        f"element vertex {n}\n"
        "property float x\nproperty float y\nproperty float z\n"
        "property uchar red\nproperty uchar green\nproperty uchar blue\n"
        "property uchar alpha\nend_header\n"
    )
    rec = np.zeros(n, dtype=_PLY_RECORD)
    rec["xyz"] = points
    rec["rgba"] = rgba
    with open(path, "wb") as fh:
        fh.write(header.encode("ascii"))
        fh.write(rec.tobytes())


def load_ply_points(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Read back a PLY written by ``save_ply`` -> (points, rgba)."""
    with open(path, "rb") as fh:
        header = b""
        while not header.endswith(b"end_header\n"):
            line = fh.readline()
            if not line:
                raise ValueError(f"{path}: no end_header")
            header += line
        n = int([ln for ln in header.decode().splitlines()
                 if ln.startswith("element")][0].split()[-1])
        rec = np.frombuffer(fh.read(), dtype=_PLY_RECORD, count=n)
    return rec["xyz"].copy(), rec["rgba"].copy()


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
