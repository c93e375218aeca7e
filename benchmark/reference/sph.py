"""SPH operators of the reference, written from their definitions.

Every pair (i, j) with |x_j - x_i| < h counts, the self pair included. The
smoothing kernel is poly6, W(r) = (h^2 - r^2)^3 with sigma_W = 315 / (64 pi
h^9); the gradient kernel is spiky, 3 (h - r)^2 (x_j - x_i) / r with sigma_g =
15 / (pi h^6) (both in 3D: the plane's points carry z = 0). The volume of a
particle is v_i = 1 / (sigma_W sum_j W_ij). Then

    blur(Y)_i     = sigma_W sum_j W_ij v_j Y_j
    gradient(X)_i = sigma_g sum_j v_j gk(x_j - x_i) (X_j - X_i)

Pair weights are worked out in float64 from the float32 positions and
stored in the precision under test; every sum is a float32 sum of products
of values in that precision (``quantize``), as a product of two bfloat16 or
TF32 numbers is exact in float32. The sums run as sparse products
(``torch.sparse.mm``), differentiable in the dense operand.
"""

from __future__ import annotations

import math

import torch

FP8_MAX = 448.0  # the largest float8 e4m3 value


def quantize(t: torch.Tensor, precision: str) -> torch.Tensor:
    """t rounded to ``precision`` and returned as float32: float32 (as is),
    bfloat16, tf32 (10 mantissa bits, to nearest even) or fp8 (e4m3 with one
    scale for the whole tensor, its largest magnitude at 448). A gradient
    passes through the rounding unchanged."""
    t = t.float()
    if precision == "float32":
        return t
    with torch.no_grad():
        if precision == "bfloat16":
            q = t.to(torch.bfloat16).float()
        elif precision == "tf32":
            bits = t.view(torch.int32).to(torch.int64)
            bits = (bits + 0xFFF + ((bits >> 13) & 1)) & ~0x1FFF
            q = bits.to(torch.int32).view(torch.float32)
        elif precision == "fp8":
            scale = t.abs().amax().clamp_min(1e-30) / FP8_MAX
            q = (t / scale).to(torch.float8_e4m3fn).float() * scale
        else:
            raise ValueError(f"unknown precision {precision!r}")
    # the rounded value forward, the identity backward
    return q if not t.requires_grad else t + (q - t).detach()


def pairs_within(x: torch.Tensor, h: float):
    """(i, j, dx = x_j - x_i [E, D] float64, d2 [E] float64) of every pair
    within h: the points sorted into cells of side h, each point's
    candidates the points of the 3^D cells around its own, kept where the
    exact distance is under h."""
    x64 = x.double()
    n, d = x64.shape
    cell = torch.floor(x64 / h).long()
    cell = cell - cell.min(dim=0).values + 1  # a margin of one empty cell
    span = cell.max(dim=0).values + 2
    strides = torch.ones(d, dtype=torch.long, device=x.device)
    for a in range(d - 2, -1, -1):
        strides[a] = strides[a + 1] * span[a + 1]
    key = (cell * strides).sum(-1)
    order = torch.argsort(key)
    sorted_keys = key[order]
    offsets = torch.cartesian_prod(*[torch.tensor([-1, 0, 1],
                                                  device=x.device)] * d)
    ii, jj = [], []
    for off in offsets.reshape(-1, d):
        want = key + (off * strides).sum()
        lo = torch.searchsorted(sorted_keys, want)
        hi = torch.searchsorted(sorted_keys, want, right=True)
        count = hi - lo
        i = torch.repeat_interleave(torch.arange(n, device=x.device), count)
        first = torch.repeat_interleave(lo - torch.cumsum(count, 0) + count,
                                        count)
        j = order[first + torch.arange(i.numel(), device=x.device)]
        ii.append(i)
        jj.append(j)
    i, j = torch.cat(ii), torch.cat(jj)
    dx = x64[j] - x64[i]
    d2 = torch.sum(dx * dx, dim=-1)
    keep = d2 < h * h
    i, j, dx, d2 = i[keep], j[keep], dx[keep], d2[keep]
    by_row = torch.argsort(i * n + j)
    return i[by_row], j[by_row], dx[by_row], d2[by_row]


class Operators:
    """The blur and gradient of one point cloud at one precision."""

    def __init__(self, x: torch.Tensor, h: float, precision: str):
        self.n = x.shape[0]
        self.precision = precision
        i, j, dx, d2 = pairs_within(x, h)
        self.pairs = int(i.numel())
        self.sig_w = 315.0 / (64.0 * math.pi * h ** 9)
        self.sig_g = 15.0 / (math.pi * h ** 6)
        w = (h * h - d2) ** 3
        inv_v = self.sig_w * torch.zeros(self.n, dtype=torch.float64,
                                         device=x.device).index_add_(0, i, w)
        self.v = 1.0 / inv_v
        vj = self.v[j]
        r = torch.sqrt(torch.where(d2 > 0, d2, torch.ones_like(d2)))
        mag = torch.where(d2 > 0, 3.0 * (h - r) ** 2 / r,
                          torch.zeros_like(r))
        idx = torch.stack([i, j])
        self.w6 = self._matrix(idx, w * vj)
        self.md = [self._matrix(idx, mag * dx[:, a] * vj)
                   for a in range(x.shape[1])]
        # the row sums of the stored md weights: the gradient's X_i term
        self.md_rows = [torch.sparse.sum(m, dim=1).to_dense()
                        for m in self.md]

    def _matrix(self, idx, values) -> torch.Tensor:
        vals = quantize(values.float(), self.precision)
        return torch.sparse_coo_tensor(idx, vals, (self.n, self.n),
                                       check_invariants=False).coalesce()

    def _sum(self, m: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
        """sum_j m_ij X_j for X [B, N, K] (quantized first) -> [B, N, K]."""
        b, n, k = X.shape
        Xq = quantize(X, self.precision)
        cols = Xq.permute(1, 0, 2).reshape(n, b * k)
        return torch.sparse.mm(m, cols).reshape(n, b, k).permute(1, 0, 2)

    def blur(self, Y: torch.Tensor) -> torch.Tensor:
        """Y [B, N, K] -> [B, N, K]."""
        return self.sig_w * self._sum(self.w6, Y)

    def gradient(self, X: torch.Tensor) -> torch.Tensor:
        """X [B, N, F] -> [B, N, F, D]."""
        Xq = quantize(X, self.precision)
        return torch.stack(
            [self.sig_g * (self._sum(m, X) - Xq * rs[None, :, None])
             for m, rs in zip(self.md, self.md_rows)], dim=-1)
