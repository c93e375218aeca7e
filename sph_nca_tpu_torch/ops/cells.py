"""Cell-dense SPH engine: the layout the pair-pass kernels run over.

Counterpart of ``sph_nca_tpu/ops/cells.py`` with ``xla_tables=False``.
Particles live in a cell-dense layout S [C, M, F]: one row block per
occupied SUBCELL (fat cells split into M=8-slot subcells),
Morton-ordered then regrouped by window size. Padded slots sit at PAD_POS, so
every kernel weight against them is exactly 0.

The pair kernels process one BLOCK of BG=8 consecutive subcells per program
against the union of their stencil windows ([BG*M, Wu*M] pair tiles). Blocks
come in two buckets sorted by union-window size (``blk_*``: the first ~75% at a
tight width, ``blk2_*``: the tail at the max width).

``n_shards`` > 1 lays the engine out for particle-axis sharding: the cell
count is padded to a multiple of 16 * n_shards, the blocks split into
``n_shards`` contiguous Morton ranges, and the window-size sort and the
bucket split run within each range with equal bucket sizes. Bucket rows are
then shard-major ([shard 0's bucket blocks, shard 1's, ...]) and each
shard's own cells are [its bucket-1 blocks | its bucket-2 blocks]; the
engine records ``n_shards`` so that ``ops/pair_kernel.py`` splits and
merges rows in that order, and ``parallel/cell_shard.py`` gives each rank
its shard.

The build runs in numpy on the host, exactly as the JAX build does, and the
results move to the device at the end. Integer layouts equal the JAX build's.
The optional pair tables (``pair_tables="float32" | "bfloat16"``) are computed
on the host in f32 too, in chunks of blocks, and cast on the engine's device.

Not ported (they serve only the XLA einsum path): the per-cell pair-weight
matrices ``Tw`` / ``Tg`` and the einsum operators.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from .. import resolve_device
from . import kernels as K
from .gather import gather_injective
from .hashgrid import _stencil_offsets

# Padded slot position: far enough that h^2 - d^2 is hugely negative and
# every smoothing kernel evaluates to exactly 0 in f32.
PAD_POS = 1.0e6

# Subcells per pair-kernel block: P = BG * M = 64 block rows.
BG = 8


@dataclasses.dataclass
class CellEngine:
    """Static per-geometry structure, as torch tensors on one device.

    C = number of (padded) subcells, M = slot capacity per subcell,
    W = window cell capacity, N = particles, P = BG*M block rows.
    Positions of the block structures are stored COORDINATE-MAJOR
    ([D, P] / [D, W]), in the frame of the block's first cell, with periodic
    shifts baked in.
    """

    slot_of_particle: torch.Tensor  # [N] int64 -> flat slot id (cell*M+slot)
    xs: torch.Tensor  # [C, M, D] cell-local slot positions (pad: PAD_POS)
    vs: torch.Tensor  # [C, M] slot volumes (pad: 0)
    win_cells: torch.Tensor  # [C, W] int32 cell ids (pad -> cell 0)
    xw: torch.Tensor  # [C, W*M, D] window positions, cell frame
    vw: torch.Tensor  # [C, W*M] window volumes
    # gsum_i = sigma_g sum_k mag_ik r_ik v_k, the self term of the SPH
    # gradient's adjoint (the perception's backward); 0 on pad slots
    gsum: torch.Tensor  # [C, M, D]
    blk_xs: torch.Tensor  # [nb1, D, P] block rows, block frame
    blk_win_cells: torch.Tensor  # [nb1, Wu1] int32
    blk_xw: torch.Tensor  # [nb1, D, Wu1*M]
    blk_vw: torch.Tensor  # [nb1, Wu1*M]
    blk2_xs: torch.Tensor  # [nb2, D, P]
    blk2_win_cells: torch.Tensor  # [nb2, Wu]
    blk2_xw: torch.Tensor  # [nb2, D, Wu*M]
    blk2_vw: torch.Tensor  # [nb2, Wu*M]
    # constants, float32-exact Python floats
    h: float
    sig_w: float  # smoothing normalization sigma_W
    sig_g: float  # gradient normalization sigma_g
    # OPTIONAL pair tables (build_cell_engine(pair_tables=...)), per block:
    # the displacement-scaled spiky factors md_d = mag * (xw_d - xb_d), rows
    # d-major, and the poly6 core w6 = max(h^2 - d2, 0)^3, in the table
    # dtype. With them the pair passes are products over stored tables, and
    # gsum above is re-derived from the quantized md (see _build_pair_tables).
    blk_md: Optional[torch.Tensor] = None  # [nb1, D*P, Wu1*M]
    blk_w6: Optional[torch.Tensor] = None  # [nb1, P, Wu1*M]
    blk2_md: Optional[torch.Tensor] = None  # [nb2, D*P, Wu*M]
    blk2_w6: Optional[torch.Tensor] = None  # [nb2, P, Wu*M]
    # the shard count the layout was built for (bucket rows shard-major)
    n_shards: int = 1

    @property
    def device(self) -> torch.device:
        return self.xs.device

    @property
    def num_cells(self) -> int:
        return self.win_cells.shape[0]

    @property
    def slots_per_cell(self) -> int:
        return self.xs.shape[1]

    @property
    def num_particles(self) -> int:
        return self.slot_of_particle.shape[0]

    # -- layout conversion -------------------------------------------------

    def scatter(self, A: torch.Tensor) -> torch.Tensor:
        """[..., N, F] particle-order values -> [..., C, M, F] cell layout
        (padded slots are zero); leading axes are batch axes."""
        c, m = self.num_cells, self.slots_per_cell
        lead, f = tuple(A.shape[:-2]), A.shape[-1]
        flat = A.new_zeros(lead + (c * m, f))
        flat[..., self.slot_of_particle, :] = A
        return flat.reshape(lead + (c, m, f))

    def gather_back(self, S: torch.Tensor) -> torch.Tensor:
        """[..., C, M, F] cell layout -> [..., N, F] particle order (its
        backward copies into the distinct slots, no accumulation)."""
        c, m = self.num_cells, self.slots_per_cell
        flat = S.reshape(tuple(S.shape[:-3]) + (c * m, S.shape[-1]))
        return gather_injective(flat, self.slot_of_particle, -2)

    # -- window gathers ----------------------------------------------------

    def window(self, S: torch.Tensor) -> torch.Tensor:
        """Per-cell window states: [C, M, F] -> [C, W*M, F] (one
        cell-granularity gather; padded entries read cell 0, whose values
        never contribute because their positions sit at PAD_POS)."""
        c, m = self.num_cells, self.slots_per_cell
        f = S.shape[-1]
        return S.reshape(c, m * f)[self.win_cells.long()].reshape(
            c, self.win_cells.shape[1] * m, f
        )

    def block_window(self, S: torch.Tensor, bucket: int = 1) -> torch.Tensor:
        """[C, M, F] -> [nb_i, Wu_i*M, F] union-window states of one
        bucket (one gather)."""
        c, m = self.num_cells, self.slots_per_cell
        f = S.shape[-1]
        wc = self.blk_win_cells if bucket == 1 else self.blk2_win_cells
        nb, wu = wc.shape
        return S.reshape(c, m * f)[wc.long()].reshape(nb, wu * m, f)


def _morton_code(c: np.ndarray) -> np.ndarray:
    """Interleave coordinate bits -> Z-order code. c: [C, D] non-negative."""
    c = np.asarray(c, np.int64)
    nbits = max(1, int(np.max(c)).bit_length())
    d = c.shape[1]
    code = np.zeros(len(c), np.int64)
    for bit in range(nbits):
        for ax in range(d):
            code |= ((c[:, ax] >> bit) & 1) << (d * bit + ax)
    return code


def _hilbert_code(c: np.ndarray) -> np.ndarray:
    """Hilbert-curve index of integer cells c [C, D] (vectorized Skilling
    AxesToTranspose, AIP CP 707:381, 2004)."""
    X = np.array(c, np.int64, copy=True)
    n, d = X.shape
    if d == 1:
        return X[:, 0].copy()
    nbits = max(1, int(np.max(X)).bit_length())
    M = np.int64(1) << (nbits - 1)

    # inverse undo excess work
    Q = M
    while Q > 1:
        P = Q - 1
        for i in range(d):
            hi = (X[:, i] & Q) != 0
            t = np.where(hi, 0, (X[:, 0] ^ X[:, i]) & P)
            X[:, 0] = np.where(hi, X[:, 0] ^ P, X[:, 0]) ^ t
            X[:, i] ^= t
        Q >>= 1

    # Gray encode
    for i in range(1, d):
        X[:, i] ^= X[:, i - 1]
    t = np.zeros(n, np.int64)
    Q = M
    while Q > 1:
        t = np.where((X[:, d - 1] & Q) != 0, t ^ (Q - 1), t)
        Q >>= 1
    for i in range(d):
        X[:, i] ^= t

    # transpose form -> scalar index: bit b of axis i lands at b*D + (D-1-i)
    code = np.zeros(n, np.int64)
    for bit in range(nbits):
        for i in range(d):
            code |= ((X[:, i] >> bit) & 1) << (bit * d + (d - 1 - i))
    return code


def build_cell_engine(
    x,
    h: float,
    *,
    period=None,
    smoothing: str = "poly6",
    gradient_kernel: str = "spiky",
    pair_tables: Optional[str] = None,
    w6_only: bool = False,
    n_shards: int = 1,
    device="cuda",
) -> CellEngine:
    """Build the engine for concrete positions ``x`` [N, D] (host-side,
    one-time), then move it to ``device``.

    Same layout as ``sph_nca_tpu.ops.cells.build_cell_engine(x, h,
    period=..., n_shards=..., xla_tables=False, pair_tables=...)`` with its
    default capacities (M = 8 slots per subcell, the cell count padded to a
    multiple of 16 * n_shards). Cells are keyed by their true floor
    coordinates; for periodic domains cells tile the period exactly
    (cell_size_d = period_d / floor(period_d / h)) and window copies of
    wrapped cells carry a whole-period shift.

    ``pair_tables``: None (the kernels recompute the pair weights every
    pass), "float32" or "bfloat16" (store them once per block; the pair
    passes then run over the tables, 4 * nb * P * W * itemsize bytes).
    ``w6_only`` stores the poly6 table alone (nb * P * W * itemsize bytes):
    what the mask and the blur read. Such an engine serves a blur at another
    radius (the surface rollout's tangent diffusion and seeding); its
    perception would recompute the pair weights.

    ``n_shards`` lays the blocks out for particle-axis sharding (see the
    module docstring); the pair passes of ``ops/pair_kernel.py`` read the
    layout from ``eng.n_shards``.
    """
    # the pair kernels and tables hard-wire the poly6 / spiky pair math
    if smoothing != "poly6" or gradient_kernel != "spiky":
        raise NotImplementedError(
            f"CellEngine implements poly6/spiky only (got {smoothing!r}/"
            f"{gradient_kernel!r}); use ops.bands.build_band_engine or "
            "ops.hashgrid.build_graph for other kernels"
        )
    if pair_tables not in (None, "float32", "bfloat16"):
        raise ValueError(f"pair_tables must be None, 'float32' or "
                         f"'bfloat16', got {pair_tables!r}")
    dev = resolve_device(device)
    x = np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x, np.float32)
    n, d = x.shape

    per = None if period is None else np.broadcast_to(
        np.asarray(period, np.float64), (d,)
    ).astype(np.float64)
    if per is not None:
        ncell = np.maximum(np.floor(per / h).astype(np.int64), 3)
        cell_size = per / ncell
    else:
        ncell = None
        cell_size = np.full(d, float(h), np.float64)

    fl = np.floor(x.astype(np.float64) / cell_size).astype(np.int64)  # [N, D]
    fl_canon = np.mod(fl, ncell) if per is not None else fl

    # occupied cells, renumbered in Morton order
    occ, inv, counts = np.unique(
        fl_canon, axis=0, return_inverse=True, return_counts=True
    )
    inv = inv.ravel()
    n_geo = len(occ)
    perm = np.argsort(_morton_code(occ - occ.min(axis=0)), kind="stable")
    occ = occ[perm]
    counts = counts[perm]
    newid = np.empty(n_geo, np.int64)
    newid[perm] = np.arange(n_geo)
    inv = newid[inv]

    # subcell split: at most M slots per subcell
    M = 8
    n_sub = np.maximum(1, -(-counts // M))
    sub_start = np.concatenate([[0], np.cumsum(n_sub)])
    C = int(sub_start[-1])
    geo_of_sub = np.repeat(np.arange(n_geo), n_sub)
    occ_geo = occ
    occ = occ[geo_of_sub]

    order = np.argsort(inv, kind="stable")
    cell_starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    slot_in_cell = np.zeros(n, np.int64)
    slot_in_cell[order] = np.arange(n) - np.repeat(cell_starts, counts)
    sub_of_particle = sub_start[inv] + slot_in_cell // M
    slot_of_particle = sub_of_particle * M + slot_in_cell % M
    inv = sub_of_particle

    # cell-local positions
    origins = occ.astype(np.float64) * cell_size  # [C, D]
    xs = np.full((C + 1, M, d), PAD_POS, np.float32)
    if per is not None:
        x_canon = x.astype(np.float64) - (fl - fl_canon) * cell_size
    else:
        x_canon = x.astype(np.float64)
    xs.reshape(-1, d)[slot_of_particle] = (x_canon - origins[inv]).astype(
        np.float32
    )

    # ---- windows: stencil hits resolved with one searchsorted ------------
    offsets = _stencil_offsets(d)
    n_off = len(offsets)
    fmin = occ_geo.min(axis=0)
    span = occ_geo.max(axis=0) - fmin + 1
    strides = np.cumprod(np.concatenate([[1], span[::-1][:-1]]))[::-1]
    key_order = np.argsort(occ_geo @ strides, kind="stable")
    keys_sorted = (occ_geo @ strides)[key_order] - fmin @ strides

    T = occ[:, None, :] + offsets[None, :, :]  # [C, n_off, D] true floors
    if per is not None:
        t_canon = np.mod(T, ncell)
        wrap_f = ((T - t_canon) // ncell).astype(np.float64) * per
    else:
        t_canon = T
        wrap_f = np.zeros(T.shape, np.float64)
    in_range = np.all((t_canon >= fmin) & (t_canon < fmin + span), axis=-1)
    q_key = (t_canon - fmin) @ strides
    pos = np.minimum(np.searchsorted(keys_sorted, q_key), len(keys_sorted) - 1)
    found = in_range & (keys_sorted[pos] == q_key)
    g = np.where(found, key_order[pos], 0)
    cnt = np.where(found, n_sub[g], 0).ravel()

    E = int(cnt.sum())
    ent_rows = np.repeat(np.arange(C * n_off), cnt)
    ent_c = ent_rows // n_off
    grp_start = np.concatenate([[0], np.cumsum(cnt)[:-1]])
    ent_j = sub_start[g.ravel()[ent_rows]] + (
        np.arange(E) - np.repeat(grp_start, cnt)
    )
    wcnt = np.bincount(ent_c, minlength=C)

    # pad the cell count to a multiple of 16 * n_shards, so that every
    # shard holds whole blocks (BG = 8 -> nb a multiple of 2 * n_shards);
    # padding cells have empty windows and PAD_POS slots
    n_shards = max(1, int(n_shards))
    pad_mult = 16 * n_shards
    C_pad = int(math.ceil(C / pad_mult)) * pad_mult
    if C_pad != C:
        xs = np.concatenate(
            [xs[:C], np.full((C_pad - C, M, d), PAD_POS, np.float32), xs[C:]]
        )

    Wc = int(wcnt.max())
    win_cells = np.zeros((C_pad, Wc), np.int32)
    win_shift = np.full((C_pad, Wc, d), PAD_POS, np.float32)
    ent_shift = (
        origins[ent_j] + wrap_f.reshape(-1, d)[ent_rows] - origins[ent_c]
    ).astype(np.float32)
    wstart = np.concatenate([[0], np.cumsum(wcnt)[:-1]])
    wpos = np.arange(E) - np.repeat(wstart, wcnt)
    win_cells[ent_c, wpos] = ent_j
    win_shift[ent_c, wpos] = ent_shift
    C = C_pad

    xw = (xs[win_cells] + win_shift[:, :, None, :]).reshape(C, Wc * M, d)

    # ---- block structure: BG consecutive cells share a union window -----
    nb = C // BG
    origins_pad = np.zeros((C, d))
    origins_pad[: len(origins)] = origins
    ent_b = ent_c // BG
    # one f64 -> f32 rounding of the block-frame total shift, so the self
    # copy of a row's own subcell is bitwise equal to the row position
    ent_total = (
        origins[ent_j] + wrap_f.reshape(-1, d)[ent_rows]
        - origins_pad[ent_b * BG]
    ).astype(np.float32)
    qshift = np.round(ent_total / max(float(h), 1e-9)).astype(np.int64)
    uniq, first = np.unique(
        np.concatenate([ent_b[:, None], ent_j[:, None], qshift], axis=1),
        axis=0, return_index=True,
    )
    u_b = uniq[:, 0]
    u_j = uniq[:, 1]
    u_total = ent_total[first]
    sizes = np.bincount(u_b, minlength=nb)

    # ---- window-size bucketing: blocks sorted by union size, within each
    # shard's contiguous Morton range ---------------------------------------
    nb_loc = nb // n_shards
    border = np.concatenate([
        s * nb_loc + np.argsort(sizes[s * nb_loc:(s + 1) * nb_loc],
                                kind="stable")
        for s in range(n_shards)])
    old_cells = (border[:, None] * BG + np.arange(BG)).reshape(-1)
    newid = np.empty(C, np.int64)
    newid[old_cells] = np.arange(C)
    xs = np.concatenate([xs[:C][old_cells], xs[C:]])
    origins_pad = origins_pad[old_cells]
    win_cells = newid[win_cells[old_cells]].astype(np.int32)
    xw = xw[old_cells]
    slot_of_particle = newid[slot_of_particle // M] * M + slot_of_particle % M
    inv_border = np.empty(nb, np.int64)
    inv_border[border] = np.arange(nb)
    u_b = inv_border[u_b]
    u_j = newid[u_j]
    sizes = sizes[border]

    # bucket split at ~p75, at the same count in every shard
    sizes_sh = sizes.reshape(n_shards, nb_loc)
    nb1_loc = int(np.clip(round(0.75 * nb_loc), 1, nb_loc))
    if np.all(sizes_sh[:, nb1_loc - 1] == sizes_sh[:, -1]):
        nb1_loc = nb_loc  # no tail to separate anywhere
    nb1 = n_shards * nb1_loc
    b1_idx, b2_idx = bucket_blocks(nb, nb1, n_shards)
    Wu1 = max(1, int(sizes[b1_idx].max()))
    Wu = max(1, int(sizes.max()))
    if nb1 == nb:
        Wu1 = Wu

    blk_win_cells = np.zeros((nb, Wu), np.int32)
    blk_shift = np.full((nb, Wu, d), PAD_POS, np.float32)
    ord_u = np.argsort(u_b, kind="stable")
    ub_s = u_b[ord_u]
    bcnt = np.bincount(ub_s, minlength=nb)
    bstart = np.concatenate([[0], np.cumsum(bcnt)[:-1]])
    bpos = np.arange(len(ub_s)) - np.repeat(bstart, bcnt)
    blk_win_cells[ub_s, bpos] = u_j[ord_u]
    blk_shift[ub_s, bpos] = u_total[ord_u]

    blk_xw_full = xs[blk_win_cells] + blk_shift[:, :, None, :]  # [nb,Wu,M,D]
    row_shift = origins_pad - origins_pad[(np.arange(C) // BG) * BG]
    blk_xs_full = (xs[:C] + row_shift[:, None, :].astype(np.float32)).reshape(
        nb, BG * M, d
    ).transpose(0, 2, 1)  # [nb, D, P]

    def bucket_arrays(idx, wu):
        wc = np.ascontiguousarray(blk_win_cells[idx, :wu])
        bxw = blk_xw_full[idx, :wu].reshape(len(idx), wu * M, d)
        return (wc, np.ascontiguousarray(bxw.transpose(0, 2, 1)),
                np.ascontiguousarray(blk_xs_full[idx]))

    # bucket rows are shard-major: [shard 0's bucket blocks, shard 1's, ...]
    win1, xw1, xs1 = bucket_arrays(b1_idx, Wu1)
    win2, xw2, xs2 = bucket_arrays(b2_idx, Wu)

    h32 = np.float32(h)
    sig_w = np.float32(K.poly6_norm(h, d))
    sig_g = np.float32(K.spiky_norm(h, d))

    # volumes v = 1 / (sigma_W sum_w W(d2)) from the block structures; the
    # union window is a superset of each row's cell window and the extra
    # entries lie beyond h, where W == 0
    inv_vol = np.empty((nb, BG * M), np.float32)  # block order == cell order
    inv_vol[b1_idx] = _blk_vol_rows(xs1, xw1, h32, sig_w)
    inv_vol[b2_idx] = _blk_vol_rows(xs2, xw2, h32, sig_w)
    pad_slot = (xs[:C] >= PAD_POS / 2).any(-1)  # [C, M]
    v = np.where(inv_vol > 0.0, 1.0 / np.maximum(inv_vol, 1e-30), 0.0)
    vs = np.where(pad_slot, 0.0, v.reshape(C, M)).astype(np.float32)
    vw = vs[win_cells].reshape(C, Wc * M)
    blk_vw = vs[win1].reshape(win1.shape[0], win1.shape[1] * M)
    blk2_vw = vs[win2].reshape(win2.shape[0], win2.shape[1] * M)
    gsum = np.empty((nb, BG * M, d), np.float32)
    gsum[b1_idx] = _blk_gsum_rows(xs1, xw1, blk_vw, h32, sig_g)
    gsum[b2_idx] = _blk_gsum_rows(xs2, xw2, blk2_vw, h32, sig_g)
    gsum = gsum.reshape(C, M, d)
    gsum = np.where(pad_slot[..., None], np.float32(0.0), gsum)

    def t(a, dtype=torch.float32):
        return torch.as_tensor(np.ascontiguousarray(a)).to(dtype=dtype,
                                                           device=dev)

    eng = CellEngine(
        slot_of_particle=t(slot_of_particle, torch.int64),
        xs=t(xs[:C]),
        vs=t(vs),
        win_cells=t(win_cells, torch.int32),
        xw=t(xw),
        vw=t(vw),
        gsum=t(gsum),
        blk_xs=t(xs1),
        blk_win_cells=t(win1, torch.int32),
        blk_xw=t(xw1),
        blk_vw=t(blk_vw),
        blk2_xs=t(xs2),
        blk2_win_cells=t(win2, torch.int32),
        blk2_xw=t(xw2),
        blk2_vw=t(blk2_vw),
        h=float(h32),
        sig_w=float(sig_w),
        sig_g=float(sig_g),
        n_shards=n_shards,
    )
    if w6_only and pair_tables is None:
        raise ValueError("w6_only needs pair_tables")
    if pair_tables is not None:
        eng = _build_pair_tables(eng, getattr(torch, pair_tables),
                                 md=not w6_only)
    return eng


def bucket_blocks(nb: int, nb1: int, n_shards: int):
    """Block ids of the two window-size buckets, in bucket-row order: each
    shard's first nb1 / n_shards blocks are bucket 1, the rest bucket 2,
    shard-major."""
    nb_loc, nb1_loc = nb // n_shards, nb1 // n_shards
    blocks = np.arange(nb).reshape(n_shards, nb_loc)
    return blocks[:, :nb1_loc].reshape(-1), blocks[:, nb1_loc:].reshape(-1)


def _blk_vol_rows(xs_b: np.ndarray, xw_b: np.ndarray, h, sig_w,
                  chunk: int = 64) -> np.ndarray:
    """Inverse volumes per block row, sig_W sum_w W(d2) -> [nb, P], in f32
    with d2 from direct per-axis differences (chunked over blocks)."""
    out = np.zeros((xs_b.shape[0], xs_b.shape[2]), np.float32)
    for c0 in range(0, xs_b.shape[0], chunk):
        diff = xw_b[c0 : c0 + chunk, :, None, :] - xs_b[c0 : c0 + chunk, :, :, None]
        d2 = diff[:, 0] * diff[:, 0]
        for ax in range(1, diff.shape[1]):
            d2 = d2 + diff[:, ax] * diff[:, ax]
        c = np.maximum(h * h - d2, np.float32(0.0))
        out[c0 : c0 + chunk] = sig_w * np.sum(c * c * c, axis=-1)
    return out


def _blk_gsum_rows(xs_b: np.ndarray, xw_b: np.ndarray, vw_b: np.ndarray, h,
                   sig_g, chunk: int = 64) -> np.ndarray:
    """The adjoint's self term per block row, sig_g sum_w mag v_w (xw - xb)
    -> [nb, P, D], in f32 (chunked over blocks).

    mag = 3(h-d)^2/d in the sqrt/divide form the JAX build uses, not the
    kernels' rsqrt form. The self copy of a row has d2 == 0 exactly (the
    build rounds each block-frame shift once) and adds nothing."""
    nb, d, p = xs_b.shape
    out = np.zeros((nb, p, d), np.float32)
    for c0 in range(0, nb, chunk):
        diff = xw_b[c0 : c0 + chunk, :, None, :] - xs_b[c0 : c0 + chunk, :, :, None]
        d2 = diff[:, 0] * diff[:, 0]
        for ax in range(1, d):
            d2 = d2 + diff[:, ax] * diff[:, ax]
        dist = np.sqrt(np.where(d2 > 0.0, d2, np.float32(1.0)))
        inside = (d2 > 0.0) & (dist < h)
        mag = np.where(inside, 3.0 * (h - dist) ** 2 / dist, np.float32(0.0))
        t = sig_g * mag * vw_b[c0 : c0 + chunk, None, :]
        out[c0 : c0 + chunk] = np.einsum("npw,ndpw->npd", t, diff)
    return out


def _blk_pair_mats(xs_b: np.ndarray, xw_b: np.ndarray, h,
                   md: bool = True) -> tuple:
    """Per-block pair tables in f32: md [nb, D*P, W] = mag * (xw_d - xb_d),
    rows d-major (None unless ``md``), and w6 [nb, P, W] = max(h^2 - d2,
    0)^3. d2 comes from direct per-axis differences, and mag = 3(h-d)^2/d in
    the sqrt/divide form of the JAX build (numpy's sqrt rounds correctly, as
    XLA's does)."""
    diff = xw_b[:, :, None, :] - xs_b[:, :, :, None]  # [nb, D, P, W]
    d2 = diff[:, 0] * diff[:, 0]
    for ax in range(1, diff.shape[1]):
        d2 = d2 + diff[:, ax] * diff[:, ax]
    if not md:
        c = np.maximum(h * h - d2, np.float32(0.0))
        return None, c * c * c
    dist = np.sqrt(np.where(d2 > 0.0, d2, np.float32(1.0)))
    inside = (d2 > 0.0) & (dist < h)
    mag = np.where(inside, np.float32(3.0) * (h - dist) ** 2 / dist,
                   np.float32(0.0))
    c = np.maximum(h * h - d2, np.float32(0.0))
    nb, ddim, p, w = diff.shape
    return (mag[:, None] * diff).reshape(nb, ddim * p, w), c * c * c


def _blk_gsum_from_tables(md: torch.Tensor, vw_b: torch.Tensor,
                          sig_g: torch.Tensor, ddim: int) -> torch.Tensor:
    """The adjoint's self term re-derived from the QUANTIZED table,
    gsum[p, d] = sig_g sum_w md_q[d*P + p, w] v_w -> [nb, P, D]. The table
    forward subtracts A_p gsum_p as its rowsum correction, so a constant
    field cancels to f32-accumulation noise; the exact-f32 gsum would leave
    |A| times the table's rounding. A plain product and sum, not a matmul,
    so the global TF32 setting cannot round it."""
    nb, dp, _ = md.shape
    rows = sig_g * (md.float() * vw_b[:, None, :]).sum(-1)
    return rows.reshape(nb, ddim, dp // ddim).transpose(1, 2)


def _build_pair_tables(eng: CellEngine, dtype: torch.dtype,
                       chunk: int = 64, md: bool = True) -> CellEngine:
    """Compute the per-block pair tables of both buckets on the host in f32
    (chunks of ``chunk`` blocks), cast them to ``dtype`` on the engine's
    device (round to nearest even), and replace ``gsum`` with the one derived
    from the quantized table. Without ``md`` only w6 is built, and ``gsum``
    stays the engine's.

    The rows of pad slots are zero, so every table pass gives them exactly
    0 (the JAX build keeps their phantom pairs with the union window's unused
    entries; no consumer reads those rows)."""
    c, m, d = eng.xs.shape
    p = eng.blk_xs.shape[2]
    h = np.float32(eng.h)
    sig_g = torch.tensor(eng.sig_g, dtype=torch.float32, device=eng.device)

    def run(xs_b, xw_b, vw_b, real):
        xs_h, xw_h = xs_b.cpu().numpy(), xw_b.cpu().numpy()
        mds, w6s, gss = [], [], []
        for c0 in range(0, xs_h.shape[0], chunk):
            mdc, w6 = _blk_pair_mats(xs_h[c0:c0 + chunk],
                                     xw_h[c0:c0 + chunk], h, md=md)
            # pad rows get empty rows: their slot sits at PAD_POS, where
            # the union window's unused entries (cell 0's volumes, shifted
            # to PAD_POS) would otherwise pair with it
            keep = real[c0:c0 + chunk]  # [nb, P]
            w6 = np.where(keep[:, :, None], w6, np.float32(0.0))
            w6s.append(torch.from_numpy(w6).to(eng.device).to(dtype))
            if not md:
                continue
            mdc = np.where(np.tile(keep, (1, d))[:, :, None], mdc,
                           np.float32(0.0))
            mdc = torch.from_numpy(mdc).to(eng.device).to(dtype)
            mds.append(mdc)
            gss.append(_blk_gsum_from_tables(mdc, vw_b[c0:c0 + chunk], sig_g,
                                             d))
        w = xw_b.shape[2]
        if not w6s:
            return (xs_b.new_zeros((0, d * p, w), dtype=dtype),
                    xs_b.new_zeros((0, p, w), dtype=dtype),
                    xs_b.new_zeros((0, p, d)))
        if not md:
            return None, torch.cat(w6s), None
        return torch.cat(mds), torch.cat(w6s), torch.cat(gss)

    real = (eng.vs > 0).reshape(-1, p).cpu().numpy()
    nb = real.shape[0]
    b1_idx, b2_idx = bucket_blocks(nb, eng.blk_xs.shape[0], eng.n_shards)
    md1, w61, gs1 = run(eng.blk_xs, eng.blk_xw, eng.blk_vw, real[b1_idx])
    md2, w62, gs2 = run(eng.blk2_xs, eng.blk2_xw, eng.blk2_vw, real[b2_idx])
    if not md:
        return dataclasses.replace(eng, blk_w6=w61, blk2_w6=w62)
    gsum = gs1.new_empty((nb, p, d))
    gsum[torch.as_tensor(b1_idx, device=gsum.device)] = gs1
    gsum[torch.as_tensor(b2_idx, device=gsum.device)] = gs2
    gsum = gsum.reshape(c, m, d).contiguous()
    return dataclasses.replace(eng, blk_md=md1, blk_w6=w61, blk2_md=md2,
                               blk2_w6=w62, gsum=gsum)
