"""Band SPH engine: curve-banded pair tables, the default engine of both CLIs.

Counterpart of ``sph_nca_tpu/ops/bands.py``. Particles are sorted by the
Hilbert (or Morton) rank of their cell and grouped into blocks of P = 64
consecutive rows, with no slot padding. Every pair weight, the source volume
v_j included, is baked into static tables once per geometry:

  * the BAND table [nb, 3P, (D+1)P] covers the pairs whose blocks are
    curve-adjacent: window rows w = slot*P + row_j over blocks b-1, b, b+1
    (two rolls and a concat, no gather), columns c*P + row_i holding
    md_c = mag * r_c * v_j for c < D and the smoothing core W(d2) * v_j for
    c = D. Entries of non-neighbour pairs are exactly 0;
  * the FAR tables cover the rest, per block a compacted list of groups of
    g curve-consecutive particles that hold a neighbour, gathered at group
    granularity (one gather for every bucket, over ``far_index``); blocks
    are bucketed by list width (``_bucket_cuts``) and the buckets' outputs
    are put back in block order by ``far_perm``.

The far gather, the ``far_perm`` combine and ``gather_back`` have backward
passes that sum in a fixed order (``ops/gather.py``: a reverse map of the
group lists, the inverse of the permutation, a copy into distinct slots), so
two runs of one seed give the same gradients bit for bit on the card.

Every pair pass is then one batched product contracting over the window
axis, ``torch.bmm`` of a table's transposed column slice (a strided view,
never copied) with the window states [nb, W, L]. The band passes have no
Pallas kernel in the JAX package (they are ``jax.lax.dot_general`` calls
outside any Pallas body), so the library product is their route on the card
too; the batched step's update MLP stays kernel 2.8 (``ops/mlp_kernel.py``).

Numerics, as the JAX package: the right-hand side is cast to the table dtype
before the product, and every product sums in float32. On the card a
bfloat16 product is ``torch.bmm(..., out_dtype=torch.float32)``; the plain
CPU version upcasts both operands to float32 (a product of two bfloat16
numbers is exact in float32, so it computes the same sums; the CPU has no
``bmm`` with another output dtype). ``out_dtype=bfloat16`` rounds the
gradient moments and the gradient, as the JAX package's does.

The products read each table once for all B samples: their right-hand
sides hold every sample in their columns, the lane layout [nb, P, B*F]
(rows of each block; each row's lanes sample-major, feature-minor). The
port's batched step holds its states in the sample layout [B, nb, P, F];
``perceive_band_samples``, ``mask_blur_band_samples`` and
``blur_band_samples`` (reached through ``ops/batched.py``) take that layout,
move the state into lanes with one permuting copy a pass, and hand
per-sample results back. ``perceive_band_batched`` and ``mask_blur_band``
are the same functions in the JAX package's lane layout.

The build (``build_band_engine``) is host numpy plus the native library of
``sph_nca_tpu_torch/native`` (no numpy fallback), bit for bit the JAX
package's tables, moved to the device once. Left out: ``split_d`` of
``perceive_band_batched`` (a sublane-to-lane relayout workaround for the
TPU); its ``extra`` lanes (a blur riding the smoothing product, used by the
JAX package's fused diffusion schedule, which the port's surface rollouts
do not run); the far real-row mask ``far_vwmask`` (the port gathers the far
alive columns instead); the numpy fallbacks of the build, and its profiling
ticks.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from .. import native, resolve_device
from ..utils.profiling import count, is_recording, span
from . import kernels as K
from .cells import PAD_POS, _hilbert_code, _morton_code
from .gather import gather_injective, gather_rows, permute_rows

ALIVE_THRESHOLD = 0.1  # reference nca.py:19,78


@dataclasses.dataclass
class BandEngine:
    """Static per-geometry band structure, as torch tensors on one device.

    nb = number of row blocks, P = rows (particles) per block, D = spatial
    dims, R = nb * P ranks, N = particles. Field names and shape helpers
    mirror ``CellEngine`` (nb blocks for C cells, P rows for M slots) so the
    batched step and rollouts run on either engine.
    """

    slot_of_particle: torch.Tensor  # [N] int64 particle -> rank b*P + row
    xs: torch.Tensor  # [nb, P, D] rank-ordered positions (pad: PAD_POS)
    vs: torch.Tensor  # [nb, P] volumes (pad: 0)
    # [nb, 3P, (D+1)P] in the table dtype: window row w = slot*P + row_j of
    # the rolled blocks b-1 / b / b+1; column c*P + row_i holds md_c for
    # c < D and W(d2) v_j for c = D
    Tband: torch.Tensor
    # sigma_g * the row sums of the quantized md columns: the gradient's
    # self term (a constant field cancels up to summation noise)
    gsum: torch.Tensor  # [nb, P, D] float32
    nbr_count: torch.Tensor  # [nb, P] int32, neighbours within h incl. self
    far_blocks: Tuple[torch.Tensor, ...]  # per bucket [nbt] int64 block ids
    far_groups: Tuple[torch.Tensor, ...]  # [nbt, Wt] int64 (pad: group 0)
    far_tabs: Tuple[torch.Tensor, ...]  # [nbt, Wt*g, (D+1)P] like Tband
    # block order = concat(bucket outputs + zero rows)[far_perm]
    far_perm: torch.Tensor  # [nb] int64
    # every bucket's group list flattened, in bucket order: the one far
    # gather of a pass (its reverse map is built on the first backward)
    far_index: torch.Tensor  # [sum nbt * Wt] int64
    # constants, float32-exact Python floats
    h: float
    sig_w: float  # smoothing normalization sigma_W
    sig_g: float  # gradient normalization sigma_g

    # -- shape helpers (CellEngine-compatible) ------------------------------

    @property
    def device(self) -> torch.device:
        return self.xs.device

    @property
    def num_cells(self) -> int:
        return self.xs.shape[0]

    @property
    def slots_per_cell(self) -> int:
        return self.xs.shape[1]

    @property
    def num_particles(self) -> int:
        return self.slot_of_particle.shape[0]

    @property
    def dim(self) -> int:
        return self.xs.shape[2]

    @property
    def far_group_size(self) -> int:
        for grp, tab in zip(self.far_groups, self.far_tabs):
            if grp.shape[1]:
                return tab.shape[1] // grp.shape[1]
        return 1

    def table_bytes(self) -> Tuple[int, int]:
        """(band table bytes, far table bytes)."""
        return (self.Tband.numel() * self.Tband.element_size(),
                sum(t.numel() * t.element_size() for t in self.far_tabs))

    # -- the pair passes' window rows (a rank's shard, parallel/
    # band_shard.py, exchanges the rows of other shards here) --------------

    def window_rows(self, X: torch.Tensor) -> torch.Tensor:
        """The band windows of X [nb, P, L]: [nb, 3P, L]."""
        return band_window(X)

    def far_rows(self, X: torch.Tensor) -> torch.Tensor:
        """The rows the far groups index, X [nb, P, L] -> [nb*P/g, g*L]."""
        return X.reshape(-1, self.far_group_size * X.shape[-1])

    def to(self, device) -> "BandEngine":
        """The same engine with every tensor on ``device``."""
        dev = torch.device(device)

        def move(v):
            if isinstance(v, torch.Tensor):
                return v.to(dev)
            if isinstance(v, tuple):
                return tuple(t.to(dev) for t in v)
            return v

        return dataclasses.replace(self, **{
            f.name: move(getattr(self, f.name))
            for f in dataclasses.fields(self)})

    # -- layout conversion (the CellEngine contract) ------------------------

    def scatter(self, A: torch.Tensor) -> torch.Tensor:
        """[..., N, F] particle order -> [..., nb, P, F] rank layout (pad rows
        zero); leading axes are batch axes."""
        nb, p = self.num_cells, self.slots_per_cell
        lead, f = tuple(A.shape[:-2]), A.shape[-1]
        flat = A.new_zeros(lead + (nb * p, f))
        flat[..., self.slot_of_particle, :] = A
        return flat.reshape(lead + (nb, p, f))

    def gather_back(self, S: torch.Tensor) -> torch.Tensor:
        """[..., nb, P, F] rank layout -> [..., N, F] particle order (its
        backward copies into the distinct ranks, no accumulation)."""
        nb, p = self.num_cells, self.slots_per_cell
        flat = S.reshape(tuple(S.shape[:-3]) + (nb * p, S.shape[-1]))
        return gather_injective(flat, self.slot_of_particle, -2)

    # -- operator API (parity and checks) -----------------------------------

    def count(self) -> torch.Tensor:
        return self.nbr_count

    def volume_consistency(self) -> torch.Tensor:
        """sigma_W sum_w W v_w per row (~1 on real rows)."""
        ones = self.vs.new_ones((self.num_cells, self.slots_per_cell, 1))
        return self.sig_w * band_blur_pass(self, ones)[..., 0]


# ---- the pair passes -------------------------------------------------------


def band_window(X: torch.Tensor) -> torch.Tensor:
    """[nb, P, L] -> [nb, 3P, L] band windows, blocks b-1, b, b+1 (two rolls
    and a concat). The wrap at the ends is harmless: table entries there are
    zero unless the pair is in range (periodic domains where the curve's
    ends meet)."""
    return torch.cat([X.roll(1, 0), X, X.roll(-1, 0)], dim=1)


def _pair_dot(T: torch.Tensor, W: torch.Tensor,
              out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Contract over the window axis: T [n, W, C] (a column slice of a
    table) and W [n, W, L] in the table dtype -> [n, C, L], float32 sums
    rounded to ``out_dtype``. The transposed slice is a strided view that
    ``torch.bmm`` takes as it is."""
    A = T.transpose(1, 2)
    if T.device.type == "cuda":
        if T.dtype == torch.float32:
            out = torch.bmm(A, W)
        else:
            out = torch.bmm(A, W, out_dtype=torch.float32)
    elif T.device.type == "cpu":
        out = torch.bmm(A.float(), W.float())
    else:
        raise ValueError(f"band pair pass: no route for device {T.device}")
    return out if out_dtype == torch.float32 else out.to(out_dtype)


def _add_far(eng, out: torch.Tensor, outs) -> torch.Tensor:
    """The band output [nb, C, L] plus the far buckets' outputs [nbt, C, L]
    in block order: the buckets' rows, concatenated, permuted by
    ``far_perm`` (entries past them read zeros: the blocks without far
    groups), the JAX package's combine (a few launches, not one a bucket).
    The backward gathers through the inverse permutation."""
    return out + permute_rows(torch.cat(outs), eng.far_perm)


def _pass(eng, X: torch.Tensor, cols: slice,
          out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """One pair pass over the table columns ``cols``: [nb, P, L] -> [nb,
    len(cols), L], band and far parts. The windows' rows come from the
    engine: ``window_rows`` for the band, ``far_rows`` for the far groups,
    one gather over every bucket's list (a rank's shard of the engine
    brings other shards' rows in there). Recorded as the span ``band.pass``
    and, in ``band.table_bytes``, the bytes of the table columns it reads
    (``pass_table_bytes``)."""
    with span("band.pass"):
        if is_recording():
            count("band.table_bytes", pass_table_bytes(eng, cols))
        X = X.to(eng.Tband.dtype)
        out = _pair_dot(eng.Tband[:, :, cols], eng.window_rows(X), out_dtype)
        if eng.far_tabs:
            L = X.shape[-1]
            rows = gather_rows(eng.far_rows(X), eng.far_index)
            outs, off = [], 0
            for grp, tab in zip(eng.far_groups, eng.far_tabs):
                win = rows[off:off + grp.numel()].reshape(grp.shape[0], -1,
                                                          L)
                outs.append(_pair_dot(tab[:, :, cols], win, out_dtype))
                off += grp.numel()
            out = _add_far(eng, out, outs)
        return out


def pass_table_bytes(eng, cols: slice) -> int:
    """Bytes of the table columns ``cols`` that one pair pass reads: the
    band table's and every far table's (one dtype, one column count), each
    read once; shape arithmetic, no tensor is touched."""
    width = len(range(*cols.indices(eng.Tband.shape[2])))
    rows = sum(t.shape[0] * t.shape[1] for t in (eng.Tband, *eng.far_tabs))
    return rows * width * eng.Tband.element_size()


def band_md_pass(eng: BandEngine, X: torch.Tensor) -> torch.Tensor:
    """Raw spiky moments sum_j md[:, j] X[j] for all D axes: [nb, P, L] ->
    [nb, D*P, L] float32 (band + far, unscaled by sigma_g)."""
    return _pass(eng, X, slice(0, eng.dim * eng.slots_per_cell))


def band_blur_pass(eng: BandEngine, Y: torch.Tensor) -> torch.Tensor:
    """Volume-weighted smoothing sum sum_j W v_j Y[j]: [nb, P, L] -> [nb, P,
    L] float32 (band + far, unscaled by sigma_W)."""
    return _pass(eng, Y, slice(eng.dim * eng.slots_per_cell, None))


def band_md_pass_axis(eng: BandEngine, X: torch.Tensor,
                      axis: int) -> torch.Tensor:
    """``band_md_pass`` for one axis's columns: [nb, P, L] -> [nb, P, L]."""
    p = eng.slots_per_cell
    return _pass(eng, X, slice(axis * p, (axis + 1) * p))


# ---- the batched NCA passes ------------------------------------------------


def _dtype(out_dtype) -> torch.dtype:
    if out_dtype is None:
        return torch.float32
    return getattr(torch, out_dtype) if isinstance(out_dtype, str) \
        else out_dtype


def rounded_scalar(value: float, dtype: torch.dtype) -> float:
    """``value`` rounded to ``dtype`` (the JAX package casts its constants
    to the output dtype before it multiplies; the fused update takes
    sigma_g rounded so, ``ops/mlp_kernel.py``)."""
    return float(torch.tensor(value, dtype=torch.float32).to(dtype))


def _all_alive(eng: BandEngine, b: int, dtype) -> torch.Tensor:
    """The alive columns without alpha: v > 0, [nb, P, B]."""
    return (eng.vs[..., None] > 0.0).expand(-1, -1, b).to(dtype)


def _alive_samples(eng: BandEngine, S: torch.Tensor,
                   use_alpha: bool) -> torch.Tensor:
    """The alive columns [nb, P, B] (table dtype) of samples S [B, nb, P,
    F]: (alpha > 0.1) & (v > 0), the threshold tested on the alpha lane cast
    to the table dtype (the values the products see, as the JAX package's).
    Only the alpha lane is read and moved."""
    tdt = eng.Tband.dtype
    if not use_alpha:
        return _all_alive(eng, S.shape[0], tdt)
    alpha = S[..., 3].to(tdt).permute(1, 2, 0)
    return ((alpha > ALIVE_THRESHOLD) & (eng.vs[..., None] > 0.0)).to(tdt)


def _to_lanes(S: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Samples [B, nb, P, F] -> lanes [nb, P, B*F] in ``dtype``: one
    permuting copy."""
    b, nb, p, f = S.shape
    out = torch.empty((nb, p, b, f), dtype=dtype, device=S.device)
    out.copy_(S.permute(1, 2, 0, 3))
    return out.view(nb, p, b * f)


def _lane_samples(XB: torch.Tensor, b: int) -> torch.Tensor:
    """Lanes [nb, P, B*F] -> a samples view [B, nb, P, F] (no copy)."""
    nb, p, bf = XB.shape
    return XB.view(nb, p, b, bf // b).permute(2, 0, 1, 3)


def perceive_band_moments(eng: BandEngine, S: torch.Tensor,
                          use_alpha: bool = True, out_dtype=None):
    """The two products of the batched perception of samples S [B, nb, P,
    F]: (mom [nb, D*P, B*F], the raw spiky moments in the output dtype as
    ``_pass`` leaves them, and pre_sm [B, nb, P] float32, the pre-step
    life-mask blur). Two products a pass (the md columns against the
    state's lanes, the smoothing columns against the alive columns), each
    reading its table once for all B samples.

    The far windows of the alive columns are gathered from the alive
    columns themselves, (alpha > 0.1) & (v > 0) at each window row: the
    values the JAX package derives from the gathered state's alpha lanes and
    a far real-row mask (a narrower gather mattered on the TPU), in one
    gather a bucket."""
    p = eng.slots_per_cell
    mom = _pass(eng, _to_lanes(S, eng.Tband.dtype),
                slice(0, eng.dim * p), _dtype(out_dtype))
    sm = _pass(eng, _alive_samples(eng, S, use_alpha), slice(eng.dim * p,
                                                             None))
    return mom, (eng.sig_w * sm).permute(2, 0, 1)


def band_gradient(mom: torch.Tensor, S: torch.Tensor, gsum: torch.Tensor,
                  sig_g: float) -> torch.Tensor:
    """The gradient from the raw moments mom [nb, D*P, B*F] of samples S
    [B, nb, P, F] and the self term gsum [nb, P, D]: ga [B, nb, P, D*F]
    per-sample d-major in mom's dtype, sigma_g mom - S gsum with every
    operand and product rounded to that dtype, as the JAX package's."""
    b, nb, p, f = S.shape
    d = gsum.shape[-1]
    odt = mom.dtype
    Xo = S.to(odt)
    gs = gsum.to(odt)
    mom = mom.view(nb, d, p, b, f).permute(3, 0, 2, 1, 4)  # [B, nb, P, D, F]
    ga = (rounded_scalar(sig_g, odt) * mom
          - Xo[:, :, :, None, :] * gs[None, :, :, :, None])
    return ga.reshape(b, nb, p, d * f)


def perceive_band_samples(eng: BandEngine, S: torch.Tensor,
                          use_alpha: bool = True, out_dtype=None):
    """Fused batched perception + pre-step life-mask blur of samples S [B,
    nb, P, F]: (ga [B, nb, P, D*F] per-sample d-major in the output dtype,
    pre_sm [B, nb, P] float32), ``perceive_band_moments`` then
    ``band_gradient``. ``out_dtype="bfloat16"`` rounds the moments and
    emits ga in bfloat16. Differentiable in S through ga."""
    mom, pre_sm = perceive_band_moments(eng, S, use_alpha, out_dtype)
    return band_gradient(mom, S, eng.gsum, eng.sig_g), pre_sm


def mask_blur_band_samples(eng: BandEngine, S: torch.Tensor,
                           use_alpha: bool = True) -> torch.Tensor:
    """Batched life-mask blur of samples S [B, nb, P, F] -> sm [B, nb, P]
    (the caller thresholds)."""
    acol = _alive_samples(eng, S, use_alpha)
    return (eng.sig_w * band_blur_pass(eng, acol)).permute(2, 0, 1)


def blur_band_samples(eng: BandEngine, X: torch.Tensor) -> torch.Tensor:
    """``blur_band`` for samples X [B, nb, P, K] -> [B, nb, P, K]."""
    b, nb, p, k = X.shape
    out = blur_band(eng, _to_lanes(X, eng.Tband.dtype))
    return out.view(nb, p, b, k).permute(2, 0, 1, 3)


# ---- the JAX package's lane layout ------------------------------------------


def perceive_band_batched(eng: BandEngine, XB: torch.Tensor, b: int,
                          use_alpha: bool = True, out_dtype=None):
    """``perceive_band_samples`` in the lane layout (the JAX package's
    ``perceive_band_batched`` without ``split_d`` and ``extra``): XB [nb, P,
    B*F] -> (gaB [nb, P, D*B*F] in d-major lane blocks, pre_sm [nb, P, B]).
    Differentiable in XB through gaB."""
    nb, p = eng.num_cells, eng.slots_per_cell
    ga, sm = perceive_band_samples(eng, _lane_samples(XB, b), use_alpha,
                                   out_dtype)
    d, f = eng.dim, XB.shape[-1] // b
    gaB = ga.view(b, nb, p, d, f).permute(1, 2, 3, 0, 4)
    return gaB.reshape(nb, p, d * b * f), sm.permute(1, 2, 0)


def mask_blur_band(eng: BandEngine, XB: torch.Tensor, b: int,
                   use_alpha: bool = True) -> torch.Tensor:
    """``mask_blur_band_samples`` in the lane layout: XB [nb, P, B*F] -> sm
    [nb, P, B]."""
    return mask_blur_band_samples(eng, _lane_samples(XB, b),
                                  use_alpha).permute(1, 2, 0)


def blur_band(eng: BandEngine, YB: torch.Tensor) -> torch.Tensor:
    """Batched SPH blur of per-row values [nb, P, K] -> [nb, P, K] (v_j in
    the table)."""
    return eng.sig_w * band_blur_pass(eng, YB)


def gradient_band(eng: BandEngine, A: torch.Tensor) -> torch.Tensor:
    """Single-sample SPH gradient in rank layout: [nb, P, F] -> [nb, P, F,
    D]."""
    d, p = eng.dim, eng.slots_per_cell
    mom = band_md_pass(eng, A)
    return torch.stack([eng.sig_g * mom[:, i * p:(i + 1) * p]
                        - A * eng.gsum[..., i:i + 1] for i in range(d)],
                       dim=-1)


def divergence_band(eng: BandEngine, V: torch.Tensor) -> torch.Tensor:
    """SPH divergence of vector features [nb, P, F, D] -> [nb, P, F]:
    sigma_g sum_j v_j (V_j - V_i) . mag r, axis by axis over the md
    columns."""
    acc = None
    for i in range(eng.dim):
        term = (eng.sig_g * band_md_pass_axis(eng, V[..., i], i)
                - V[..., i] * eng.gsum[..., i:i + 1])
        acc = term if acc is None else acc + term
    return acc


# ---- build (host numpy + the native library, once per geometry) ------------


def _bucket_cuts(widths: np.ndarray, k: int) -> list:
    """Split far widths into <= k buckets minimizing the padded area (each
    block pads to its bucket's max width): exact DP over the distinct
    widths; the fewest buckets reaching the k-bucket optimum."""
    nz = widths[widths > 0]
    if len(nz) == 0:
        return []
    vals, cnts = np.unique(nz, return_counts=True)  # ascending
    m = len(vals)
    k = min(k, m)
    csum = np.concatenate([[0], np.cumsum(cnts)])
    INF = float("inf")
    # dp[b][j]: least padded area covering the first j widths with b buckets
    dp = [[INF] * (m + 1) for _ in range(k + 1)]
    choice = [[0] * (m + 1) for _ in range(k + 1)]
    dp[0][0] = 0.0
    for b in range(1, k + 1):
        dp[b][0] = 0.0
        for j in range(1, m + 1):
            best, arg = INF, 0
            for i in range(j):
                if dp[b - 1][i] == INF:
                    continue
                c = dp[b - 1][i] + float(vals[j - 1]) * (csum[j] - csum[i])
                if c < best:
                    best, arg = c, i
            dp[b][j] = best
            choice[b][j] = arg
    bstar = k
    for b in range(1, k + 1):
        if dp[b][m] <= dp[k][m] + 1e-9:
            bstar = b
            break
    cuts = []
    j = m
    for b in range(bstar, 0, -1):
        cuts.append(int(vals[j - 1]))
        j = choice[b][j]
    return cuts[::-1]


def _smoothing_core_np(name: str, d2: np.ndarray, h: float) -> np.ndarray:
    """Unnormalized smoothing kernel W(d2, h) in host numpy (``ops.kernels``
    in numpy: poly6, Wendland C2, C4); the pairs are within h."""
    if name == "poly6":
        return np.maximum(h * h - d2, 0.0) ** 3
    q = np.sqrt(d2) / h
    if name == "wendlandC2":
        return (1.0 - q) ** 4 * (4.0 * q + 1.0)
    if name == "wendlandC4":
        return (1.0 - q) ** 6 * (35.0 * q * q + 18.0 * q + 3.0) / 3.0
    raise ValueError(f"unknown smoothing kernel {name!r}")


def _bf16(bits: np.ndarray) -> torch.Tensor:
    """uint16 bfloat16 bits -> a torch.bfloat16 tensor (no copy)."""
    return torch.from_numpy(bits.view(np.int16)).view(torch.bfloat16)


def build_band_engine(
    x,
    h: float,
    *,
    period=None,
    block_rows: int = 64,
    far_group: int = 4,
    far_buckets: int = 16,
    smoothing: str = K.DEFAULT_SMOOTHING,
    gradient_kernel: str = K.DEFAULT_GRADIENT,
    table_dtype: str = "float32",
    block_multiple: int = 1,
    curve: str = "hilbert",
    rank_cell_scale: float = 1.0,
    device="cuda",
) -> BandEngine:
    """Build the band engine for positions x [N, D] (torch or numpy) on the
    host, then move it to ``device`` (the JAX package's
    ``build_band_engine``, with the same arguments).

    ``block_rows`` (P) rows a block; ``far_group`` (g) particles a far
    group; ``far_buckets`` width classes of the far lists; ``block_multiple``
    pads the block count to a multiple. Pair weights are computed in float64
    (float32 pair geometry from the native scan) and cast once to
    ``table_dtype`` ("float32" | "bfloat16"); with bfloat16 the gsum self
    term comes from the quantized tables. Every registered smoothing kernel
    bakes in; the gradient kernel is spiky. Recorded as the span
    ``engine.build`` with ``engine.scan`` (the native pair scan),
    ``engine.tables`` (volumes, fills, far structure, quantization) and
    ``engine.transfer`` (the tensors to the device).
    """
    device = resolve_device(device)
    K.get_smoothing_kernel(smoothing)
    K.get_gradient_kernel(gradient_kernel)
    if gradient_kernel != "spiky":
        raise NotImplementedError(
            "band engine bakes spiky gradient magnitudes; "
            f"gradient_kernel={gradient_kernel!r} needs its own fill")
    if table_dtype not in ("float32", "bfloat16"):
        raise ValueError(f"table_dtype must be 'float32' or 'bfloat16', got "
                         f"{table_dtype!r}")
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    x = np.asarray(x, np.float64)
    n, d = x.shape
    P = int(block_rows)
    g = int(far_group)
    if P % g:
        raise ValueError(f"far_group {g} must divide block_rows {P}")

    with span("engine.build"):
        xr, rank_of_particle, per = _curve_order(x, h, period,
                                                 rank_cell_scale, curve)
        nb = -(-n // P)
        bm = max(1, int(block_multiple))
        nb = -(-nb // bm) * bm
        with span("engine.scan"):
            # the scan also accumulates the per-particle poly6 sums and
            # counts
            scan = native.true_pairs(xr, float(h), per)
        with span("engine.tables"):
            host = _band_tables(xr, scan, h, nb, P, g, far_buckets,
                                smoothing, gradient_kernel, table_dtype)
        with span("engine.transfer"):
            return _band_engine_on(device, host, rank_of_particle, h, nb, P)


def _curve_order(x: np.ndarray, h: float, period, rank_cell_scale: float,
                 curve: str):
    """The band engine's particle order: (positions in curve rank order
    [N, D] float64, each particle's rank [N], the period [D] or None)."""
    n, d = x.shape
    per = None
    rscale = float(rank_cell_scale)
    if period is not None:
        if isinstance(period, torch.Tensor):
            period = period.detach().cpu().numpy()
        per = np.broadcast_to(np.asarray(period, np.float64), (d,)).copy()
        # ranking cells only order the particles (the pair scan builds its
        # own h-grid), so they may be finer than h
        ncell = np.maximum(np.floor(per / (h * rscale)).astype(np.int64), 3)
        cell_size = per / ncell
        x = x - np.floor(x / per) * per  # canonical positions, one period
    else:
        cell_size = np.full(d, float(h) * rscale, np.float64)

    # curve rank: sort by cell code, stable (original order within a cell)
    fl = np.floor(x / cell_size).astype(np.int64)
    if per is not None:
        fl = np.mod(fl, ncell)
    encode = {"hilbert": _hilbert_code, "morton": _morton_code}[curve]
    code = encode(fl - fl.min(axis=0))
    order = np.argsort(code, kind="stable")
    rank_of_particle = np.empty(n, np.int64)
    rank_of_particle[order] = np.arange(n)
    xr = x[order]
    return xr, rank_of_particle, per


def _band_tables(xr: np.ndarray, scan, h: float, nb: int, P: int, g: int,
                 far_buckets: int, smoothing: str, gradient_kernel: str,
                 table_dtype: str) -> dict:
    """The band engine's host arrays from the rank-ordered positions and the
    native pair scan's output: volumes, the band and far tables (filled,
    bucketed, quantized to ``table_dtype``), the gradient self term, by the
    engine's field names."""
    n, d = xr.shape
    R = nb * P
    pi, pj, dx, d2, w6sum, ncnt = scan

    # volumes: v_i = 1 / (sigma_W sum_j W(d2))
    sig_w = float(K.get_smoothing_kernel(smoothing).norm(h, d))
    sig_g = float(K.get_gradient_kernel(gradient_kernel).norm(h, d))
    if smoothing == "poly6":
        inv_v = sig_w * np.pad(w6sum, (0, R - n))
    else:
        inv_v = sig_w * np.bincount(
            pi, weights=_smoothing_core_np(smoothing, d2, float(h)),
            minlength=R)
    v = np.where(inv_v > 0.0, 1.0 / np.maximum(inv_v, 1e-300), 0.0)

    # fused native fill for bfloat16 poly6 tables: the pair weights are
    # computed inside the fill from (dx, d2, v) and quantized there
    fused = table_dtype == "bfloat16" and smoothing == "poly6"
    if not fused:
        w6 = _smoothing_core_np(smoothing, d2, float(h))
        dist = np.sqrt(np.where(d2 > 0.0, d2, 1.0))
        mag = np.where(d2 > 0.0, 3.0 * (h - dist) ** 2 / dist, 0.0)
        vj = v[pj]
        w6v = w6 * vj  # smoothing core * source volume
        mdv = mag[:, None] * dx * vj[:, None]  # [E, D]
        del w6

    pi = np.asarray(pi, np.int32)
    pj = np.asarray(pj, np.int32)
    bi = pi // P
    ri = pi % P
    pairs = (pi, pj, dx, d2)

    band_col = native.band_cols(pi, pj, P, nb)  # < 0: a far pair
    in_band = band_col >= 0

    def fill_table(psel, cols_sel, rows_sel, nrows, wcols):
        """The table of the selected pairs (rows non-decreasing; pairs of
        several images accumulate): (bfloat16 bits, quantized row sums)
        when fused, else (float32 table, None)."""
        ri_sel = ri[psel]
        if fused:
            return native.fill_cast_bf16(rows_sel, cols_sel, ri_sel, psel,
                                         pairs, v, float(h), nrows, wcols, P)
        return native.accum_table(
            rows_sel, cols_sel, ri_sel, np.ascontiguousarray(mdv[psel]),
            w6v[psel], nrows, wcols, P), None

    if fused:
        Tband, gs_band = native.fill_band_bf16(pi, band_col, pairs, v,
                                               float(h), nb, P)
    else:
        bsel = np.flatnonzero(in_band)
        Tband, gs_band = fill_table(bsel, band_col[bsel], bi[bsel], nb, 3 * P)

    # ---- far structure: per-block group lists, buckets, per-pair slots ----
    e_far = int(len(pi) - np.count_nonzero(in_band))
    gc_n, off_n, gflat_n = native.far_groups(pi, pj, band_col, e_far, P, g,
                                             nb)
    grp_count = gc_n.astype(np.int64)
    cuts = _bucket_cuts(grp_count, far_buckets)
    (block_bucket, _, _, _, pair_bucket, pair_row, pair_col) = \
        native.far_meta(pi, pj, band_col, P, g, nb, gc_n, off_n, gflat_n,
                        np.asarray(cuts, np.int64))

    far_blocks, far_groups_l, far_tabs, far_gs = [], [], [], []
    order_rows = []  # bucket-concat row order (block ids)
    for t_idx, wmax in enumerate(cuts):
        blks = np.flatnonzero(block_bucket == t_idx)
        if len(blks) == 0:
            continue
        far_blocks.append(blks)
        order_rows.append(blks)
        # group lists from the flat segments (ascending ids; pad: group 0)
        cnts = grp_count[blks]
        grp_list = np.zeros((len(blks), wmax), np.int32)
        if cnts.sum():
            rows_idx = np.repeat(np.arange(len(blks)), cnts)
            startp = np.concatenate([[0], np.cumsum(cnts)[:-1]])
            col_idx = np.arange(int(cnts.sum())) - np.repeat(startp, cnts)
            gather = np.repeat(off_n[blks], cnts) + col_idx
            grp_list[rows_idx, col_idx] = gflat_n[gather]
        far_groups_l.append(grp_list)
        psel = np.flatnonzero(pair_bucket == t_idx)
        tab, gst = fill_table(psel, pair_col[psel], pair_row[psel],
                              len(blks), wmax * g)
        far_tabs.append(tab)
        far_gs.append(gst)

    order_rows.append(np.where(grp_count == 0)[0])
    all_rows = np.concatenate(order_rows)
    far_perm = np.empty(nb, np.int64)
    far_perm[all_rows] = np.arange(nb)

    # ---- quantize; gsum from the quantized values --------------------------
    gs = None
    bf16 = table_dtype == "bfloat16"
    if fused:
        Tband_n, far_n = Tband, far_tabs
        gs = gs_band
        for blks, gst in zip(far_blocks, far_gs):
            gs[blks] += gst
    elif bf16:
        Tband_n, gs = native.cast_bf16_gsum(Tband)
        far_n = []
        for blks, tab in zip(far_blocks, far_tabs):
            tq, gst = native.cast_bf16_gsum(tab)
            far_n.append(tq)
            gs[blks] += gst
    else:
        Tband_n, far_n = Tband, far_tabs
    if gs is None:
        gs = Tband_n.astype(np.float32).sum(axis=1)  # [nb, CC]
        for blks, tq in zip(far_blocks, far_n):
            if len(blks):
                gs[blks] += tq.astype(np.float32).sum(axis=1)
    gsum = sig_g * gs.reshape(nb, d + 1, P).transpose(0, 2, 1)[..., :d]

    xs = np.full((R, d), PAD_POS, np.float32)
    xs[:n] = xr.astype(np.float32)
    vs = np.zeros((R,), np.float32)
    vs[:n] = v[:n]
    ncnt = np.pad(ncnt, (0, R - n))
    return dict(xs=xs, vs=vs, Tband=Tband_n, gsum=gsum, ncnt=ncnt,
                far_blocks=far_blocks, far_groups=far_groups_l,
                far_tabs=far_n, far_perm=far_perm, sig_w=sig_w, sig_g=sig_g,
                bf16=bf16)


def _band_engine_on(device, host: dict, rank_of_particle: np.ndarray,
                    h: float, nb: int, P: int) -> BandEngine:
    """``_band_tables``' arrays moved to ``device`` as a ``BandEngine``."""
    d = host["xs"].shape[-1]
    bf16 = host["bf16"]

    def table(a):
        return (_bf16(a) if bf16 else torch.from_numpy(a)).to(device)

    def dev(a, dtype=None):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device=device,
                                                             dtype=dtype)

    groups = host["far_groups"]
    return BandEngine(
        slot_of_particle=dev(rank_of_particle, torch.int64),
        xs=dev(host["xs"].reshape(nb, P, d)),
        vs=dev(host["vs"].reshape(nb, P)),
        Tband=table(host["Tband"]),
        gsum=dev(host["gsum"].astype(np.float32)),
        nbr_count=dev(host["ncnt"].reshape(nb, P), torch.int32),
        far_blocks=tuple(dev(b, torch.int64) for b in host["far_blocks"]),
        far_groups=tuple(dev(gl, torch.int64) for gl in groups),
        far_tabs=tuple(table(t) for t in host["far_tabs"]),
        far_perm=dev(host["far_perm"], torch.int64),
        far_index=dev(np.concatenate([gl.reshape(-1) for gl in groups]
                                     + [np.zeros(0, np.int32)]), torch.int64),
        h=float(np.float32(h)),
        sig_w=float(np.float32(host["sig_w"])),
        sig_g=float(np.float32(host["sig_g"])),
    )
