"""Halo-exchange sharding of the band engine over the particle axis, one rank
a shard: exchanges proportional to the shards' boundaries, not to the state.

Counterpart of ``sph_nca_tpu/parallel/band_shard.py``. The band engine's
blocks are curve-contiguous (``ops/bands.py``), so cutting the block axis
into k equal ranges (the engine built with ``block_multiple=k``) gives each
rank a contiguous curve segment. Its two pair structures need two kinds of
exchange, both static per geometry:

  * BAND windows read blocks [b-1, b, b+1]: only a shard's edge blocks cross
    the boundary, so one ``ppermute`` of the first and of the last block's
    rows a pass (``_band_window_halo``);
  * FAR groups can reference any shard. In the "targeted" mode (the
    default) shard s sends, per populated curve distance delta, exactly the
    groups shard (s + delta) % k needs (``send_idx``), one ``ppermute`` a
    distance; in the "allgather" mode each shard gathers every shard's
    export rows (``export_idx``). ``halo_src`` then indexes this shard's halo
    rows out of what it received (``_halo_rows``).

The far buckets are re-cut per shard (``shard_band_engine``): every shard
gets buckets of the same shapes, filled with its own blocks sorted by width
(the rank profile), so the products have one shape on every rank.

Every pass is the band engine's own (``ops/bands._pass``: ``torch.bmm`` of
a table's column slice with the window rows): the sharded engine
(``BandShardEngine``) hands it the window rows through ``window_rows`` and
``far_rows``, which run the exchanges of ``comm.py``. Those are
``torch.autograd.Function``s, so autograd differentiates the sharded
rollout: the backward of a ``ppermute`` is the reverse shift, that of a
gather a reduce-scatter of every rank's cotangent. The sharded engine goes
through the engine seam of ``ops/batched.py``, so the sharded step is the
port's batched step (``models/cell_step._step_samples``: perception, the
update MLP, kernel 2.8 on CUDA, the life masks) on this rank's rows.

Deviations from the JAX package, each documented where it happens:

  * the port's band engine has no ``far_vwmask``: its far alive columns are
    gathered from the alive columns, so the perception exchanges the alive
    columns' far halo beside the state's, and the shards carry no mask;
  * the rollouts' fire draws come from a ``torch.Generator`` per (seed,
    step, global rank) (``comm.rank_generator``; JAX folds the shard index
    into the step key): independent on every rank, the same law as the
    unsharded rollout's, other streams, so sharded and unsharded
    trajectories agree at ``fire_rate=1``;
  * the surface rollout diffuses the tangents at the end of each step
    through a sharded blur with its own halo exchange, the port's schedule
    (``models/surface.py``); the JAX package fuses the blur into the next
    step's perception as extra lanes.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.utils.checkpoint import checkpoint

from ..models import cell_step as CST
from ..models.surface import (
    _diffuse_td,
    normal_components,
)
from ..ops import bands as BD
from ..ops import batched as BT
from ..ops.gather import gather_rows
from ..ops.mlp_kernel import project_td
from . import comm
from .mesh import coords, particle_group


class BandShards(NamedTuple):
    """Per-shard band structure. From ``shard_band_engine`` every field is
    [k, ...] (host tensors); from ``place_shards`` it is one rank's slice,
    the leading k dropped, on its device. S = blocks a shard, E = export
    groups, H = halo groups (max over shards, zero-padded). The integer
    fields equal the JAX package's."""

    Tband: torch.Tensor  # [k, S, 3P, CC]
    gsum: torch.Tensor  # [k, S, P, D] f32
    vs: torch.Tensor  # [k, S, P]
    export_idx: torch.Tensor  # [k, E] local group ids this shard exports
    # into the received rows ([k*E] allgather mode / [sum Edelta] targeted)
    halo_src: torch.Tensor  # [k, H]
    far_groups: Tuple[torch.Tensor, ...]  # [k, nbt, Wt], local+halo space
    far_tabs: Tuple[torch.Tensor, ...]  # [k, nbt, Wt*g, CC]
    far_perm: torch.Tensor  # [k, S] into concat(bucket outs + 1 zero row)
    far_index: torch.Tensor  # [k, sum nbt*Wt]: far_groups flattened
    # targeted mode: per curve distance delta, the local group ids each
    # shard sends to shard (s + delta) % k
    send_idx: Tuple[torch.Tensor, ...] = ()  # per delta: [k, Edelta]

    @property
    def blocks_per_shard(self) -> int:
        return self.Tband.shape[-3]


class BandShardStatic(NamedTuple):
    """The sharding's Python constants."""

    k: int
    g: int  # far group size
    d: int
    P: int
    sig_w: float
    sig_g: float
    # non-empty -> targeted far exchange, one ppermute per curve distance
    deltas: Tuple[int, ...] = ()


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else \
        np.asarray(t)


def shard_band_engine(eng: BD.BandEngine, k: int, *,
                      halo: str = "targeted"
                      ) -> Tuple[BandShards, BandShardStatic]:
    """Partition a band engine (built with ``block_multiple=k`` so that
    nb % k == 0) into k contiguous block shards and the static halo
    exchange (host numpy; the tensors of the result are on the CPU).

    ``halo``: "targeted" exchanges far groups with one ppermute per
    populated curve distance; "allgather" gives every shard every shard's
    exports (the JAX package's round-3 exchange, kept for comparison)."""
    nb, Pr = eng.num_cells, eng.slots_per_cell
    if nb % k:
        raise ValueError(f"nb={nb} not divisible by k={k}; build the engine "
                         f"with block_multiple={k}")
    S = nb // k
    g = eng.far_group_size
    if Pr % g:
        raise ValueError(f"far_group {g} must divide block rows {Pr}")
    gps = S * (Pr // g)  # groups per shard
    d = eng.dim
    cc = (d + 1) * Pr

    far_blocks = [_np(b) for b in eng.far_blocks]
    far_groups = [_np(x) for x in eng.far_groups]
    far_tabs = [t.detach().cpu() for t in eng.far_tabs]

    # valid-entry masks: a group list holds its real entries first, in
    # strictly increasing order; pad entries repeat group 0 and must not
    # enter the needed / halo sets
    valid_l = []
    for grps in far_groups:
        v = np.ones(grps.shape, bool)
        if grps.shape[1] > 1:
            v[:, 1:] = grps[:, 1:] > grps[:, :-1]
        valid_l.append(np.logical_and.accumulate(v, axis=1))

    needed = [set() for _ in range(k)]
    for blks, grps, valid in zip(far_blocks, far_groups, valid_l):
        if not len(blks):
            continue
        sh = blks // S
        for s in range(k):
            sel = sh == s
            if sel.any():
                gset = np.unique(grps[sel][valid[sel]])
                needed[s].update(gset[gset // gps != s].tolist())
    needed = [np.sort(np.fromiter(ns, np.int64)) if ns else
              np.zeros(0, np.int64) for ns in needed]

    H = max(1, max(len(n) for n in needed))
    halo_src = np.zeros((k, H), np.int64)

    if halo == "targeted":
        # shard s sends, per curve distance delta, exactly the groups shard
        # (s + delta) % k needs from it
        send_lists, deltas = {}, []
        for delta in range(1, k):
            lists = []
            for s in range(k):
                nt = needed[(s + delta) % k]
                lists.append(nt[nt // gps == s])
            if any(len(lst) for lst in lists):
                deltas.append(delta)
                send_lists[delta] = lists
        offsets, off = {}, 0
        for dlt in deltas:
            offsets[dlt] = off
            off += max(len(lst) for lst in send_lists[dlt])
        send_idx = []
        for dlt in deltas:
            arr = np.zeros((k, max(len(lst) for lst in send_lists[dlt])),
                           np.int64)
            for s in range(k):
                loc = send_lists[dlt][s] - s * gps
                arr[s, :len(loc)] = loc
            send_idx.append(arr)
        for s in range(k):
            for j, gid in enumerate(needed[s]):
                t = int(gid) // gps
                dlt = (s - t) % k
                halo_src[s, j] = offsets[dlt] + int(
                    np.searchsorted(send_lists[dlt][t], gid))
        export_idx = np.zeros((k, 1), np.int64)  # unused in this mode
        deltas = tuple(deltas)
    elif halo == "allgather":
        exports = []
        for s in range(k):
            exp = set()
            for t in range(k):
                if t != s:
                    nt = needed[t]
                    exp.update(nt[nt // gps == s].tolist())
            exports.append(np.sort(np.fromiter(exp, np.int64)) if exp
                           else np.zeros(0, np.int64))
        E = max(1, max(len(e) for e in exports))
        export_idx = np.zeros((k, E), np.int64)
        for s in range(k):
            loc = exports[s] - s * gps
            export_idx[s, :len(loc)] = loc
            for j, gid in enumerate(needed[s]):
                t = int(gid) // gps
                halo_src[s, j] = t * E + int(np.searchsorted(exports[t], gid))
        deltas, send_idx = (), []
    else:
        raise ValueError(f"unknown halo mode {halo!r}")

    def remap_groups(s, grps, valid):
        """Global group ids -> shard-local window indices: own groups map
        to [0, gps), halo groups to gps + their position in needed[s], pad
        entries to 0 (their table columns are zero)."""
        own = grps - s * gps
        hal = gps + np.searchsorted(needed[s], grps)
        return np.where(valid, np.where(grps // gps == s, own, hal), 0)

    # per-shard far buckets: each shard's far blocks sorted by true width,
    # descending; bucket the rank profile R[i] = max_s width(i-th widest
    # block of shard s), so every shard has the same bucket shapes, filled
    # with its own blocks (zero-padded rows are inert, as the build's pads)
    cols = far_tabs[0].shape[-1] if far_tabs else 0
    tdtype = far_tabs[0].dtype if far_tabs else torch.float32
    per_shard = [[] for _ in range(k)]  # (w, grps, valid, tab, local block)
    for bt, (blks, grps, valid) in enumerate(zip(far_blocks, far_groups,
                                                 valid_l)):
        sh = blks // S
        w = valid.sum(1)
        for i in range(len(blks)):
            s = int(sh[i])
            per_shard[s].append((int(w[i]), grps[i], valid[i], (bt, i),
                                 int(blks[i] - s * S)))
    for p in per_shard:
        p.sort(key=lambda r: -r[0])
    n_ranks = max((len(p) for p in per_shard), default=0)

    fg_l, ft_l = [], []
    perm = np.zeros((k, S), np.int64)
    total_rows = 0
    if n_ranks:
        R = np.zeros(n_ranks, np.int64)
        for p in per_shard:
            for i, r in enumerate(p):
                R[i] = max(R[i], r[0])
        cuts = BD._bucket_cuts(np.sort(R), 16)  # ascending bucket widths
        # R is descending in rank order, so each bucket is a rank range
        bucket_of = np.searchsorted(np.asarray(cuts), R)
        for bi, Wr in enumerate(cuts):
            ranks = np.where(bucket_of == bi)[0]
            if not len(ranks):
                continue
            nbt, Wr = len(ranks), int(Wr)
            gk = np.zeros((k, nbt, Wr), np.int64)
            tk = torch.zeros((k, nbt, Wr * g, cols), dtype=tdtype)
            for s in range(k):
                for j, rank in enumerate(ranks):
                    if rank >= len(per_shard[s]):
                        continue
                    w, grow, vrow, (bt, i), lb = per_shard[s][rank]
                    gk[s, j, :w] = remap_groups(s, grow[:w], vrow[:w])
                    tk[s, j, :w * g] = far_tabs[bt][i, :w * g]
                    perm[s, lb] = total_rows + j
            fg_l.append(gk)
            ft_l.append(tk)
            total_rows += nbt
    # blocks with no far entries point at the appended zero row
    has_far = np.zeros((k, S), bool)
    for blks in far_blocks:
        has_far[blks // S, blks % S] = True
    perm[~has_far] = total_rows

    cpu = torch.device("cpu")
    shards = BandShards(
        Tband=eng.Tband.detach().to(cpu).reshape(k, S, 3 * Pr, cc),
        gsum=eng.gsum.detach().to(cpu).reshape(k, S, Pr, d),
        vs=eng.vs.detach().to(cpu).reshape(k, S, Pr),
        export_idx=torch.from_numpy(export_idx),
        halo_src=torch.from_numpy(halo_src),
        far_groups=tuple(torch.from_numpy(x) for x in fg_l),
        far_tabs=tuple(ft_l),
        far_perm=torch.from_numpy(perm),
        far_index=torch.from_numpy(np.concatenate(
            [gk.reshape(k, -1) for gk in fg_l] + [np.zeros((k, 0), np.int64)],
            axis=1)),
        send_idx=tuple(torch.from_numpy(a) for a in send_idx),
    )
    static = BandShardStatic(k=k, g=g, d=d, P=Pr, sig_w=float(eng.sig_w),
                             sig_g=float(eng.sig_g), deltas=deltas)
    return shards, static


def place_shards(shards: BandShards, mesh, device="cuda") -> BandShards:
    """This rank's slice of every field (its particle index on the mesh),
    moved to ``device``."""
    r = coords(mesh)[1]

    def take(t):
        if isinstance(t, tuple):
            return tuple(take(x) for x in t)
        return t[r].to(device).contiguous()

    return BandShards(*(take(f) for f in shards))


def comm_bytes_per_pass(shards: BandShards, static: BandShardStatic,
                        lanes: int, itemsize: int = 2) -> dict:
    """Static exchange volume of ONE pair pass at ``lanes`` window lanes,
    per shard (the JAX package's accounting, number for number): the band
    ppermutes move 2 boundary blocks; the far exchange moves sum_delta
    E_delta group rows (targeted) or k*E (allgather). ``allgather_bytes`` is
    the far exchange's volume in both modes."""
    k, g, Pr = static.k, static.g, static.P
    S = shards.blocks_per_shard
    if static.deltas:
        sent_rows = sum(int(a.shape[-1]) for a in shards.send_idx)
        recv_rows = sent_rows
        mode = "targeted"
    else:
        sent_rows = int(shards.export_idx.shape[-1])
        recv_rows = k * sent_rows
        mode = "allgather"
    return {
        "mode": mode,
        "ppermute_bytes": 2 * Pr * lanes * itemsize,
        "allgather_bytes": recv_rows * g * lanes * itemsize,
        "export_fraction": sent_rows / (S * Pr / g),
        "full_state_bytes": k * S * Pr * lanes * itemsize,
    }


# ---- the sharded passes (this rank's rows; exchanges over its group) ---------


def _band_window_halo(X: torch.Tensor, group) -> torch.Tensor:
    """[S, P, L] -> [S, 3P, L] band windows, the shard-edge blocks exchanged
    by ppermute (the wrap from the last shard to the first matches the
    unsharded roll: table zeros make it inert unless the domain is
    periodic)."""
    prev = comm.ppermute(X[-1], 1, group)
    nxt = comm.ppermute(X[0], -1, group)
    Xext = torch.cat([prev[None], X, nxt[None]])
    return torch.cat([Xext[:-2], Xext[1:-1], Xext[2:]], dim=1)


def _halo_rows(Xg: torch.Tensor, loc: BandShards, st: BandShardStatic,
               group) -> torch.Tensor:
    """Far-group halo exchange, Xg [gps, g*L] -> [H, g*L]: one ppermute per
    populated curve distance (targeted), else one gather of every shard's
    export rows. The row gathers' backward sums in a fixed order
    (``ops.gather.gather_rows``)."""
    if st.deltas:
        parts = [comm.ppermute(gather_rows(Xg, sidx), delta, group)
                 for delta, sidx in zip(st.deltas, loc.send_idx)]
        return gather_rows(torch.cat(parts), loc.halo_src)
    allb = comm.all_gather(gather_rows(Xg, loc.export_idx), group)
    return gather_rows(allb, loc.halo_src)  # allb [k*E, gL]


@dataclasses.dataclass
class BandShardEngine:
    """One rank's shard of a band engine with its exchange: this rank's
    slices (``place_shards``), the static structure and the mesh. It goes
    through the engine seam of ``ops/batched.py`` as an engine of S blocks
    of P rows."""

    loc: BandShards
    static: BandShardStatic
    mesh: object  # DeviceMesh

    @property
    def group(self):
        return particle_group(self.mesh)

    @property
    def Tband(self) -> torch.Tensor:
        return self.loc.Tband

    @property
    def vs(self) -> torch.Tensor:
        return self.loc.vs

    @property
    def gsum(self) -> torch.Tensor:
        return self.loc.gsum

    @property
    def far_groups(self) -> Tuple[torch.Tensor, ...]:
        return self.loc.far_groups

    @property
    def far_tabs(self) -> Tuple[torch.Tensor, ...]:
        return self.loc.far_tabs

    @property
    def far_perm(self) -> torch.Tensor:
        return self.loc.far_perm

    @property
    def far_index(self) -> torch.Tensor:
        return self.loc.far_index

    @property
    def sig_w(self) -> float:
        return self.static.sig_w

    @property
    def sig_g(self) -> float:
        return self.static.sig_g

    @property
    def device(self) -> torch.device:
        return self.loc.Tband.device

    @property
    def num_cells(self) -> int:
        return self.loc.Tband.shape[0]

    @property
    def slots_per_cell(self) -> int:
        return self.static.P

    @property
    def dim(self) -> int:
        return self.static.d

    @property
    def shard_cells(self) -> Tuple[int, int]:
        """(this rank's first block, the whole engine's blocks)."""
        s = self.num_cells
        return coords(self.mesh)[1] * s, self.static.k * s

    # -- the window rows of ops/bands._pass, exchanged over the group -------

    def window_rows(self, X: torch.Tensor) -> torch.Tensor:
        return _band_window_halo(X, self.group)

    def far_rows(self, X: torch.Tensor) -> torch.Tensor:
        """This rank's groups, then the halo groups (``halo_src``'s
        order), [gps + H, g*L]: the space ``far_groups`` index."""
        Xg = X.reshape(-1, self.static.g * X.shape[-1])
        return torch.cat([Xg, _halo_rows(Xg, self.loc, self.static,
                                         self.group)])

    # -- the engine seam of ops/batched.py (samples [B, S, P, F]) -----------

    def perceive_samples(self, S, use_alpha=True, *, out_dtype=None,
                         use_kernels=True):
        return BD.perceive_band_samples(self, S, use_alpha, out_dtype)

    def mask_blur_samples(self, S, use_alpha=True, *, use_kernels=True):
        return BD.mask_blur_band_samples(self, S, use_alpha)

    def blur_samples(self, X, *, use_kernels=True):
        return BD.blur_band_samples(self, X)


# ---- the JAX package's lane layout [S, P, B*F] ----------------------------------


def perceive_band_sharded(loc: BandShards, st: BandShardStatic,
                          XB: torch.Tensor, b: int, use_alpha: bool = True,
                          out_dtype=None, *, mesh):
    """Sharded twin of ``ops.bands.perceive_band_batched`` on this rank's
    rows XB [S, P, B*F]: (gaB [S, P, D*B*F] in d-major lane blocks, pre_sm
    [S, P, B])."""
    seng = BandShardEngine(loc, st, mesh)
    ga, sm = BD.perceive_band_samples(seng, BD._lane_samples(XB, b),
                                      use_alpha, out_dtype)
    return BT.dmajor_to_lanes(ga, st.d), sm.permute(1, 2, 0)


def mask_blur_band_sharded(loc: BandShards, st: BandShardStatic,
                           XB: torch.Tensor, b: int, use_alpha: bool = True,
                           *, mesh) -> torch.Tensor:
    """Sharded life-mask blur (``ops.bands.mask_blur_band``'s twin): XB
    [S, P, B*F] -> sm [S, P, B]."""
    seng = BandShardEngine(loc, st, mesh)
    return seng.mask_blur_samples(BD._lane_samples(XB, b),
                                  use_alpha).permute(1, 2, 0)


def _step_sharded(params, cfg, loc: BandShards, st: BandShardStatic,
                  XB: torch.Tensor, b: int, generator: torch.Generator, h,
                  fire_rate=None, mlp_dtype=None, *, mesh) -> torch.Tensor:
    """One batched NCA step on this rank's rows XB [S, P, B*F]: the port's
    batched step (``nca_step_cells_batched``: the sharded perception, the
    update MLP, kernel 2.8 on CUDA, the sharded post-update mask) on the
    rank's shard of the engine."""
    return CST.nca_step_cells_batched(params, cfg,
                                      BandShardEngine(loc, st, mesh), XB, b,
                                      generator, h, fire_rate, mlp_dtype)


def _rank_u(seed: int, t: int, shape, device) -> torch.Tensor:
    """Step t's fire draws of this rank: ``comm.rank_generator`` on its
    global rank, so no two ranks of a mesh draw alike."""
    gen = comm.rank_generator(seed, t, dist.get_rank(), device)
    return torch.rand(shape, generator=gen, device=device)


def rollout_band_sharded(params, cfg, loc: BandShards, static: BandShardStatic,
                         mesh, SB0: torch.Tensor, b: int, seed: int,
                         n_steps: int, h, *, fire_rate: Optional[float] = None,
                         mlp_dtype=None, remat: bool = True,
                         use_kernels: bool = True) -> torch.Tensor:
    """Halo-sharded rollout of this rank's rows SB0 [S, P, B*F] (its slice of
    ``batched_scatter``'s lanes; ``loc = place_shards(...)``) for
    ``n_steps`` steps -> its final rows [S, P, B*F]. Per step: the
    perception's band ppermutes and far exchanges (state and alive columns)
    and the post-update mask's (alive columns); ``comm_bytes_per_pass``
    counts one pass. Each step is recomputed in the backward when a gradient
    is needed (``remat``, ``torch.utils.checkpoint``, as the JAX package's
    ``jax.checkpoint``); the fire draws come from
    ``comm.rank_generator(seed, step, rank)``."""
    if fire_rate is None:
        fire_rate = cfg.fire_rate
    seng = BandShardEngine(loc, static, mesh)
    S = BT.to_samples(SB0, b)
    weights = CST._mlp_weights(params, cfg, S.shape[-1], h, mlp_dtype)
    remat = remat and torch.is_grad_enabled() and (
        SB0.requires_grad or any(p.requires_grad for p in params))

    def step(S, u):
        return CST._step_samples(cfg, seng, weights, S, u, fire_rate,
                                 use_kernels)

    for t in range(n_steps):
        u = _rank_u(seed, t, S.shape[:-1], S.device)
        S = checkpoint(step, S, u, use_reentrant=False,
                       preserve_rng_state=False) if remat else step(S, u)
    return BT.to_lanes(S)


def rollout_mesh_band_sharded(params, cfg, loc: BandShards,
                              static: BandShardStatic, mesh,
                              SB0: torch.Tensor, nc: torch.Tensor,
                              tB0: torch.Tensor, b: int, seed: int,
                              n_steps: int, h, *,
                              fire_rate: Optional[float] = None,
                              lerp_multiplier: float = 1.0,
                              w_multiplier: float = 1.0, mlp_dtype=None,
                              use_kernels: bool = True):
    """Halo-sharded surface rollout (``models.surface.rollout_mesh_batched``
    on this rank's rows): SB0 [S, P, B*F] lanes, the shared normals nc [S,
    P, 3] and the tangents tB0 [S*P, B, 3], all in rank layout -> (final
    lanes [S, P, B*F], final tangents three [S*P, B]). Per step: the
    tangent-projected perception, the update, the life masks, then the
    detached tangent diffusion T_t = diffuse(A_t, T_{t-1}) through a sharded
    blur with its own halo exchange. This is the port's schedule (the JAX
    package fuses the blur into the next step's perception pass as extra
    lanes and leaves the last diffusion to the caller), so the tangents
    returned are T_K."""
    if fire_rate is None:
        fire_rate = cfg.fire_rate
    seng = BandShardEngine(loc, static, mesh)
    s, p = seng.num_cells, static.P
    S = BT.to_samples(SB0, b)
    nd = normal_components(nc)
    td = normal_components(tB0.reshape(s, p, b, 3).permute(2, 0, 1, 3))
    weights = CST._mlp_weights(params, cfg, S.shape[-1], h, mlp_dtype)

    for t in range(n_steps):
        u = _rank_u(seed, t, S.shape[:-1], S.device)
        S = CST._step_samples(
            cfg, seng, weights, S, u, fire_rate, use_kernels,
            lambda ga: project_td(ga, nd, td, include_normal=False))
        with torch.no_grad():
            td = _diffuse_td(seng, nd, td, S.detach(),
                             lerp_multiplier=lerp_multiplier,
                             w_multiplier=w_multiplier,
                             use_kernels=use_kernels)
    return BT.to_lanes(S), tuple(t.permute(1, 2, 0).reshape(s * p, b)
                                 for t in td)
