"""Row gathers over static indices whose backward sums in a fixed order.

The engines' index maps (the graph's neighbour lists, the band engine's far
group lists, its block permutation, the particle <-> slot maps) are built once
per geometry and never change during a rollout. PyTorch's own backward of
``X[idx]`` is a sort-based ``index_put_`` (304 ms a call at the train CLI's
graph shapes on an H100, ``chip_smoke.py`` [graph-train]), and ``index_add_``
adds atomically, in no fixed order, so two runs of one seed part in the last
bits. Here every backward is gathers and sums over a reverse map of the
indices instead, and its sums come in one order on every run:

  * ``gather_rows(X, idx)``: a many-to-one gather X[idx]. Its backward sums,
    for each source row, the gradient rows of the positions that read it,
    in ascending position order, through the ``ReverseMap`` of idx;
  * ``permute_rows(Y, perm)``: rows of Y (or a zero row) in the order perm
    gives, each row of Y taken at most once; the backward gathers through
    the inverse map;
  * ``gather_injective(X, idx, dim)``: X.index_select(dim, idx) for distinct
    indices; the backward copies the gradient into those distinct slots
    (``index_copy_``: one write a slot, no accumulation).

A ``ReverseMap`` lists, for each source row, the positions that read it,
sorted by position, in chunks of ``width`` positions: one gather of the
gradient rows and one sum a chunk. A source read more often than ``width``
(the pad lanes of a neighbour list all read row 0; the far lists' pad groups
all read group 0) has several chunks, whose sums are summed again, in chunk
order, by the next level of the map, until one row a source is left.

The maps are built on the first backward through an index tensor, on its
device, and kept for as long as that tensor lives (keyed by the tensor's
identity): an engine or a graph builds them once. Index tensors are never
written in place after they are built.
"""

from __future__ import annotations

import threading
from typing import List, Tuple

import torch
from torch.autograd.function import once_differentiable
from torch.utils.weak import WeakIdKeyDictionary

# the share of sources whose reads fit in one chunk of the map's first level
# (the rest, pad rows, take more levels)
_COVER = 0.99
_LEVEL_WIDTH = 256  # chunk width of the later levels
# the first level gathers the gradient rows in pieces of at most this many
# elements, so the backward's temporary stays small beside the gradient
_PIECE_ELEMS = 1 << 24

_reverse_maps = WeakIdKeyDictionary()  # idx -> ReverseMap
_inverses = WeakIdKeyDictionary()  # perm -> its inverse map
_maps_lock = threading.Lock()


class ReverseMap:
    """The reverse of a many-to-one index map idx [M] -> [0, n_src).

    ``tables[0]`` [n0, W0] lists positions of idx (M: none, read as zero);
    the sums of its chunks fill rows [0, n0) of a buffer. Each later table
    lists rows of that buffer (its size: a zero row) and fills the rows
    after them.
    ``final`` [n_src] is each source's total row in the buffer (or the zero
    row when nothing reads it).
    """

    def __init__(self, idx: torch.Tensor, n_src: int):
        flat = idx.reshape(-1).to(torch.int64)
        self.n_src = int(n_src)
        self.n_pos = flat.numel()
        dev = flat.device
        tables: List[torch.Tensor] = []
        final = torch.full((self.n_src,), -1, dtype=torch.int64, device=dev)
        labels, rows = flat, torch.arange(self.n_pos, device=dev)
        offset = 0
        while labels.numel():
            counts = torch.bincount(labels, minlength=self.n_src)
            width = self._width(counts, first=not tables)
            order = torch.sort(labels, stable=True).indices
            lab, row = labels[order], rows[order]
            starts = torch.cumsum(counts, 0) - counts
            pos = torch.arange(lab.numel(), device=dev) - starts[lab]
            nch = (counts + width - 1) // width
            ch_start = torch.cumsum(nch, 0) - nch
            n_ch = int(nch.sum())
            table = torch.full((n_ch, width), -1, dtype=torch.int64,
                               device=dev)
            table[ch_start[lab] + pos // width, pos % width] = row
            tables.append(table)
            out_rows = offset + torch.arange(n_ch, device=dev)
            owner = torch.repeat_interleave(
                torch.arange(self.n_src, device=dev), nch)
            one = nch == 1
            final[one] = out_rows[ch_start[one]]
            multi = nch[owner] > 1
            labels, rows = owner[multi], out_rows[multi]
            offset += n_ch
        self.n_rows = offset
        # the sentinels: the first level's read position 0 and are masked
        # out, the later ones read the buffer's zero row
        if tables:
            self.live0 = tables[0] >= 0
            tables[0].clamp_(min=0)
        for t in tables[1:]:
            t[t < 0] = self.n_rows
        final[final < 0] = self.n_rows
        self.tables: Tuple[torch.Tensor, ...] = tuple(tables)
        self.final = final

    @staticmethod
    def _width(counts: torch.Tensor, first: bool) -> int:
        """The chunk width of a level: on the first, the read count that
        ``_COVER`` of the sources read from stay within; on the later ones
        ``_LEVEL_WIDTH`` (at least 2, so every level shrinks)."""
        live = counts[counts > 0]
        top = int(live.max())
        if not first:
            return max(2, min(top, _LEVEL_WIDTH))
        srt = torch.sort(live).values
        return max(1, int(srt[int(_COVER * (srt.numel() - 1))]))

    def sum_rows(self, G: torch.Tensor) -> torch.Tensor:
        """sum_{p: idx[p] = s} G[p] for every source s: G [M, ...] ->
        [n_src, ...], in a fixed order."""
        tail = tuple(G.shape[1:])
        buf = G.new_zeros((self.n_rows + 1,) + tail)
        if self.tables:
            t0, live = self.tables[0], self.live0
            row = t0.shape[1] * max(1, G[0].numel())
            step = max(1, _PIECE_ELEMS // row)
            zero = G.new_zeros(())
            for a in range(0, t0.shape[0], step):
                b = min(a + step, t0.shape[0])
                live_a = live[a:b].reshape(live[a:b].shape + (1,) * len(tail))
                buf[a:b] = torch.where(live_a, G[t0[a:b]], zero).sum(1)
            off = t0.shape[0]
            for t in self.tables[1:]:
                buf[off:off + t.shape[0]] = buf[t].sum(1)
                off += t.shape[0]
        return buf[self.final]


def reverse_map(idx: torch.Tensor, n_src: int) -> ReverseMap:
    """The ``ReverseMap`` of idx over n_src sources, built once per index
    tensor (kept while the tensor lives)."""
    with _maps_lock:
        rev = _reverse_maps.get(idx)
        if rev is None or rev.n_src != n_src:
            rev = ReverseMap(idx, n_src)
            _reverse_maps[idx] = rev
        return rev


class _GatherRows(torch.autograd.Function):
    """X[idx] for X [N, ...] and integer idx of any shape; the backward sums
    each source row's gradient rows through the reverse map."""

    @staticmethod
    def forward(ctx, X, idx):
        ctx.idx = idx
        ctx.shape = X.shape
        return X[idx]

    @staticmethod
    @once_differentiable
    def backward(ctx, G):
        idx, shape = ctx.idx, ctx.shape
        rev = reverse_map(idx, shape[0])
        return rev.sum_rows(G.reshape((-1,) + tuple(shape[1:]))), None


def gather_rows(X: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The gather X[idx]: X [N, ...], indices of shape I -> [*I, ...], with
    a fixed-order backward. ``idx`` should be an engine's or a graph's own
    index tensor, so its reverse map is built once."""
    return _GatherRows.apply(X, idx)


def _inverse(perm: torch.Tensor, n_rows: int) -> torch.Tensor:
    """For each row r < n_rows, the position p with perm[p] == r, or
    len(perm) where no position takes it (positions taking rows >= n_rows
    read zeros)."""
    with _maps_lock:
        inv = _inverses.get(perm)
        if inv is None or inv.shape[0] != n_rows:
            inv = torch.full((n_rows,), perm.shape[0], dtype=torch.int64,
                             device=perm.device)
            sel = perm < n_rows
            inv[perm[sel]] = torch.arange(perm.shape[0],
                                          device=perm.device)[sel]
            _inverses[perm] = inv
        return inv


class _PermuteRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, Y, perm):
        ctx.perm = perm
        ctx.n = Y.shape[0]
        tail = tuple(Y.shape[1:])
        return torch.cat([Y, Y.new_zeros((1,) + tail)])[
            perm.clamp(max=Y.shape[0])]

    @staticmethod
    @once_differentiable
    def backward(ctx, G):
        inv = _inverse(ctx.perm, ctx.n)
        Gz = torch.cat([G, G.new_zeros((1,) + tuple(G.shape[1:]))])
        return Gz[inv], None


def permute_rows(Y: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """[Y; 0][perm] for Y [R, ...] and perm [n] (entries >= R read the zero
    row), when no row of Y is taken twice; the backward is a gather through
    the inverse map."""
    return _PermuteRows.apply(Y, perm)


class _GatherInjective(torch.autograd.Function):
    @staticmethod
    def forward(ctx, X, idx, dim):
        ctx.idx, ctx.dim, ctx.shape = idx, dim, X.shape
        return X.index_select(dim, idx)

    @staticmethod
    @once_differentiable
    def backward(ctx, G):
        out = G.new_zeros(ctx.shape)
        return out.index_copy_(ctx.dim, ctx.idx, G), None, None


def gather_injective(X: torch.Tensor, idx: torch.Tensor,
                     dim: int) -> torch.Tensor:
    """X.index_select(dim, idx) for distinct indices idx [n]; the backward
    writes each gradient slice into its own slot (no accumulation)."""
    return _GatherInjective.apply(X, idx, dim % X.dim())
