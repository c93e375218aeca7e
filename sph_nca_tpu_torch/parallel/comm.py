"""Collectives of the sharded paths on ``torch.distributed``, and the rank
launcher.

The JAX package gets its collectives from ``shard_map`` / GSPMD, and their
transposes from JAX's autodiff. The port runs one process per shard and
makes each exchange explicit:

  ``all_gather(x, group, dim)``  every rank's ``x`` concatenated along
                                 ``dim`` in group-rank order; its backward
                                 gives each rank the sum of every rank's
                                 cotangent for its own slice (JAX's
                                 ``all_gather^T = psum_scatter``);
  ``ppermute(x, shift, group)``  rank r sends ``x`` to rank (r + shift) % k
                                 and returns what rank (r - shift) % k sent
                                 (JAX's ``ppermute`` on a ring); its
                                 backward is the reverse shift;
  ``all_reduce_(x, group)``      an in-place sum (no gradient), for the
                                 optimizer's gradients;
  ``broadcast_(x, group)``       rank 0's values in place (no gradient);
  ``reduce_scatter_raw(x, group, dim)``  the sum over the group of the
                                 gathered-shape ``x``, each rank keeping its
                                 own slice of ``dim`` (no gradient; the
                                 gather's backward).

Both differentiable collectives are ``torch.autograd.Function``s of this
module: ``torch.distributed.nn.functional`` is deprecated.

The transport is the process group's. NCCL moves CUDA tensors on the
device. gloo moves host memory: CPU tensors as they are, and CUDA tensors
(several ranks sharing one card, which NCCL does not take in one
communicator) through pinned host buffers, copied out and back in this
module and counted in ``STATS["staged_bytes"]``. The caller picks the
backend (``run_ranks``, ``mesh.make_mesh``); nothing here switches backend
or device when a collective fails: the error propagates.

``STATS`` counts the collectives this process issued and the bytes it sent
(``sent_bytes``: for a gather, its own slice once; for a reduction, the
whole tensor) since ``reset_stats()``.

``run_ranks(fn, k, *args, device=..., backend=...)`` spawns k ranks (the
``spawn`` start method, a ``FileStore`` in a fresh temporary directory: no
port, no network), runs ``fn(*args)`` in each and returns the results in
rank order. ``rank_generator(seed, step, rank)`` is the per-rank stream of
the sharded rollouts' fire draws, the counterpart of JAX's
``fold_in(fold_in(key, step), axis_index)``.
"""

from __future__ import annotations

import os
import tempfile
import time
import traceback
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

STATS = {"collectives": 0, "sent_bytes": 0, "staged_bytes": 0}


def reset_stats() -> None:
    for key in STATS:
        STATS[key] = 0


def read_stats() -> dict:
    return dict(STATS)


def _nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


def _staged(x: torch.Tensor, group) -> bool:
    """Whether ``x`` goes through a host buffer: a CUDA tensor on a gloo
    group."""
    return x.device.type == "cuda" and dist.get_backend(group) == "gloo"


def _to_wire(x: torch.Tensor, group) -> torch.Tensor:
    """The tensor the group's transport moves: ``x`` itself (contiguous), or
    a pinned host copy of a CUDA tensor on a gloo group."""
    x = x.contiguous()
    if not _staged(x, group):
        return x
    host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    host.copy_(x)
    STATS["staged_bytes"] += _nbytes(x)
    return host


def _from_wire(w: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A received wire tensor on ``like``'s device."""
    if w.device == like.device:
        return w
    STATS["staged_bytes"] += _nbytes(w)
    return w.to(like.device)


def _global_rank(group, group_rank: int) -> int:
    return group_rank if group is None else dist.get_global_rank(
        group, group_rank)


def _count(nbytes: int) -> None:
    STATS["collectives"] += 1
    STATS["sent_bytes"] += nbytes


# ---- the collectives without a gradient -------------------------------------


def gather_raw(x: torch.Tensor, group=None, dim: int = 0) -> torch.Tensor:
    """Every rank's ``x`` (one shape on all ranks) concatenated along ``dim``
    in group-rank order."""
    k = dist.get_world_size(group)
    if k == 1:
        return x
    w = _to_wire(x, group)
    parts = [torch.empty_like(w) for _ in range(k)]
    dist.all_gather(parts, w, group=group)
    _count(_nbytes(w))
    return _from_wire(torch.cat(parts, dim=dim), x)


def ppermute_raw(x: torch.Tensor, shift: int, group=None) -> torch.Tensor:
    """Send ``x`` to group rank (r + shift) % k; return what rank
    (r - shift) % k sent (the same shape on every rank)."""
    k = dist.get_world_size(group)
    if shift % k == 0:
        return x
    r = dist.get_rank(group)
    dst = _global_rank(group, (r + shift) % k)
    src = _global_rank(group, (r - shift) % k)
    send = _to_wire(x, group)
    recv = torch.empty_like(send)
    works = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, send, dst, group),
        dist.P2POp(dist.irecv, recv, src, group)])
    for work in works:
        work.wait()
    _count(_nbytes(send))
    return _from_wire(recv, x)


def all_reduce_(x: torch.Tensor, group=None) -> torch.Tensor:
    """Sum ``x`` over the group, in place; returns ``x``. Half-precision
    tensors are summed in float32."""
    if dist.get_world_size(group) == 1:
        return x
    src = x if x.dtype == torch.float32 or x.dtype == torch.float64 \
        else x.float()
    w = _to_wire(src, group)
    dist.all_reduce(w, group=group)
    _count(_nbytes(w))
    x.copy_(_from_wire(w, x))
    return x


# torch 2.13 renames reduce_scatter_tensor (same arguments) and deprecates
# the old name; earlier versions have only the old one
_reduce_scatter = getattr(dist, "reduce_scatter_single", None) or \
    dist.reduce_scatter_tensor


def reduce_scatter_raw(x: torch.Tensor, group=None,
                       dim: int = 0) -> torch.Tensor:
    """The transpose of ``gather_raw``: ``x`` (the gathered shape, one on
    every rank) summed over the group, and group rank r's slice r of ``dim``
    returned to it. One reduce-scatter, which moves a rank's share of ``x``
    (JAX's ``psum_scatter``); half-precision tensors are summed in
    float32."""
    k = dist.get_world_size(group)
    if k == 1:
        return x
    src = x if x.dtype in (torch.float32, torch.float64) else x.float()
    w = _to_wire(src.movedim(dim, 0), group)
    out = w.new_empty((w.shape[0] // k,) + tuple(w.shape[1:]))
    _reduce_scatter(out, w, group=group)
    _count(_nbytes(w))
    return _from_wire(out, x).movedim(0, dim).to(x.dtype)


def broadcast_(x: torch.Tensor, group=None) -> torch.Tensor:
    """Group rank 0's values into ``x`` on every rank, in place; returns
    ``x``."""
    if dist.get_world_size(group) == 1:
        return x
    src = _global_rank(group, 0)
    w = _to_wire(x, group)
    dist.broadcast(w, src, group=group)
    _count(_nbytes(w) if dist.get_rank(group) == 0 else 0)
    x.copy_(_from_wire(w, x))
    return x


# ---- the differentiable collectives -----------------------------------------


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return gather_raw(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter_raw(g, ctx.group, ctx.dim), None, None


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, shift, group):
        ctx.shift, ctx.group = shift, group
        return ppermute_raw(x, shift, group)

    @staticmethod
    def backward(ctx, g):
        return ppermute_raw(g, -ctx.shift, ctx.group), None, None


def all_gather(x: torch.Tensor, group=None, dim: int = 0) -> torch.Tensor:
    """Differentiable ``gather_raw``: the backward sums every rank's
    cotangent of the gathered tensor and hands each rank its own slice
    (``reduce_scatter_raw``)."""
    if dist.get_world_size(group) == 1:
        return x
    return _AllGather.apply(x, group, dim % x.dim())


def ppermute(x: torch.Tensor, shift: int, group=None) -> torch.Tensor:
    """Differentiable ``ppermute_raw``: the backward shifts the cotangent
    back by ``-shift``."""
    if shift % dist.get_world_size(group) == 0:
        return x
    return _PPermute.apply(x, shift, group)


# ---- per-rank streams ----------------------------------------------------------


def rank_seed(seed: int, step: int, rank: int) -> int:
    """A 63-bit seed for (seed, step, rank): numpy's SeedSequence spreads
    the three, so neighbouring steps and ranks get unrelated streams."""
    state = np.random.SeedSequence([int(seed), int(step), int(rank)])
    return int(state.generate_state(1, np.uint64)[0] >> np.uint64(1))


def rank_generator(seed: int, step: int, rank: int,
                   device="cpu") -> torch.Generator:
    """The fire-draw generator of one rank at one step."""
    return torch.Generator(device=device).manual_seed(
        rank_seed(seed, step, rank))


# ---- the launcher ----------------------------------------------------------------


def default_backend(device) -> str:
    """NCCL for CUDA ranks, gloo for CPU ranks: each moves the memory its
    ranks compute in. Several ranks on one card need ``backend="gloo"``."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def rank_device(device, rank: int, backend: str) -> torch.device:
    """The device rank ``rank`` computes on: the CPU, or a card. NCCL takes
    one rank a card (rank i on card i); gloo ranks share card 0."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu'")
    if backend == "nccl":
        if rank >= torch.cuda.device_count():
            raise RuntimeError(
                f"nccl takes one rank a card: rank {rank} of a machine with "
                f"{torch.cuda.device_count()} cards; pass backend='gloo' to "
                "share a card")
        return torch.device("cuda", rank)
    return torch.device("cuda", dev.index or 0)


def _rank_main(rank, fn, k, tmp, device, backend, args):
    try:
        dev = rank_device(device, rank, backend)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        else:
            # k ranks share the host's cores (and a test run's workers)
            torch.set_num_threads(1)
        store = dist.FileStore(os.path.join(tmp, "store"), k)
        dist.init_process_group(backend, store=store, rank=rank,
                                world_size=k)
        try:
            result = fn(*args)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        finally:
            dist.destroy_process_group()
        torch.save(result, os.path.join(tmp, f"result{rank}.pt"))
    except BaseException:
        with open(os.path.join(tmp, f"error{rank}.txt"), "w") as fh:
            fh.write(traceback.format_exc())
        raise


def run_ranks(fn, k: int, *args, device="cuda", backend: Optional[str] = None,
              timeout: float = 900.0) -> list:
    """Spawn ``k`` ranks; each sets its device (``rank_device``), joins a
    ``backend`` process group of world size k (default
    ``default_backend(device)``), runs ``fn(*args)`` and sends its result
    back. Returns the results in rank order.

    ``fn`` and ``args`` are pickled (``fn`` by import path; CPU tensors go
    through shared memory). If a rank fails, or the ranks outlast
    ``timeout`` seconds, every rank still running is terminated and this
    raises with each failed rank's traceback. Nothing else falls back: the
    device and backend are the caller's."""
    backend = backend or default_backend(device)
    if backend not in ("gloo", "nccl"):
        raise ValueError(f"backend must be 'gloo' or 'nccl', got {backend!r}")
    if backend == "nccl" and torch.device(device).type != "cuda":
        raise ValueError("nccl moves CUDA tensors: pass device='cuda'")
    with tempfile.TemporaryDirectory(prefix="sph_nca_ranks_") as tmp:
        ctx = mp.start_processes(
            _rank_main, args=(fn, k, tmp, device, backend, args), nprocs=k,
            join=False, start_method="spawn")
        deadline = time.monotonic() + timeout
        try:
            while not ctx.join(timeout=0.5):
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"{k} ranks of {getattr(fn, '__name__', fn)} ran "
                        f"past {timeout} s")
        except (mp.ProcessRaisedException, mp.ProcessExitedException) as exc:
            errors = []
            for r in range(k):
                path = os.path.join(tmp, f"error{r}.txt")
                if os.path.exists(path):
                    with open(path) as fh:
                        errors.append(f"rank {r}:\n{fh.read()}")
            raise RuntimeError("\n".join(errors) or str(exc)) from exc
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.terminate()
                p.join(timeout=10)
        return [torch.load(os.path.join(tmp, f"result{r}.pt"),
                           weights_only=False) for r in range(k)]
