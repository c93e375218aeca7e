"""Dry run of the sharded paths over K ranks: the port's counterpart of the
JAX package's ``dryrun_multichip`` (``__graft_entry__.py``), its five paths
at tiny shapes (16 channels, 32 hidden units; the graph step JAX's 8
channels), each checked finite:

  graph train step   ``shard.dryrun_train_step`` on the default (data,
                     particle) factorization of K;
  band surface halo  ``band_shard.rollout_mesh_band_sharded``, 2 steps;
  batched cells      the batched-lane rollout on a rank's shard of a cell
                     engine with float32 pair tables (kernels 2.4 / 2.6 /
                     2.8 on CUDA), B = 4, 2 steps;
  cell kernels       ``rollout_cells`` on a rank's shard of a cell engine
                     with bfloat16 tables (2.4 / 2.6), 2 steps;
  band halo          ``band_shard.rollout_band_sharded``, 2 steps, with the
                     exchange's accounting (``comm_bytes_per_pass``).

    python -m sph_nca_tpu_torch.parallel.dryrun --ranks K [--device cuda|cpu]
        [--backend gloo|nccl]

The ranks run on the card unless ``--device cpu`` is given; the backend
defaults to NCCL on the card (one rank a card) and gloo on the CPU, and
``--backend gloo`` shares one card between the ranks. The kernels and the
band engine's native library are built before the ranks start. A failed
path raises in its rank; the command then exits non-zero with the rank's
traceback.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from . import comm
from .mesh import coords, make_mesh, particle_slice

STEPS = 2


def _finite(*tensors) -> None:
    for t in tensors:
        if not bool(torch.isfinite(t).all()):
            raise RuntimeError("a dry-run path produced non-finite values")


def _paths(device) -> list:
    """The five paths on this rank; returns (name, line) pairs."""
    from ..models.cell_step import rollout_cells, rollout_cells_batched
    from ..models.nca import SPHNCAConfig, init_params
    from ..ops.bands import build_band_engine
    from ..ops.batched import batched_scatter
    from ..ops.cells import build_cell_engine
    from ..utils.geometry import grange
    from . import band_shard as BS
    from .mesh import shard_cell_engine
    from .shard import dryrun_train_step

    dev = torch.device(device)
    lines = []
    mesh = make_mesh()
    loss = dryrun_train_step(mesh, device=dev)
    lines.append(("graph train step", f"mesh {tuple(mesh.shape)} loss="
                  f"{loss:.5f}"))

    pmesh = make_mesh(data=1)
    k = pmesh.shape[1]
    gen = np.random.default_rng(5)
    x3 = gen.uniform(-1.0, 1.0, (400, 3)).astype(np.float32)
    beng = build_band_engine(x3, 0.3, block_rows=16, table_dtype="float32",
                             block_multiple=k, device="cpu")
    shards, static = BS.shard_band_engine(beng, k)
    loc = BS.place_shards(shards, pmesh, dev)
    # 16 channels: the kernels of the batched and cell paths take F = 16
    cfg = SPHNCAConfig(channels=16, hidden=32)
    params = init_params(cfg, torch.Generator().manual_seed(0), device=dev)
    bsz = 4
    A = torch.from_numpy(gen.uniform(size=(bsz, 400, 16)).astype(np.float32))
    SB = particle_slice(batched_scatter(beng, A), pmesh).to(dev)
    with torch.no_grad():
        nrm = torch.from_numpy(x3 / np.maximum(
            np.linalg.norm(x3, axis=-1, keepdims=True), 1e-9))
        rows = beng.num_cells * beng.slots_per_cell
        t0 = torch.from_numpy(gen.normal(size=(bsz, 400, 3)).astype(
            np.float32))
        fS, ftd = BS.rollout_mesh_band_sharded(
            params, cfg, loc, static, pmesh, SB,
            particle_slice(beng.scatter(nrm), pmesh).to(dev),
            particle_slice(batched_scatter(beng, t0).reshape(rows, bsz, 3),
                           pmesh).to(dev), bsz, 9, STEPS, 0.3)
        _finite(fS, *ftd)
    lines.append(("band surface halo", f"{k}-way tangent perception and "
                  "diffusion"))

    h = 0.2
    x = grange((16, 16), (-1.0, -1.0), (2.0, 2.0)).reshape(-1, 2)
    ceng = build_cell_engine(x, h, n_shards=k, pair_tables="float32",
                             device=dev)
    sh = shard_cell_engine(ceng, pmesh)
    AB = torch.from_numpy(gen.uniform(size=(bsz, x.shape[0], 16)).astype(
        np.float32)).to(dev)
    with torch.no_grad():
        out = rollout_cells_batched(
            params, cfg, sh, particle_slice(batched_scatter(ceng, AB), pmesh),
            bsz, torch.Generator(dev).manual_seed(4), STEPS, h)
        _finite(out)
    lines.append(("batched cells", f"{k}-way cell sharding x {bsz}-lane "
                  "batch, float32 tables"))

    ceng = build_cell_engine(x, h, n_shards=k, pair_tables="bfloat16",
                             device=dev)
    sh = shard_cell_engine(ceng, pmesh)
    S0 = particle_slice(ceng.scatter(AB[0]), pmesh)
    with torch.no_grad():
        out = rollout_cells(params, cfg, sh, S0,
                            torch.Generator(dev).manual_seed(2), STEPS, h)
        _finite(out)
    lines.append(("cell kernels", f"{k}-way particle sharding, bfloat16 "
                  "tables"))

    comm.reset_stats()
    with torch.no_grad():
        out = BS.rollout_band_sharded(params, cfg, loc, static, pmesh, SB,
                                      bsz, 7, STEPS, 0.3)
        _finite(out)
    acc = BS.comm_bytes_per_pass(shards, static, lanes=bsz * 16, itemsize=4)
    moved = comm.read_stats()
    lines.append(("band halo", f"{k}-way, {acc['mode']}, export fraction "
                  f"{acc['export_fraction']:.2f}, halo bytes/pass "
                  f"{acc['allgather_bytes'] + acc['ppermute_bytes']} vs "
                  f"full-state {acc['full_state_bytes']}; this rank sent "
                  f"{moved['sent_bytes']} bytes in {moved['collectives']} "
                  f"exchanges over {STEPS} steps"))
    return [(name, f"rank {coords(mesh)}: {line}") for name, line in lines]


def _rank(device) -> list:
    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    return _paths(dev)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ranks", type=int, default=2)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--backend", default=None, choices=("gloo", "nccl"))
    args = ap.parse_args(argv)
    if args.device == "cuda":
        from .. import native
        from ..ops import _build

        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass "
                               "--device cpu")
        _build.build()
        native.build()
    results = comm.run_ranks(_rank, args.ranks, args.device,
                             device=args.device, backend=args.backend)
    for name, line in results[0]:
        print(f"dryrun {name}: OK | {line}", flush=True)
    backend = args.backend or comm.default_backend(args.device)
    print(f"dryrun: {len(results[0])} paths OK on {args.ranks} ranks "
          f"({args.device}, {backend})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
