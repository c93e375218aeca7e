"""Rank functions of the port's sharded-path tests (tests/test_torch_band_shard.py,
tests/test_torch_parallel.py): ``parallel.comm.run_ranks`` spawns k ranks
and each runs one of these, importing this module by name. It imports
neither JAX nor the JAX package, so the ranks start light. Each function
returns what the tests compare, gathered over the particle group: every
rank returns the same gathered tensors, and the parameter gradients summed
over the mesh."""

import numpy as np
import torch

from sph_nca_tpu_torch.models.cell_step import (
    rollout_cells,
    rollout_cells_batched,
)
from sph_nca_tpu_torch.models.nca import MLPParams
from sph_nca_tpu_torch.models.rollout import rollout_batch
from sph_nca_tpu_torch.ops.batched import batched_scatter
from sph_nca_tpu_torch.ops.cells import build_cell_engine
from sph_nca_tpu_torch.parallel import band_shard as BS
from sph_nca_tpu_torch.parallel import comm
from sph_nca_tpu_torch.parallel import mesh as MS
from sph_nca_tpu_torch.training.trainer import make_optimizer


FIRE_SEED = 5


def _grad_params(params):
    return MLPParams(*(p.detach().clone().requires_grad_(True)
                       for p in params))


def _summed_grads(params):
    return [comm.all_reduce_(p.grad.clone()) for p in params]


def band_checks(k, eng, surf_eng, A, params, cfg, b, h, surf):
    """The band engine's sharded paths on this rank (engines built on the
    host with ``block_multiple=k``): perception in both halo modes, a
    3-step rollout, the BPTT gradient of a 2-step rollout, a 3-step surface
    rollout (``surf``: A0 [B, N, F], normals [N, 3], tangents [B, N, 3]),
    and the exchange counters of the perception."""
    mesh = MS.make_mesh(data=1, particle=k)
    gather = lambda t: MS.particle_gather(t, mesh)  # noqa: E731
    X = MS.particle_slice(batched_scatter(eng, A), mesh)
    out = {"make_mesh": [MS.coords(mesh), mesh.mesh_dim_names],
           "mesh_shapes": [tuple(MS.make_mesh(**kw).shape) for kw in (
               {}, {"data": k}, {"particle": k})]}
    for halo in ("targeted", "allgather"):
        shards, st = BS.shard_band_engine(eng, k, halo=halo)
        loc = BS.place_shards(shards, mesh, "cpu")
        comm.reset_stats()
        ga, sm = BS.perceive_band_sharded(loc, st, X, b, True, mesh=mesh)
        out[halo] = {"ga": gather(ga), "sm": gather(sm),
                     "stats": comm.read_stats()}
    shards, st = BS.shard_band_engine(eng, k)
    loc = BS.place_shards(shards, mesh, "cpu")
    out["rollout"] = gather(BS.rollout_band_sharded(
        params, cfg, loc, st, mesh, X, b, 1, 3, h, fire_rate=1.0))

    p = _grad_params(params)
    X0 = X.clone().requires_grad_(True)
    fin = BS.rollout_band_sharded(p, cfg, loc, st, mesh, X0, b, 1, 2, h,
                                  fire_rate=1.0)
    loss = torch.tanh(fin).sum()
    loss.backward()
    out["loss"] = float(comm.all_reduce_(loss.detach().reshape(1)))
    out["grads"] = _summed_grads(p)
    out["grad_X"] = gather(X0.grad)

    A0, nrm, t0 = surf
    shards, st = BS.shard_band_engine(surf_eng, k)
    loc = BS.place_shards(shards, mesh, "cpu")
    rows = surf_eng.num_cells * surf_eng.slots_per_cell
    fS, ftd = BS.rollout_mesh_band_sharded(
        params, cfg, loc, st, mesh,
        MS.particle_slice(batched_scatter(surf_eng, A0), mesh),
        MS.particle_slice(surf_eng.scatter(nrm), mesh),
        MS.particle_slice(batched_scatter(surf_eng, t0).reshape(rows, b, 3),
                          mesh),
        b, 1, 3, h, fire_rate=1.0)
    out["surface"] = (gather(fS), torch.stack([gather(t) for t in ftd], -1))
    return out


def cell_checks(k, x, h, A, params, cfg, xb, hb, AB, params_b, cfg_b, b):
    """The cell engine's sharded kernel paths on this rank: the recompute
    engine (2.1-2.3) and float32 tables (2.4-2.6), each a 3-step rollout
    and its gradient; the batched table path (2.4 / 2.6 / 2.8) on
    [B, C/k, M, F]."""
    mesh = MS.make_mesh(data=1, particle=k)
    gather = lambda t: MS.particle_gather(t, mesh, dim=-3)  # noqa: E731
    out = {}
    for label, tables in (("recompute", None), ("tables", "float32")):
        eng = build_cell_engine(x, h, n_shards=k, pair_tables=tables,
                                device="cpu")
        sh = MS.shard_cell_engine(eng, mesh)
        S0 = MS.particle_slice(eng.scatter(A), mesh)
        real = (sh.vs > 0).to(S0.dtype)[..., None]
        p = _grad_params(params)
        fin = rollout_cells(p, cfg, sh, S0, torch.Generator(), 3, h,
                            fire_rate=1.0)
        loss = torch.sum((fin * real) ** 2)
        loss.backward()
        out[label] = {"final": gather(fin),
                      "loss": float(comm.all_reduce_(
                          loss.detach().reshape(1))),
                      "grads": _summed_grads(p)}
    # the recompute engine at fire_rate 0.5 from a seeded generator, shared
    # by the ranks (``ops.batched.fire_draws``)
    eng = build_cell_engine(x, h, n_shards=k, device="cpu")
    sh = MS.shard_cell_engine(eng, mesh)
    with torch.no_grad():
        out["fire_half"] = gather(rollout_cells(
            params, cfg, sh, MS.particle_slice(eng.scatter(A), mesh),
            torch.Generator().manual_seed(FIRE_SEED), 3, h, fire_rate=0.5))
    eng = build_cell_engine(xb, hb, n_shards=k, pair_tables="float32",
                            device="cpu")
    sh = MS.shard_cell_engine(eng, mesh)
    SB = MS.particle_slice(batched_scatter(eng, AB), mesh)
    with torch.no_grad():
        out["batched"] = gather(rollout_cells_batched(
            params_b, cfg_b, sh, SB, b, torch.Generator(), 3, hb,
            fire_rate=1.0))
    return out


def _adam_state(opt, params):
    return [{k: v.clone() for k, v in opt.state[p].items()} for p in params]


def train_checks(graph, x, A0, params, cfg, h, steps, collect, img,
                 loss_cfg, meshes):
    """``make_sharded_train_step`` on each (data, particle) mesh of
    ``meshes`` with its number of iterations, from the same replicated
    parameters: per mesh, the losses and this rank's parameters and Adam
    state after the last iteration."""
    from sph_nca_tpu_torch.parallel.shard import (
        make_sharded_train_step,
        mse_loss_piece,
    )

    out = []
    for (nd, npart), iters in meshes:
        mesh = MS.make_mesh(data=nd, particle=npart)
        p = MLPParams(*(t.requires_grad_(True)
                        for t in MS.replicate(params, mesh)))
        opt, sched = make_optimizer(list(p), 3e-3)
        bsz, n = A0.shape[:2]
        piece = mse_loss_piece(img, loss_cfg, MS.particle_slice(x, mesh),
                               bsz, n)
        step = make_sharded_train_step(cfg, opt, piece, h, mesh, steps,
                                       scheduler=sched)
        A_loc = MS.shard_batch(A0, mesh)
        g_loc = MS.shard_graph(graph, mesh)
        losses = [step.fn(p, g_loc, A_loc, 7, i, steps, collect)[0]
                  for i in range(iters)]
        out.append({"losses": losses,
                    "params": [t.detach().clone() for t in p],
                    "state": _adam_state(opt, p)})
    return {"meshes": out,
            "draws": train_draws(graph, x, A0[:1], params, cfg, h, steps,
                                 collect, img, loss_cfg)}


def train_draws(graph, x, A1, params, cfg, h, steps, collect, img,
                loss_cfg):
    """One sharded step at fire_rate 0.5 on a data 2 x particle 1 mesh
    whose samples are all A1 [1, N, C]: this rank's rolled-out block
    [2, N, C] (its two samples). Independent draws give every sample, on
    every rank, its own trajectory."""
    import dataclasses

    from sph_nca_tpu_torch.parallel.shard import (
        make_sharded_train_step,
        mse_loss_piece,
    )

    mesh = MS.make_mesh(data=2, particle=1)
    p = MLPParams(*(t.clone().requires_grad_(True)
                    for t in MS.replicate(params, mesh)))
    opt, _ = make_optimizer(list(p), 3e-3)
    n = A1.shape[1]
    step = make_sharded_train_step(
        dataclasses.replace(cfg, fire_rate=0.5), opt,
        mse_loss_piece(img, loss_cfg, x, 4, n), h, mesh, steps)
    A_loc = MS.shard_batch(A1.expand(4, n, A1.shape[2]).contiguous(), mesh)
    return step.fn(p, MS.shard_graph(graph, mesh), A_loc, 7, 0, steps,
                   collect)[1]


def single_process_train(graph, x, A0, params, cfg, h, steps, collect, img,
                         loss_cfg, iters):
    """The same update on one process: ``training.trainer``'s objective on
    the whole batch, normalized gradients, Adam with its schedule."""
    from sph_nca_tpu_torch.training.trainer import (
        make_mse_bundle,
        normalize_grads_,
    )

    bundle = make_mse_bundle(img, loss_cfg)
    p = _grad_params(params)
    opt, sched = make_optimizer(list(p), 3e-3)
    losses = []
    for _ in range(iters):
        o = rollout_batch(p, cfg, graph, A0, torch.Generator(), steps, h,
                          n_steps=steps, collect_steps=collect)
        total = bundle.batch_total(x, o.final)
        for s in range(len(collect)):
            total = total + 0.1 * bundle.batch_total(x, o.collected[:, s])
        opt.zero_grad(set_to_none=True)
        total.backward()
        normalize_grads_(p)
        opt.step()
        sched.step()
        losses.append(total.item())
    return {"losses": losses, "params": [t.detach().clone() for t in p],
            "state": _adam_state(opt, p)}


def states(rng, shape, lo=-0.5, hi=1.0):
    """Uniform states whose alpha lane keeps 0.005 away from the alive
    threshold 0.1 (an ulp must not flip a life mask)."""
    A = rng.uniform(lo, hi, shape).astype(np.float32)
    a = A[..., 3]
    near = np.abs(a - 0.1) < 0.005
    A[..., 3] = np.where(near, np.where(a < 0.1, 0.09, 0.11), a)
    return torch.from_numpy(A)
