"""Port parity: the sharded training step on the graph engine
(``sph_nca_tpu_torch/parallel/shard.py``) and the dry run of the sharded
paths (``python -m sph_nca_tpu_torch.parallel.dryrun``), on the CPU with real
ranks over gloo.

The step runs ``dryrun_train_step``'s configuration (a 16 x 16 plane at h =
0.25, 8 channels, 32 hidden units, Adam 3e-3 with the trainer's gradient
normalization and schedule, a 4-step rollout with 4 auxiliary states) at
fire_rate 1, from random states, on a data 2 x particle 1 mesh for two
iterations and on a data 1 x particle 2 mesh for one, each against the same
iterations of the single-process update on the whole batch
(``training.trainer``'s objective). Tolerances: the losses 1e-5 relative
(the pieces are summed over ranks, in another order); the parameters and
Adam's moments (``torch.optim.Adam``'s exp_avg / exp_avg_sq) 1e-5 of their
largest entry: the gradients differ by the order of float sums (~1e-7 of
the normalized gradient), which Adam passes on in proportion to each
entry's relative error; across the ranks of one mesh, the parameters and
the moments bit-equal (every rank applies the same summed gradient). At
fire_rate 0.5 on a data 2 x particle 1 mesh, one sample copied to the whole
batch rolls out to four different states: no two ranks, and no two samples,
draw alike.
"""

import functools
import subprocess
import sys

import numpy as np
import pytest
import torch

from sph_nca_tpu_torch.models.nca import SPHNCAConfig, init_params
from sph_nca_tpu_torch.ops.hashgrid import (
    build_graph,
    default_dims,
    suggest_capacity,
)
from sph_nca_tpu_torch.parallel.comm import run_ranks
from sph_nca_tpu_torch.training.losses import MSELossConfig
from sph_nca_tpu_torch.utils.geometry import grange

import torch_parallel_ranks as R

H, STEPS, BATCH = 0.25, 4, 4
COLLECT = [0, 1, STEPS - 1, STEPS]
MESHES = (((2, 1), 2), ((1, 2), 1))


@functools.cache
def scene():
    x = grange((16, 16), (-1.0, -1.0), (2.0, 2.0)).reshape(-1, 2)
    dims = default_dims(H)
    mpc, k = suggest_capacity(x, H, dims)
    graph = build_graph(x, H, dims, max_per_cell=mpc, k=k)
    cfg = SPHNCAConfig(channels=8, hidden=32, fire_rate=1.0,
                       normalize_perception=1.0 / H)
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    A0 = R.states(np.random.default_rng(4), (BATCH, x.shape[0], 8))
    img = torch.tensor([1.0, 0.5, 0.0, 1.0]).repeat(8, 8, 1)
    loss_cfg = MSELossConfig(gmin=(-1, -1), gsize=(2, 2), image_scale=1.0)
    return graph, x, A0, params, cfg, img, loss_cfg


@functools.cache
def sharded():
    graph, x, A0, params, cfg, img, loss_cfg = scene()
    return run_ranks(R.train_checks, 2, graph, x, A0, params, cfg, H, STEPS,
                     COLLECT, img, loss_cfg, MESHES, device="cpu",
                     backend="gloo")


@functools.cache
def single(iters):
    graph, x, A0, params, cfg, img, loss_cfg = scene()
    return R.single_process_train(graph, x, A0, params, cfg, H, STEPS,
                                  COLLECT, img, loss_cfg, iters)


def _close(got, want, rtol):
    scale = max(float(want.abs().max()), 1e-30)
    assert float((got - want).abs().max()) <= rtol * scale


@pytest.mark.parametrize("m", range(len(MESHES)), ids=["data2xparticle1",
                                                      "data1xparticle2"])
def test_sharded_train_step_matches_single_process(m):
    iters = MESHES[m][1]
    want = single(iters)
    ranks = sharded()
    for res in ranks:
        got = res["meshes"][m]
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5)
        for a, b in zip(got["params"], want["params"]):
            _close(a, b, 1e-5)
        for sa, sb in zip(got["state"], want["state"]):
            assert set(sa) == set(sb) == {"step", "exp_avg", "exp_avg_sq"}
            assert torch.equal(sa["step"], sb["step"])
            for key in ("exp_avg", "exp_avg_sq"):
                _close(sa[key], sb[key], 1e-5)
    # the replicas stay bit-equal
    first = ranks[0]["meshes"][m]
    for res in ranks[1:]:
        for a, b in zip(res["meshes"][m]["params"], first["params"]):
            assert torch.equal(a, b)
        for sa, sb in zip(res["meshes"][m]["state"], first["state"]):
            for key in sa:
                assert torch.equal(sa[key], sb[key])


def test_sharded_step_draws_differ_across_ranks_and_samples():
    # one sample copied to all four samples of a data 2 x particle 1 mesh at
    # fire_rate 0.5: each rank seeds its draws from its global rank, so the
    # two data ranks' blocks, and the two samples of a block, part
    finals = [res["draws"] for res in sharded()]
    blocks = [f[i] for f in finals for i in range(2)]
    for i in range(len(blocks)):
        for j in range(i):
            assert float((blocks[i] - blocks[j]).abs().max()) > 1e-3, (i, j)


def test_dryrun_runs_the_five_paths_on_cpu_ranks():
    proc = subprocess.run(
        [sys.executable, "-m", "sph_nca_tpu_torch.parallel.dryrun",
         "--ranks", "2", "--device", "cpu", "--backend", "gloo"],
        capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    lines = [ln for ln in proc.stdout.splitlines()
             if ln.startswith("dryrun ")]
    assert len(lines) == 5 and all(": OK |" in ln for ln in lines), \
        proc.stdout
    assert "5 paths OK on 2 ranks (cpu, gloo)" in proc.stdout
