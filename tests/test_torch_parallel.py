"""Port parity: the mesh, the shard-major cell layout and the sharded cell
kernels (``sph_nca_tpu_torch/parallel/{mesh,cell_shard}.py``,
``build_cell_engine(n_shards=k)``, ``ops/pair_kernel.py``'s shard-major
rows), on
the CPU with real ranks (``parallel.comm.run_ranks`` over gloo) where ranks
are needed.

The cell scene is tests/test_parallel.py's: a 24 x 24 plane at h = 0.2, 8
channels, 16 hidden units, 3 steps at fire_rate 1; the batched scene its
20 x 20 plane at h = 0.25, float32 tables, B = 3, 32 hidden units.

Tolerances, as tests/test_parallel.py holds JAX's sharded paths:
- integer layouts of ``build_cell_engine(n_shards=k)`` equal JAX's exactly
  for k in {1, 2, 4}, positions too (the same float64 -> float32 roundings);
- the shard-major engine on one device and over k ranks
  against the unsharded engine: states 1e-5 absolute (|A| <~ 1), the loss
  1e-6 relative between the two sharded forms and 1e-5 against the
  unsharded engine, the parameter gradients of the 3-step loss 1e-4 (rtol
  and atol) between the sharded forms;
- the batched table path over k ranks: rtol 2e-5, atol 1e-6;
- the fire draws: at fire_rate 0.5 the k ranks' rollout from one seeded
  generator against the same engine's on one device from the same seed,
  1e-5 (a rank draws the whole engine's mask and keeps its cells).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sph_nca_tpu.ops.cells import build_cell_engine as jax_build_cells
from sph_nca_tpu.parallel import factorize as jax_factorize
from sph_nca_tpu_torch.models.cell_step import (
    rollout_cells,
    rollout_cells_batched,
)
from sph_nca_tpu_torch.models.nca import MLPParams, SPHNCAConfig, init_params
from sph_nca_tpu_torch.ops import pair_kernel as PK
from sph_nca_tpu_torch.ops.batched import batched_gather_back, batched_scatter
from sph_nca_tpu_torch.ops.cells import build_cell_engine
from sph_nca_tpu_torch.parallel import factorize
from sph_nca_tpu_torch.parallel.comm import run_ranks
from sph_nca_tpu_torch.utils.geometry import grange

import torch_parallel_ranks as R

H, HB, B = 0.2, 0.25, 3
INT_FIELDS = ["slot_of_particle", "win_cells", "blk_win_cells",
              "blk2_win_cells"]


@functools.cache
def cells_scene():
    x = grange((24, 24), (-1.0, -1.0), (2.0, 2.0)).reshape(-1, 2)
    cfg = SPHNCAConfig(channels=8, hidden=16, fire_rate=1.0)
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    A = R.states(np.random.default_rng(1), (x.shape[0], 8), 0.0, 1.0)
    xb = grange((20, 20), (-1.0, -1.0), (2.0, 2.0)).reshape(-1, 2)
    cfg_b = SPHNCAConfig(channels=8, hidden=32, fire_rate=1.0,
                         normalize_perception=1.0 / HB)
    params_b = init_params(cfg_b, torch.Generator().manual_seed(2),
                           device="cpu")
    AB = R.states(np.random.default_rng(3), (B, xb.shape[0], 8), 0.0, 1.0)
    return x, cfg, params, A, xb, cfg_b, params_b, AB


@functools.cache
def sharded(k):
    x, cfg, params, A, xb, cfg_b, params_b, AB = cells_scene()
    return run_ranks(R.cell_checks, k, k, x, H, A, params, cfg, xb, HB, AB,
                     params_b, cfg_b, B, device="cpu", backend="gloo")


@functools.cache
def one_device(k, tables):
    """The 3-step rollout and its loss gradient on one process, on an
    engine built with n_shards=k (k = 1: the unsharded layout)."""
    x, cfg, params, A, *_ = cells_scene()
    eng = build_cell_engine(x, H, n_shards=k, pair_tables=tables,
                            device="cpu")
    p = MLPParams(*(t.clone().requires_grad_(True) for t in params))
    fin = rollout_cells(p, cfg, eng, eng.scatter(A), torch.Generator(), 3, H,
                        fire_rate=1.0)
    final = eng.gather_back(fin)
    loss = torch.sum(final ** 2)
    loss.backward()
    return eng, final.detach(), loss.item(), [t.grad for t in p]


# ---- the mesh and the layout ----------------------------------------------------


def test_public_names_match_jax():
    import sph_nca_tpu.parallel as jax_parallel
    import sph_nca_tpu_torch.parallel as port_parallel

    assert port_parallel.__all__ == jax_parallel.__all__
    for name in port_parallel.__all__:
        assert hasattr(port_parallel, name), name


@pytest.mark.parametrize("n,prefer", [(8, 0), (4, 0), (1, 0), (8, 8), (2, 0),
                                      (6, 0), (4, 4)])
def test_factorize_matches_jax(n, prefer):
    assert factorize(n, prefer) == jax_factorize(n, prefer)


@pytest.mark.parametrize("k", [1, 2, 4])
def test_shard_major_layout_matches_jax(k):
    x = cells_scene()[0].numpy()
    je = jax_build_cells(jnp.asarray(x), H, n_shards=k)
    te = build_cell_engine(x, H, n_shards=k, device="cpu")
    assert te.n_shards == k and te.num_cells % (16 * k) == 0
    for name in INT_FIELDS + ["xs", "blk_xs", "blk_xw", "blk2_xs",
                              "blk2_xw"]:
        np.testing.assert_array_equal(getattr(te, name).numpy(),
                                      np.asarray(getattr(je, name)), name)
    np.testing.assert_allclose(te.vs.numpy(), np.asarray(je.vs), rtol=1e-6)
    # each shard holds the same count of each bucket
    assert te.blk_xs.shape[0] % k == 0 and te.blk2_xs.shape[0] % k == 0


def test_split_merge_rows_shard_major():
    a = torch.arange(24).reshape(12, 2)
    r1, r2 = PK.split_rows(a, 9, shards=3)  # 3 shards of [3 | 1] blocks
    assert r1[:, 0].tolist() == [0, 2, 4, 8, 10, 12, 16, 18, 20]
    assert r2[:, 0].tolist() == [6, 14, 22]
    assert torch.equal(PK.merge_rows(r1, r2, shards=3), a)
    b = torch.arange(48).reshape(2, 12, 2)
    r1, r2 = PK.split_rows(b, 9, dim=-2, shards=3)
    assert torch.equal(PK.merge_rows(r1, r2, dim=-2, shards=3), b)


@pytest.mark.parametrize("tables", [None, "float32"])
@pytest.mark.parametrize("k", [2, 4])
def test_shard_major_engine_on_one_device_matches(k, tables):
    _, ref, ref_loss, _ = one_device(1, tables)
    _, got, loss, _ = one_device(k, tables)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=1e-5)
    assert np.isclose(loss, ref_loss, rtol=1e-5)


# ---- the sharded kernel paths over k ranks ---------------------------------------


@pytest.mark.parametrize("tables", ["recompute", "tables"])
@pytest.mark.parametrize("k", [2, 4])
def test_sharded_cells_rollout_and_grads_match(k, tables):
    eng, want, want_loss, want_grads = one_device(
        k, None if tables == "recompute" else "float32")
    _, ref, ref_loss, _ = one_device(1, None if tables == "recompute"
                                     else "float32")
    for res in sharded(k):
        r = res[tables]
        got = eng.gather_back(r["final"])
        np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=1e-5)
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5)
        assert np.isclose(r["loss"], ref_loss, rtol=1e-5)
        assert np.isclose(r["loss"], want_loss, rtol=1e-6)
        for g, w in zip(r["grads"], want_grads):
            np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-4,
                                       atol=1e-4)


@pytest.mark.parametrize("k", [2, 4])
def test_sharded_batched_tables_match(k):
    _, _, _, _, xb, cfg_b, params_b, AB = cells_scene()
    eng = build_cell_engine(xb, HB, n_shards=k, pair_tables="float32",
                            device="cpu")
    ref_eng = build_cell_engine(xb, HB, pair_tables="float32", device="cpu")
    with torch.no_grad():
        ref = rollout_cells_batched(params_b, cfg_b, ref_eng,
                                    batched_scatter(ref_eng, AB), B,
                                    torch.Generator(), 3, HB, fire_rate=1.0)
    want = batched_gather_back(ref_eng, ref, B).numpy()
    for res in sharded(k):
        got = batched_gather_back(eng, res["batched"], B).numpy()
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=1e-6)


@pytest.mark.parametrize("k", [2, 4])
def test_sharded_cells_fire_draws_match_one_device(k):
    x, cfg, params, A, *_ = cells_scene()
    eng = build_cell_engine(x, H, n_shards=k, device="cpu")
    with torch.no_grad():
        want = eng.gather_back(rollout_cells(
            params, cfg, eng, eng.scatter(A),
            torch.Generator().manual_seed(R.FIRE_SEED), 3, H,
            fire_rate=0.5)).numpy()
        every = eng.gather_back(rollout_cells(
            params, cfg, eng, eng.scatter(A), torch.Generator(), 3, H,
            fire_rate=1.0)).numpy()
    # the mask matters: half the slots keep their state a step
    assert np.abs(want - every).max() > 1e-2
    for res in sharded(k):
        got = eng.gather_back(res["fire_half"]).numpy()
        np.testing.assert_allclose(got, want, atol=1e-5)
