"""Port parity: the halo-sharded band engine (``sph_nca_tpu_torch/parallel/
band_shard.py``) against the unsharded port and against the JAX package, on
the CPU with real ranks (``parallel.comm.run_ranks`` over gloo).

The scene is tests/test_band_shard.py's: 220 random points in [-1, 1]^3,
h = 0.3, blocks of 16 rows, float32 tables, ``block_multiple=4``, B = 3
samples of 8 channels; the surface scene its 220 points on a sphere of
radius 0.8. One spawn of k ranks serves every check of that k (a module
fixture).

Tolerances.
- The host-side sharding (``shard_band_engine``: export and send lists, halo
  sources, per-shard far buckets and their permutation, the distances) and
  ``comm_bytes_per_pass`` equal the JAX package's exactly.
- Sharded perception equals the unsharded port's at rtol / atol 1e-6, as
  tests/test_band_shard.py holds JAX's (the same products over the same
  tables, the far buckets cut per shard: zero-padded columns can change
  the order of a product's sums).
- The 3-step rollout and the surface rollout at fire_rate 1: 1e-4 of the
  largest state (JAX's sharded-vs-global bar); tangents where alive 1e-3.
- The BPTT gradient of a 2-step rollout: parameters and initial state to
  1e-3 of the largest entry, as JAX's test.
- The port's k = 4 rollout against JAX's ``rollout_band_sharded`` on the
  8-device CPU mesh, the same inputs and parameters (carried across by
  ``io/convert.py``): 1e-4 of the largest state.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sph_nca_tpu.models import SPHNCAConfig as JaxConfig
from sph_nca_tpu.models import init_params as jax_init_params
from sph_nca_tpu.ops.bands import build_band_engine as jax_build_band
from sph_nca_tpu.ops.batched import batched_gather_back as jax_gather_back
from sph_nca_tpu.ops.batched import batched_scatter as jax_scatter
from sph_nca_tpu.parallel import make_mesh as jax_make_mesh
from sph_nca_tpu.parallel.band_shard import (
    comm_bytes_per_pass as jax_comm_bytes,
)
from sph_nca_tpu.parallel.band_shard import (
    rollout_band_sharded as jax_rollout_sharded,
)
from sph_nca_tpu.parallel.band_shard import (
    shard_band_engine as jax_shard_band,
)
from sph_nca_tpu_torch.io.convert import params_from_jax_numpy
from sph_nca_tpu_torch.models.cell_step import rollout_cells_batched
from sph_nca_tpu_torch.models.nca import MLPParams, SPHNCAConfig
from sph_nca_tpu_torch.models.surface import (
    normalize,
    orthogonalize,
    rollout_mesh_batched,
)
from sph_nca_tpu_torch.ops.bands import (
    build_band_engine,
    perceive_band_batched,
)
from sph_nca_tpu_torch.ops.batched import batched_gather_back, batched_scatter
from sph_nca_tpu_torch.parallel import band_shard as BS
from sph_nca_tpu_torch.parallel.comm import run_ranks

import torch_parallel_ranks as R

N, F, B, H, K = 220, 8, 3, 0.3, 4


def rel_err(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.abs(a - b).max()) / max(float(np.abs(b).max()), 1e-30)


@functools.cache
def scene(k):
    rng = np.random.default_rng(0)
    x = rng.uniform(-1, 1, (N, 3)).astype(np.float32)
    A = rng.normal(size=(B, N, F)).astype(np.float32)
    eng = build_band_engine(x, H, block_rows=16, table_dtype="float32",
                            block_multiple=k, device="cpu")
    assert eng.num_cells % k == 0 and len(eng.far_blocks) > 0
    return x, A, eng


@functools.cache
def surface_scene(k):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(N, 3)).astype(np.float32)
    x /= np.linalg.norm(x, axis=-1, keepdims=True) + 1e-9
    x *= 0.8
    nrm = torch.from_numpy(x / 0.8)
    A0 = torch.from_numpy(rng.normal(size=(B, N, F)).astype(np.float32))
    t0r = torch.from_numpy(rng.normal(size=(B, N, 3)).astype(np.float32))
    t0 = orthogonalize(nrm, normalize(t0r))
    eng = build_band_engine(x, H, block_rows=16, table_dtype="float32",
                            block_multiple=k, device="cpu")
    return eng, (A0, nrm, t0)


@functools.cache
def model():
    kw = dict(channels=F, hidden=32, fire_rate=1.0,
              normalize_perception=1.0 / H)
    jp = jax_init_params(jax.random.key(0), JaxConfig(**kw))
    return JaxConfig(**kw), jp, SPHNCAConfig(**kw), params_from_jax_numpy(
        *(np.asarray(a) for a in jp), device="cpu")


@functools.cache
def sharded(k):
    """Every rank's results of ``band_checks`` for k ranks (one spawn)."""
    _, A, eng = scene(k)
    seng, surf = surface_scene(k)
    _, _, cfg, params = model()
    return run_ranks(R.band_checks, k, k, eng, seng, torch.from_numpy(A),
                     params, cfg, B, H, surf, device="cpu", backend="gloo")


# ---- host side: the sharding itself equals JAX's -------------------------------


@pytest.mark.parametrize("halo", ["targeted", "allgather"])
def test_shard_fields_equal_jax(halo):
    x, _, eng = scene(K)
    je = jax_build_band(jnp.asarray(x), H, block_rows=16,
                        table_dtype="float32", block_multiple=K)
    sh, st = BS.shard_band_engine(eng, K, halo=halo)
    jsh, jst = jax_shard_band(je, K, halo=halo)
    assert (st.k, st.g, st.d, st.P, st.deltas) == (
        jst.k, jst.g, jst.d, jst.P, jst.deltas)
    assert (halo == "targeted") == bool(st.deltas)
    for name in ("export_idx", "halo_src", "far_perm"):
        np.testing.assert_array_equal(getattr(sh, name).numpy(),
                                      np.asarray(getattr(jsh, name)), name)
    assert len(sh.send_idx) == len(jsh.send_idx)
    for a, b in zip(sh.send_idx, jsh.send_idx):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert len(sh.far_groups) == len(jsh.far_groups) > 0
    for a, b in zip(sh.far_groups, jsh.far_groups):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for a, b in zip(sh.far_tabs, jsh.far_tabs):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(sh.Tband.numpy(), np.asarray(jsh.Tband))
    for lanes, itemsize in ((B * F, 4), (8 * 16, 2)):
        assert BS.comm_bytes_per_pass(sh, st, lanes, itemsize) == \
            jax_comm_bytes(jsh, jst, lanes, itemsize)


def test_shard_refuses_a_block_count_it_cannot_split():
    x, _, _ = scene(K)
    eng = build_band_engine(x, H, block_rows=16, table_dtype="float32",
                            device="cpu")
    if eng.num_cells % 3 == 0:
        pytest.skip("this scene's block count divides by 3")
    with pytest.raises(ValueError, match="block_multiple"):
        BS.shard_band_engine(eng, 3)


# ---- the sharded paths over k ranks against the unsharded port ----------------


@pytest.mark.parametrize("k", [2, K])
def test_make_mesh_shapes_match_jax(k):
    want = [tuple(jax_make_mesh(jax.devices()[:k], **kw).shape.values())
            for kw in ({}, {"data": k}, {"particle": k})]
    for res in sharded(k):
        assert res["mesh_shapes"] == want


@pytest.mark.parametrize("k", [2, K])
def test_sharded_perception_matches_global(k):
    _, A, eng = scene(k)
    SB = batched_scatter(eng, torch.from_numpy(A))
    ga0, sm0 = perceive_band_batched(eng, SB, B, True)
    for r, res in enumerate(sharded(k)):
        for halo in ("targeted", "allgather"):
            ga, sm = res[halo]["ga"], res[halo]["sm"]
            np.testing.assert_allclose(ga.numpy(), ga0.numpy(), rtol=1e-6,
                                       atol=1e-6)
            np.testing.assert_allclose(sm.numpy(), sm0.numpy(), rtol=1e-6,
                                       atol=1e-6)
        assert res["make_mesh"] == [(0, r), ("data", "particle")]
    # both exchanges moved something through gloo, nothing through a host
    # buffer (the tensors are on the CPU)
    s_t = sharded(k)[0]["targeted"]["stats"]
    s_a = sharded(k)[0]["allgather"]["stats"]
    assert s_t["collectives"] > 0 and s_a["collectives"] > 0
    assert s_t["staged_bytes"] == s_a["staged_bytes"] == 0


@pytest.mark.parametrize("k", [2, K])
def test_sharded_rollout_matches_global_fr1(k):
    _, A, eng = scene(k)
    _, _, cfg, params = model()
    SB = batched_scatter(eng, torch.from_numpy(A))
    with torch.no_grad():
        ref = rollout_cells_batched(params, cfg, eng, SB, B,
                                    torch.Generator(), 3, H, fire_rate=1.0)
    for res in sharded(k):
        assert rel_err(res["rollout"], ref) < 1e-4


@pytest.mark.parametrize("k", [2, K])
def test_sharded_rollout_grads_match_fr1(k):
    _, A, eng = scene(k)
    _, _, cfg, params = model()
    p = MLPParams(*(t.clone().requires_grad_(True) for t in params))
    X0 = batched_scatter(eng, torch.from_numpy(A)).requires_grad_(True)
    fin = rollout_cells_batched(p, cfg, eng, X0, B, torch.Generator(), 2, H,
                                fire_rate=1.0)
    loss = torch.tanh(fin).sum()
    loss.backward()
    for res in sharded(k):
        assert abs(res["loss"] - loss.item()) < 1e-3 * (
            abs(loss.item()) + 1)
        for got, want in zip(res["grads"], p):
            assert rel_err(got, want.grad) < 1e-3
        assert rel_err(res["grad_X"], X0.grad) < 1e-3
    # the replicas' summed gradients are the same on every rank
    for res in sharded(k)[1:]:
        for a, b in zip(res["grads"], sharded(k)[0]["grads"]):
            assert torch.equal(a, b)


@pytest.mark.parametrize("k", [2, K])
def test_sharded_surface_rollout_matches_global_fr1(k):
    seng, (A0, nrm, t0) = surface_scene(k)
    _, _, cfg, params = model()
    with torch.no_grad():
        ref_A, ref_t = rollout_mesh_batched(params, cfg, seng, A0, nrm, t0,
                                            torch.Generator(), 3, H,
                                            fire_rate=1.0)
    for res in sharded(k):
        fS, ftd = res["surface"]
        got_A = batched_gather_back(seng, fS, B)
        got_t = batched_gather_back(
            seng, ftd.reshape(seng.num_cells, seng.slots_per_cell, B * 3), B)
        assert rel_err(got_A, ref_A) < 1e-4
        alive = (ref_A[..., 3] > 0.1).numpy()
        assert rel_err(got_t.numpy()[alive], ref_t.numpy()[alive]) < 1e-3


def test_sharded_rollout_matches_jax_sharded():
    """The port's k = 4 ranks against JAX's ``rollout_band_sharded`` on the
    8-device CPU mesh (tests/conftest.py), same inputs and parameters."""
    x, A, eng = scene(K)
    jcfg, jp, _, _ = model()
    je = jax_build_band(jnp.asarray(x), H, block_rows=16,
                        table_dtype="float32", block_multiple=K)
    jsh, jst = jax_shard_band(je, K)
    jSB = jax_scatter(je, jnp.asarray(A))
    jout = jax_rollout_sharded(jp, jcfg, jsh, jst, jax_make_mesh(particle=K),
                               jSB, B, jax.random.key(1), 3, H,
                               fire_rate=1.0, remat=False)
    want = np.asarray(jax_gather_back(je, jout.reshape(jSB.shape), B))
    got = batched_gather_back(eng, sharded(K)[0]["rollout"], B).numpy()
    assert rel_err(got, want) < 1e-4
