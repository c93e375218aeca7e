"""The fused route of the batched surface step on a band engine
(``ops/mlp_kernel.py`` ``fused_update``, taken by ``models/surface.py``):
its plain version against the composition it replaces, bit for bit, and
the conditions under which the surface rollouts take it.

The composition is the band perception (``bands.perceive_band_samples``),
the tangent projection (``mlp_kernel.project_td``) and the update
(``cell_step._update_samples``); the fused route stops the perception at
the products' raw moments (``bands.perceive_band_moments``) and hands them
to ``fused_update``. On the CPU both run PyTorch's operators in the same
order, so they agree exactly; the card's kernel is held to the composition
in ``tests/test_torch_cuda.py``. The scene: a sphere of 600 points on a band
engine of bfloat16 tables (blocks of 16 rows, far groups of 8), B = 2, a
model of 32 hidden units.
"""

import functools

import numpy as np
import pytest
import torch

from sph_nca_tpu_torch.models import cell_step as CS
from sph_nca_tpu_torch.models import surface as SF
from sph_nca_tpu_torch.models.nca import MLPParams, SPHNCAConfig
from sph_nca_tpu_torch.ops import bands as BD
from sph_nca_tpu_torch.ops import batched as BT
from sph_nca_tpu_torch.ops import mlp_kernel as MK
from sph_nca_tpu_torch.ops.cells import build_cell_engine
from sph_nca_tpu_torch.utils import profiling as P
from sph_nca_tpu_torch.utils.meshes import fibonacci_sphere, sphere_normals

N, H, F, B, STEPS = 600, 0.25, 16, 2, 3


@functools.cache
def _scene(table_dtype="bfloat16"):
    x = fibonacci_sphere(N, 0.8)
    eng = BD.build_band_engine(x, H, block_rows=16, far_group=8,
                               table_dtype=table_dtype, device="cpu")
    assert len(eng.far_tabs) > 0
    return x, torch.from_numpy(sphere_normals(x)), eng


def _model(rule="gated", fire_rate=0.5, seed=0):
    cfg = SPHNCAConfig(channels=F, hidden=32, fire_rate=fire_rate,
                       update_rule=rule, normalize_perception=1.0 / H)
    g = torch.Generator().manual_seed(seed)
    k = cfg.out_features
    params = MLPParams(torch.randn(3 * F, 32, generator=g) * 0.3,
                       torch.randn(32, generator=g) * 0.1,
                       torch.randn(32, k, generator=g) * 0.3,
                       torch.randn(k, generator=g) * 0.1)
    return cfg, params


def _inputs(nrm, seed=1):
    """States [B, N, F] in [-0.5, 1) and unit tangents [B, N, 3] off the
    normals."""
    g = torch.Generator().manual_seed(seed)
    A = torch.rand(B, N, F, generator=g) * 1.5 - 0.5
    t = torch.randn(B, N, 3, generator=g)
    t = t - nrm * torch.sum(nrm * t, dim=-1, keepdim=True)
    return A, t / torch.linalg.vector_norm(t, dim=-1, keepdim=True)


@pytest.mark.parametrize("rule,fire_rate,cfg_rate", [
    ("gated", 1.0, 1.0), ("gated", 0.5, 0.5), ("orig", 0.25, 0.5)])
def test_fused_plain_equals_composition(rule, fire_rate, cfg_rate):
    """One step's update both ways: the same pre-mask blur and the same
    pre-life-mask state, bit for bit."""
    x, nrm, eng = _scene()
    cfg, params = _model(rule, cfg_rate)
    A, t = _inputs(nrm)
    S = eng.scatter(A)
    nd = SF.normal_components(eng.scatter(nrm))
    td = SF.normal_components(eng.scatter(t))
    weights = CS._mlp_weights(params, cfg, F, H, "bfloat16")
    u = torch.rand(S.shape[:-1], generator=torch.Generator().manual_seed(2))

    ga, sm = BD.perceive_band_samples(eng, S, True, "bfloat16")
    x_in = MK.project_td(ga, nd, td, include_normal=False)
    want = CS._update_samples(cfg, weights, S, x_in, u, fire_rate, True)

    mom, sm2 = BD.perceive_band_moments(eng, S, True, torch.bfloat16)
    assert mom.dtype == torch.bfloat16 and mom.shape == (
        eng.num_cells, 3 * eng.slots_per_cell, B * F)
    got = MK.fused_update(mom, S, eng.gsum, eng.sig_g, nd, td, weights, u,
                          fire_rate, cfg.fire_rate / fire_rate)
    assert torch.equal(sm2, sm)
    assert got.dtype == torch.float32 and torch.equal(got, want)
    # the rule moved the state where it fired and nowhere else
    fired = u <= fire_rate
    assert not torch.equal(got[fired], S[fired])
    assert torch.equal(got[~fired], S[~fired])


def _counted(fn):
    with P.recording() as rec:
        out = fn()
    return out, rec.counters.get("step.fused_update", 0)


def _surface(eng, nrm, A, t, cfg, params, mlp_dtype="bfloat16", dual=None):
    return SF.rollout_mesh_batched_dual(
        params, cfg, eng, eng if dual is None else dual, A, nrm, t,
        torch.Generator().manual_seed(3), STEPS, H, mlp_dtype=mlp_dtype)


@pytest.mark.parametrize("dual", [False, True])
def test_surface_rollout_takes_the_fused_route(dual):
    """A no-grad bfloat16 surface rollout on a band engine takes the fused
    route once a step, and ends where the composition ends (the same
    rollout with the parameters under grad), bit for bit."""
    x, nrm, eng = _scene()
    eng_d = BD.build_band_engine(x, 0.3, device="cpu") if dual else None
    cfg, params = _model()
    A, t = _inputs(nrm)
    with torch.no_grad():
        fused, n_fused = _counted(
            lambda: _surface(eng, nrm, A, t, cfg, params, dual=eng_d))
    grad_params = MLPParams(*(p.clone().requires_grad_(True)
                              for p in params))
    plain, n_plain = _counted(
        lambda: _surface(eng, nrm, A, t, cfg, grad_params, dual=eng_d))
    assert (n_fused, n_plain) == (STEPS, 0)
    for got, want in zip(fused, plain):
        assert torch.equal(got, want.detach())
    assert not torch.equal(fused[0], A)


@pytest.mark.parametrize("case", [
    "grad", "float32_mlp", "float32_tables", "cell_engine",
    "rollout_cells_batched"])
def test_fused_route_not_taken(case):
    """The route is not taken under grad, with a float32 MLP, with float32
    tables, on a cell engine, or by the plane rollouts."""
    x, nrm, eng = _scene("float32" if case == "float32_tables" else
                         "bfloat16")
    cfg, params = _model()
    A, t = _inputs(nrm)
    grad = case == "grad"
    if grad:
        params = MLPParams(*(p.clone().requires_grad_(True) for p in params))
    if case == "cell_engine":
        eng = build_cell_engine(x, H, pair_tables="bfloat16", device="cpu")

    def run():
        if case == "rollout_cells_batched":
            return CS.rollout_cells_batched(
                params, cfg, eng, BT.batched_scatter(eng, A), B,
                torch.Generator().manual_seed(3), STEPS, H,
                mlp_dtype="bfloat16")
        return _surface(eng, nrm, A, t, cfg, params,
                        None if case == "float32_mlp" else "bfloat16")

    with torch.set_grad_enabled(grad):
        out, n = _counted(run)
    assert n == 0
    assert torch.isfinite(out[0] if isinstance(out, tuple) else out).all()
