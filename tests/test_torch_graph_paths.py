"""Port parity: the paths that run on the fixed-K graph engine — the NCA step
(``models/nca.nca_step``), the rollouts (``models/rollout.py``), the graph
surface rollout (``models/surface.rollout_mesh``) and the trainer — against
the JAX package on the CPU, on the very same neighbour lanes (the JAX graph
carried across by ``io/convert.py``).

Fire masks come from different RNG streams in the two packages, so steps and
rollouts run at fire_rate 1.0. Tolerances: a step 1e-5 of the largest state;
rollouts, the surface rollout and a rollout loss's parameter gradients 1e-4
of the largest value (float32 sums in other orders, compounded over the
steps); trainer losses 1e-4 relative. Inside the port: the remat gradient
equals the gradient without remat at fire_rate 0.5 (one generator seed, the
draws made outside the recomputed step), and the graph step equals the cell
and band engines' steps on one cloud within 1e-5 of max. States keep their
alpha lane 0.005 away from the alive threshold 0.1.
"""

import dataclasses
import functools
import importlib
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from sph_nca_tpu import ops as J
from sph_nca_tpu.io import load_weights_json as jax_load
from sph_nca_tpu.models import SPHNCAConfig as JaxConfig
from sph_nca_tpu.models import init_params as jax_init
from sph_nca_tpu.models import nca as JM
from sph_nca_tpu.models import surface as JSF
from sph_nca_tpu.models.rollout import rollout as jax_rollout
from sph_nca_tpu.models.rollout import rollout_batch as jax_rollout_batch
from sph_nca_tpu.models.rollout import rollout_rebuild as jax_rebuild
from sph_nca_tpu.models.rollout import rollout_states as jax_states
from sph_nca_tpu.training import MSELossConfig as JaxMSECfg
from sph_nca_tpu.training import Pool as JaxPool
from sph_nca_tpu.training import TrainConfig as JaxTrainConfig
from sph_nca_tpu.training import Trainer as JaxTrainer
from sph_nca_tpu.training import make_mse_bundle as jax_bundle
from sph_nca_tpu_torch.io.convert import (
    graph_from_jax_numpy,
    params_from_jax_numpy,
)
from sph_nca_tpu_torch.io.weights_json import load_weights_json
from sph_nca_tpu_torch.models import nca as TM
from sph_nca_tpu_torch.models import surface as TSF
from sph_nca_tpu_torch.models.cell_step import (
    nca_step_cells,
    nca_step_cells_batched,
)
from sph_nca_tpu_torch.models.nca import MLPParams, SPHNCAConfig
from sph_nca_tpu_torch.ops import hashgrid as T
from sph_nca_tpu_torch.ops.bands import build_band_engine
from sph_nca_tpu_torch.ops.batched import batched_gather_back, batched_scatter
from sph_nca_tpu_torch.ops.cells import build_cell_engine
from sph_nca_tpu_torch.training.losses import MSELossConfig
from sph_nca_tpu_torch.training.pool import Pool
from sph_nca_tpu_torch.training.trainer import (
    TrainConfig,
    Trainer,
    make_mse_bundle,
)
from sph_nca_tpu_torch.utils.meshes import fibonacci_sphere, sphere_normals

# the module: the package re-exports the JAX package's public names, so
# ``sph_nca_tpu_torch.models.rollout`` is the function, as
# ``sph_nca_tpu.models.rollout`` is
TR = importlib.import_module("sph_nca_tpu_torch.models.rollout")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GECKO = os.path.join(ROOT, "sph_nca_tpu", "demo", "web", "weights",
                     "gecko.json")
F = 16
STEP_RTOL = 1e-5
ROLL_RTOL = 1e-4


def _rel(got, want, rtol, what=""):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got.astype(np.float64) - want).max())
    scale = max(float(np.abs(want).max()), 1e-30)
    assert err <= rtol * scale, (what, err, scale)


def _states(n, seed, b=None, lo=-0.5, hi=1.0):
    """[b, n, F] (or [n, F]) states whose alpha lane keeps 0.005 away from
    0.1."""
    shape = (n, F) if b is None else (b, n, F)
    A = np.random.default_rng(seed).uniform(lo, hi, shape).astype(np.float32)
    a = A[..., 3]
    near = np.abs(a - 0.1) < 0.005
    A[..., 3] = np.where(near, np.where(a < 0.1, 0.09, 0.11), a)
    return A


def _plane(m=20, h=0.25, d=2, seed=0):
    """An m x m plane over [-1, 1]^2 (jittered; padded to 3D with a small z
    when d = 3) and its JAX graph, carried across: (x, h, jg, tg)."""
    x, jg = _jax_plane(m, h, d, seed)
    return x, h, jg, _carry(jg)


@functools.lru_cache(maxsize=None)
def _jax_plane(m, h, d, seed):
    rng = np.random.default_rng(seed)
    lin = -1.0 + 2.0 * (np.arange(m) + 0.5) / m
    x = np.stack(np.meshgrid(lin, lin, indexing="ij"), -1).reshape(-1, 2)
    x = x + rng.uniform(-0.02, 0.02, x.shape)
    if d == 3:
        x = np.concatenate([x, rng.uniform(-0.05, 0.05, (len(x), 1))], -1)
    x = x.astype(np.float32)
    return x, _jax_graph(x, h)


def _jax_graph(x, h, dims=None, period=None):
    dims = J.default_dims(h) if dims is None else dims
    mpc, k = J.suggest_capacity(x, h, dims, period=period)
    return J.build_graph(jnp.asarray(x), h, dims, max_per_cell=mpc, k=k,
                         period=None if period is None
                         else jnp.asarray(period, jnp.float32))


def _carry(jg):
    return graph_from_jax_numpy(*(np.asarray(a) for a in jg), device="cpu")


def _random_model(h, rule="gated", use_alpha=True, hidden=32, seed=0):
    kw = dict(channels=F, hidden=hidden, fire_rate=1.0, update_rule=rule,
              use_alpha=use_alpha, normalize_perception=1.0 / h)
    jcfg = JaxConfig(**kw)
    jp = jax_init(jax.random.key(seed), jcfg)
    if rule == "orig":  # 'orig' zero-inits the last layer: give it weights
        w2 = np.random.default_rng(seed).uniform(-0.05, 0.05,
                                                 np.shape(jp.w2))
        jp = jp._replace(w2=jnp.asarray(w2, jnp.float32))
    tp = params_from_jax_numpy(*(np.asarray(a) for a in jp), device="cpu")
    return jcfg, jp, SPHNCAConfig(**kw), tp


@functools.lru_cache(maxsize=None)
def _gecko(use_alpha=True):
    jm, tm = jax_load(GECKO), load_weights_json(GECKO, device="cpu")
    kw = dict(fire_rate=1.0, use_alpha=use_alpha)
    return (dataclasses.replace(jm.cfg, **kw), jm.params,
            dataclasses.replace(tm.cfg, **kw), tm.params, jm.h)


def _tangents(nrm, seed, lead=()):
    t = np.random.default_rng(seed).normal(size=lead + nrm.shape)
    t = t - nrm * np.sum(nrm * t, -1, keepdims=True)
    return (t / np.linalg.norm(t, axis=-1, keepdims=True)).astype(np.float32)


STEP_CASES = {
    "2d-gated": dict(d=2),
    "3d-gated": dict(d=3),
    "2d-orig": dict(d=2, rule="orig"),
    "2d-no-alpha": dict(d=2, use_alpha=False),
    "3d-tangent": dict(d=3, tangent=True),
}


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_nca_step_matches_jax(case):
    """One step with the gecko weights (a random orig-rule model for
    'orig'), one cloud and a batch of two against jax.vmap."""
    c = {"rule": "gated", "use_alpha": True, "tangent": False,
         **STEP_CASES[case]}
    if c["rule"] == "orig":
        jcfg, jp, cfg, tp = _random_model(0.1, "orig")
        h = 0.1
    else:
        jcfg, jp, cfg, tp, h = _gecko(c["use_alpha"])
    x, h, jg, tg = _plane(24, h, c["d"])
    A = _states(len(x), 1, b=2)
    jtr = ttr = None
    if c["tangent"]:
        nrm = np.zeros((len(x), 3), np.float32)
        nrm[:, 2] = 1.0
        t = _tangents(nrm, 2)
        jtr = JSF.tangent_perception(jnp.asarray(nrm), jnp.asarray(t))
        ttr = TSF.tangent_perception(torch.from_numpy(nrm),
                                     torch.from_numpy(t))

    def jstep(a):
        return JM.nca_step(jp, jcfg, jg, a, jax.random.key(0), h,
                           perception_transform=jtr)

    want = jax.jit(lambda A: (jstep(A[0]), jax.vmap(jstep)(A)))(
        jnp.asarray(A))
    gen = torch.Generator().manual_seed(0)
    tA = torch.from_numpy(A)
    _rel(TM.nca_step(tp, cfg, tg, tA[0], gen, h, perception_transform=ttr),
         want[0], STEP_RTOL, "one")
    _rel(TM.nca_step(tp, cfg, tg, tA, gen, h, perception_transform=ttr),
         want[1], STEP_RTOL, "batch")
    # the step from the port's own build equals the step on JAX's lanes
    own = T.build_graph(torch.from_numpy(x), h, T.default_dims(h),
                        max_per_cell=tg.k, k=tg.k)
    _rel(TM.nca_step(tp, cfg, own, tA[0], gen, h, perception_transform=ttr),
         want[0], STEP_RTOL, "own build")


def test_life_mask_and_perceive_match_jax():
    jcfg, jp, cfg, tp, h = _gecko()
    x, h, jg, tg = _plane(20, h)
    A = _states(len(x), 3)
    y, mask = jax.jit(lambda A: (JM.perceive(jcfg, jg, A, h),
                                 JM.life_mask(jg, A[:, 3])))(jnp.asarray(A))
    _rel(TM.perceive(cfg, tg, torch.from_numpy(A), h), y, STEP_RTOL)
    np.testing.assert_array_equal(
        TM.life_mask(tg, torch.from_numpy(A[:, 3])).numpy(), np.asarray(mask))


def test_rollouts_match_jax():
    """rollout (n_steps < max_steps, collected states), rollout_states and
    rollout_batch against JAX's, 5 steps of the gecko at fire_rate 1."""
    jcfg, jp, cfg, tp, h = _gecko()
    x, h, jg, tg = _plane(20, 0.2)
    A = _states(len(x), 4, b=2)
    key, gen = jax.random.key(1), torch.Generator().manual_seed(1)
    collect = [0, 2, 3, 5]

    @jax.jit
    def jax_side(A):
        return (jax_rollout(jp, jcfg, jg, A[0], key, 5, h, n_steps=3,
                            collect_steps=jnp.asarray(collect)),
                jax_states(jp, jcfg, jg, A[0], key, 4, h),
                jax_rollout_batch(jp, jcfg, jg, A, key, 5, h,
                                  collect_steps=jnp.asarray(collect)))

    want_one, want_states, want_batch = jax_side(jnp.asarray(A))
    tA = torch.from_numpy(A)
    with torch.no_grad():
        one = TR.rollout(tp, cfg, tg, tA[0], gen, 5, h, n_steps=3,
                         collect_steps=collect)
        states = TR.rollout_states(tp, cfg, tg, tA[0], gen, 4, h)
        batch = TR.rollout_batch(tp, cfg, tg, tA, gen, 5, h,
                                 collect_steps=collect)
    _rel(one.final, want_one.final, ROLL_RTOL, "final")
    _rel(one.collected, want_one.collected, ROLL_RTOL, "collected")
    _rel(one.collected[2], one.final, 0.0, "held after n_steps")
    _rel(states, want_states, ROLL_RTOL, "states")
    _rel(batch.final, want_batch.final, ROLL_RTOL, "batch final")
    _rel(batch.collected, want_batch.collected, ROLL_RTOL, "batch collected")


@pytest.mark.parametrize("advect", [False, True], ids=["static", "drift"])
def test_rollout_rebuild_matches_jax(advect):
    """The per-step rebuild against JAX's; without advection it equals the
    static rollout, with the drift of tests/test_rollout.py every list stays
    exact."""
    jcfg, jp, cfg, tp = _random_model(0.25, hidden=16)
    x, h, jg, tg = _plane(12, 0.25)
    A = _states(len(x), 5)
    dims = J.default_dims(h)
    mpc, k = J.suggest_capacity(x, h, dims)
    mpc, k = (mpc + 8, k + 8) if advect else (mpc, k)

    def jdrift(x, A, t):
        return x + 0.01 * jnp.sin(3.0 * x[..., ::-1])

    def tdrift(x, A, t):
        return x + 0.01 * torch.sin(3.0 * x.flip(-1))

    xf, Af, want = jax_rebuild(jp, jcfg, jnp.asarray(x), jnp.asarray(A),
                               jax.random.key(2), 3, h, dims,
                               max_per_cell=mpc, k=k,
                               advect=jdrift if advect else None)
    gen = torch.Generator().manual_seed(2)
    with torch.no_grad():
        txf, tAf, states, dropped = TR.rollout_rebuild(
            tp, cfg, torch.from_numpy(x), torch.from_numpy(A), gen, 3, h,
            dims, max_per_cell=mpc, k=k, advect=tdrift if advect else None)
        static = TR.rollout_states(tp, cfg, tg, torch.from_numpy(A), gen, 3,
                                   h)
    _rel(states, want, ROLL_RTOL, "states")
    _rel(tAf, Af, ROLL_RTOL, "final")
    _rel(txf, xf, STEP_RTOL, "positions")
    assert dropped.tolist() == [0, 0, 0]
    if not advect:
        _rel(states, static, STEP_RTOL, "static")
        np.testing.assert_array_equal(txf.numpy(), x)


def test_rollout_mesh_matches_jax():
    """The graph surface rollout on a ~600-point sphere (the model graph
    at h and a diffusion graph at another radius), tangent perception and
    the detached diffusion, 3 steps."""
    h, hd = 0.3, 0.25
    x = fibonacci_sphere(600, 1.0)
    nrm = sphere_normals(x)
    jg, jgd = _jax_graph(x, h), _jax_graph(x, hd)
    jcfg, jp, cfg, tp = _random_model(h)
    A = _states(len(x), 6)
    t0 = _tangents(nrm, 7)
    fa, ft, fs = jax.jit(lambda A, t: JSF.rollout_mesh(
        jp, jcfg, jg, jgd, A, jnp.asarray(nrm), t, jax.random.key(3), 3, h,
        collect_all=True))(jnp.asarray(A), jnp.asarray(t0))
    ga, gt, gs = TSF.rollout_mesh(
        tp, cfg, _carry(jg), _carry(jgd), torch.from_numpy(A),
        torch.from_numpy(nrm), torch.from_numpy(t0),
        torch.Generator().manual_seed(3), 3, h, collect_all=True)
    _rel(ga, fa, ROLL_RTOL, "A")
    _rel(gt, ft, ROLL_RTOL, "t")
    _rel(gs, fs, ROLL_RTOL, "states")
    _rel(TSF.diffuse(torch.from_numpy(nrm), torch.from_numpy(t0),
                     torch.from_numpy(A), _carry(jgd), lerp_multiplier=0.5),
         JSF.diffuse(jnp.asarray(nrm), jnp.asarray(t0), jnp.asarray(A), jgd,
                     lerp_multiplier=0.5), STEP_RTOL, "diffuse")


def test_rollout_loss_grad_matches_jax():
    """d/d(params) of a loss on the final and a collected state of a
    4-step batched rollout (remat on both sides) against jax.grad."""
    jcfg, jp, cfg, tp0 = _random_model(0.25, seed=3)
    x, h, jg, tg = _plane(14, 0.25)
    A = _states(len(x), 8, b=2)
    W = np.random.default_rng(9).normal(size=A.shape).astype(np.float32)

    def jloss(p):
        out = jax_rollout_batch(p, jcfg, jg, jnp.asarray(A),
                                jax.random.key(4), 4, h,
                                collect_steps=jnp.asarray([2]))
        return jnp.sum(out.final * W) + jnp.sum(out.collected[:, 0] ** 2)

    want = jax.jit(jax.grad(jloss))(jp)
    tp = MLPParams(*(p.clone().requires_grad_(True) for p in tp0))
    out = TR.rollout_batch(tp, cfg, tg, torch.from_numpy(A),
                           torch.Generator().manual_seed(4), 4, h,
                           collect_steps=[2])
    (torch.sum(out.final * torch.from_numpy(W))
     + torch.sum(out.collected[:, 0] ** 2)).backward()
    for got, w, name in zip(tp, want, MLPParams._fields):
        _rel(got.grad, w, ROLL_RTOL, name)


def test_remat_gradient_equals_plain_at_half_fire_rate():
    """At fire_rate 0.5 and one generator seed, the rollout recomputed in
    the backward gives the gradient of the rollout that keeps its
    activations: the recompute sees the same fire mask."""
    _, _, cfg, tp0 = _random_model(0.25, seed=5)
    cfg = dataclasses.replace(cfg, fire_rate=0.5)
    x, h, _, tg = _plane(12, 0.25)
    A = torch.from_numpy(_states(len(x), 10, b=2))
    grads = []
    for remat in (True, False):
        tp = MLPParams(*(p.clone().requires_grad_(True) for p in tp0))
        out = TR.rollout(tp, cfg, tg, A, torch.Generator().manual_seed(6),
                         4, h, remat=remat)
        out.final.square().sum().backward()
        grads.append([p.grad for p in tp])
    for g, w in zip(*grads):
        assert torch.allclose(g, w, rtol=0, atol=1e-6 * float(w.abs().max()))
    assert any(float(g.abs().max()) > 0 for g in grads[0])


def test_graph_step_equals_cell_and_band_steps():
    """One cloud, three engines: the graph step equals the cell engine's
    (the recompute kernels' plain versions) and the band engine's (float32
    tables), one cloud and a batch of two."""
    jcfg, jp, cfg, tp, h = _gecko()
    x, h, _, _ = _plane(24, h, d=3)
    dims = T.default_dims(h)
    mpc, k = T.suggest_capacity(x, h, dims)
    g = T.build_graph(torch.from_numpy(x), h, dims, max_per_cell=mpc, k=k)
    A = torch.from_numpy(_states(len(x), 11, b=2))
    gen = torch.Generator().manual_seed(0)
    want = TM.nca_step(tp, cfg, g, A, gen, h)
    ce = build_cell_engine(x, h, device="cpu")
    cells = ce.gather_back(nca_step_cells(tp, cfg, ce, ce.scatter(A), gen,
                                          h, use_kernels=False))
    _rel(cells, want, STEP_RTOL, "cells")
    be = build_band_engine(x, h, table_dtype="float32", device="cpu")
    band = batched_gather_back(be, nca_step_cells_batched(
        tp, cfg, be, batched_scatter(be, A), 2, gen, h), 2)
    _rel(band, want, STEP_RTOL, "band")


def test_trainer_on_graph_matches_jax():
    """Three iterations of the port's Trainer and of the JAX Trainer on one
    graph from the same params and pool draws (fire_rate 1): the same
    losses."""
    m, h = 12, 0.3
    lin = np.linspace(-0.9, 0.9, m, dtype=np.float32)
    x2 = np.stack(np.meshgrid(lin, lin, indexing="ij"), -1).reshape(-1, 2)
    x = np.pad(x2, ((0, 0), (0, 1)))
    jg = _jax_graph(x, h)
    jcfg, jp, cfg, tp = _random_model(h, hidden=16, seed=7)
    img = np.random.default_rng(4).uniform(0, 1, (8, 8, 4)).astype(
        np.float32)
    kw = dict(gmin=(-1, -1), gsize=(2, 2), image_scale=8 / m)
    tc = dict(batch_size=2, pool_size=4, steps_range=(2, 3),
              steps_increment=1, aux_states=2, lr_decay_steps=10)
    seed_A = np.zeros((m * m, F), np.float32)
    seed_A[m * m // 2 + m // 2, 3:] = 1.0
    jt = JaxTrainer(jcfg, JaxTrainConfig(**tc), jg, jnp.asarray(x2),
                    jax_bundle(jnp.asarray(img), JaxMSECfg(**kw)), h,
                    params=jp)
    tt = Trainer(cfg, TrainConfig(**tc), _carry(jg), torch.from_numpy(x2),
                 make_mse_bundle(torch.from_numpy(img), MSELossConfig(**kw)),
                 h, params=tp)
    jpool = JaxPool(x2, seed_A, 4, rng=np.random.default_rng(0))
    tpool = Pool(x2, seed_A, 4, rng=np.random.default_rng(0))
    want = [jt.run_iteration(i, jpool) for i in range(3)]
    got = [tt.run_iteration(i, tpool) for i in range(3)]
    assert tt.last_steps == 2
    np.testing.assert_allclose(got, want, rtol=ROLL_RTOL)
