"""Port parity: the batched-lane cell path (``ops/batched.py``, the update
MLP of ``ops/mlp_kernel.py``, the batched step and rollout of
``models/cell_step.py``) against the JAX package, whose Pallas MLP kernel runs
in interpret mode on the CPU.

On the CPU the port's wrappers run their plain PyTorch versions; the CUDA
kernels are held against those on the card by tests/test_torch_cuda.py and
chip_smoke.py. Fire masks come from different RNG streams in the two
packages, so steps and rollouts run at fire_rate 1.0.

The JAX step's update MLP is chosen by ``SPH_NCA_MLP_IMPL`` at import time;
the tests that step the JAX package set its module default to ``"pallas"``
(the implementation the port carries) for their own duration.

Tolerances.
- Scatter / gather: exact (the same slots).
- The MLP: float32 sums in another order; with bfloat16 inputs the products
  are exact in float32 in both and H rounds to bfloat16 the same way unless a
  sum lies at a rounding midpoint: 1e-6 of the largest output (measured
  ~3e-7). Its gradients against ``jax.vjp`` of ``_mlp_ref``: 1e-5 of the
  largest entry of each.
- The batched passes with float32 tables: the same products summed in
  another order, 1e-5 of the largest output on real slots. With bfloat16
  tables the JAX package rounds the volume-weighted state (and the blur's
  values and the mask's volumes) to bfloat16 before its products while the
  port keeps them float32 (a documented deviation), so the two differ by the
  JAX side's rounding: 1e-2 of the largest output (measured up to ~3e-3).
  The states' alpha lane is kept 0.005 away from the alive threshold 0.1, so
  that JAX's bfloat16 alive test and the port's float32 one pick the same
  slots (a slot at the threshold is alive in one and not the other).
- One update: 1e-5 of the largest state. Steps and rollouts: 1e-4 of the
  largest state (the rounding compounds over the steps), a bfloat16-table
  step 1e-2 as the passes. BPTT parameter gradients of a
  3-step rollout: 1e-4 of the largest |g| per parameter.
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import sph_nca_tpu.models.cell_step as JS
from sph_nca_tpu.models import SPHNCAConfig as JaxConfig
from sph_nca_tpu.models import init_params as jax_init_params
from sph_nca_tpu.ops import batched as JB
from sph_nca_tpu.ops.cells import build_cell_engine as jax_build
from sph_nca_tpu.ops.pallas import mlp_kernel as JM
from sph_nca_tpu_torch.io.convert import params_from_jax_numpy
from sph_nca_tpu_torch.models import cell_step as TS
from sph_nca_tpu_torch.models.nca import MLPParams, SPHNCAConfig
from sph_nca_tpu_torch.ops import batched as TB
from sph_nca_tpu_torch.ops import mlp_kernel as TM
from sph_nca_tpu_torch.ops.cells import build_cell_engine

F, B, H = 16, 3, 0.3
MLP_RTOL = 1e-6
MLP_GRAD_RTOL = 1e-5
PASS_RTOL = {"float32": 1e-5, "bfloat16": 1e-2}
STEP_RTOL = 1e-4
GRAD_RTOL = 1e-4


@functools.cache
def _engines(dtype):
    x = np.random.default_rng(0).uniform(-1, 1, (250, 3)).astype(np.float32)
    je = jax_build(jnp.asarray(x), H, xla_tables=False, pair_tables=dtype)
    te = build_cell_engine(x, H, pair_tables=dtype, device="cpu")
    assert te.blk_xs.shape[0] > 0 and te.blk2_xs.shape[0] > 0
    return je, te


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def engines(request):
    return request.param, _engines(request.param)


@pytest.fixture
def pallas_mlp(monkeypatch):
    monkeypatch.setattr(JS, "_MLP_IMPL_DEFAULT", "pallas")


def _states(n, seed, b=B, lo=-0.5, hi=1.0):
    """[b, n, F] states whose alpha lane keeps 0.005 away from 0.1."""
    A = np.random.default_rng(seed).uniform(lo, hi, (b, n, F)).astype(
        np.float32)
    a = A[..., 3]
    near = np.abs(a - 0.1) < 0.005
    A[..., 3] = np.where(near, np.where(a < 0.1, 0.09, 0.11), a)
    return A


def _close(got, want, rtol, mask=None):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    if mask is not None:
        got, want = got[mask], want[mask]
    scale = max(float(np.max(np.abs(want))), 1e-30)
    err = float(np.max(np.abs(got - want)))
    assert err <= rtol * scale, (err, scale)


def _configs(rule="gated", hidden=32):
    kw = dict(channels=F, hidden=hidden, fire_rate=1.0, update_rule=rule,
              normalize_perception=1.0 / H)
    return JaxConfig(**kw), SPHNCAConfig(**kw)


def _params(jcfg, seed=0):
    jp = jax_init_params(jax.random.key(seed), jcfg)
    if jcfg.update_rule == "orig":  # zero-initialized: give it weights
        rng = np.random.default_rng(seed)
        jp = jp._replace(
            w2=jnp.asarray(rng.normal(size=jp.w2.shape) * 0.1, jnp.float32),
            b2=jnp.asarray(rng.normal(size=jp.b2.shape) * 0.1, jnp.float32))
    return jp, params_from_jax_numpy(*(np.asarray(a) for a in jp),
                                     device="cpu")


# ---- layout ---------------------------------------------------------------


def test_scatter_gather_match_jax():
    je, te = _engines("float32")
    A = _states(te.num_particles, 1)
    SB = TB.batched_scatter(te, torch.from_numpy(A))
    np.testing.assert_array_equal(SB.numpy(),
                                  JB.batched_scatter(je, jnp.asarray(A)))
    np.testing.assert_array_equal(TB.batched_gather_back(te, SB, B).numpy(), A)
    S = TB.to_samples(SB, B)
    assert S.shape == (B,) + tuple(te.xs.shape[:2]) + (F,)
    for b in range(B):
        assert torch.equal(S[b], te.scatter(torch.from_numpy(A[b])))
    assert torch.equal(TB.to_lanes(S), SB)
    ga = torch.randn(B, 4, 8, 3 * F)
    assert torch.equal(TB.lanes_to_dmajor(TB.dmajor_to_lanes(ga, 3), B, 3),
                       ga)


# ---- the batched passes ----------------------------------------------------


@pytest.mark.parametrize("use_alpha", [True, False])
def test_perceive_batched_matches_jax(engines, use_alpha):
    dtype, (je, te) = engines
    A = _states(te.num_particles, 2)
    SB = TB.batched_scatter(te, torch.from_numpy(A))
    ga_j, sm_j = JB.perceive_cells_batched(je, jnp.asarray(SB.numpy()), B,
                                           use_alpha)
    ga_t, sm_t = TB.perceive_cells_batched(te, SB, B, use_alpha)
    assert ga_t.shape == ga_j.shape and sm_t.shape == sm_j.shape
    real = te.vs.numpy() > 0
    _close(ga_t.numpy(), ga_j, PASS_RTOL[dtype], real)
    _close(sm_t.numpy(), sm_j, PASS_RTOL[dtype], real)


def test_mask_and_blur_batched_match_jax(engines):
    dtype, (je, te) = engines
    A = _states(te.num_particles, 3)
    SB = TB.batched_scatter(te, torch.from_numpy(A))
    real = te.vs.numpy() > 0
    for use_alpha in (True, False):
        _close(TB.mask_blur_batched(te, SB, B, use_alpha).numpy(),
               JB.mask_blur_batched(je, jnp.asarray(SB.numpy()), B,
                                    use_alpha),
               PASS_RTOL[dtype], real)
    X = np.random.default_rng(4).normal(
        size=tuple(te.xs.shape[:2]) + (B * 4,)).astype(np.float32)
    _close(TB.blur_batched(te, torch.from_numpy(X), B).numpy(),
           JB.blur_batched(je, jnp.asarray(X), B), PASS_RTOL[dtype], real)


def test_batched_ops_need_tables():
    x = np.random.default_rng(0).uniform(-1, 1, (100, 3)).astype(np.float32)
    eng = build_cell_engine(x, 0.3, device="cpu")
    SB = torch.zeros(tuple(eng.xs.shape[:2]) + (2 * F,))
    _, tcfg = _configs()
    with pytest.raises(ValueError, match="pair_tables"):
        TB.perceive_cells_batched(eng, SB, 2)
    with pytest.raises(ValueError, match="pair_tables"):
        TB.mask_blur_batched(eng, SB, 2)
    with pytest.raises(ValueError, match="pair_tables"):
        TS.rollout_cells_batched(None, tcfg, eng, SB, 2,
                                 torch.Generator(), 1, 0.3)
    teng = _engines("float32")[1]
    SBt = torch.zeros(tuple(teng.xs.shape[:2]) + (2 * F,))
    with pytest.raises(ValueError, match="out_dtype"):
        TB.perceive_cells_batched(teng, SBt, 2, out_dtype="bfloat16")


# ---- the update MLP --------------------------------------------------------


def _mlp_inputs(rows, b, k, hid, dtype, seed=0):
    rng = np.random.default_rng(seed)
    arrs = [rng.normal(size=(rows, b * F)), rng.normal(size=(rows, 2 * b * F)),
            rng.normal(size=(3 * F, hid)) * 0.2, rng.normal(size=(1, hid)) * 0.1,
            rng.normal(size=(hid, k)) * 0.2, rng.normal(size=(1, k)) * 0.1]
    arrs = [a.astype(np.float32) for a in arrs]
    jx = [jnp.asarray(a) for a in arrs]
    jx = [a.astype(dtype) if i in (0, 1, 2, 4) else a
          for i, a in enumerate(jx)]
    tdt = getattr(torch, dtype)
    S2, ga2, w1k, b1, w2, b2 = (torch.from_numpy(a) for a in arrs)
    tx = [S2.to(tdt).reshape(rows, b, F),
          ga2.to(tdt).reshape(rows, 2, b, F).transpose(1, 2).reshape(
              rows, b, 2 * F),
          w1k.to(tdt), b1[0], w2.to(tdt), b2[0]]
    return jx, tx


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rule", ["gated", "orig"])
def test_mlp_matches_jax(dtype, rule):
    """mlp_ref and mlp_fused against JAX's mlp_fused (Pallas, interpret
    mode) and _mlp_ref; the port's outputs [rows, B, F] are the JAX lanes
    [rows, B*F]."""
    rows, b, hid = 64, 3, 32
    k = 2 * F + 1 if rule == "gated" else F
    jx, tx = _mlp_inputs(rows, b, k, hid, dtype)
    want_k = JM.mlp_fused(*jx, b, F, 32)
    want_r = JM._mlp_ref(*jx, b=b, f=F)
    n_out = 3 if rule == "gated" else 1
    for got in (TM.mlp_ref(*tx), TM.mlp_fused(*tx),
                TM.mlp_fused(*tx, use_kernel=False)):
        assert len(got) == 3 and all(g is None for g in got[n_out:])
        for g, wk, wr in zip(got[:n_out], want_k, want_r):
            assert g.dtype == torch.float32
            g = g.reshape(rows, -1).numpy()
            _close(g, wk, MLP_RTOL)
            _close(g, wr, MLP_RTOL)


@pytest.mark.parametrize("rule", ["gated", "orig"])
def test_mlp_grads_match_jax_vjp(rule):
    """The Function's backward (autograd through mlp_ref) against jax.vjp of
    _mlp_ref, for every input."""
    rows, b, hid = 64, 3, 32
    k = 2 * F + 1 if rule == "gated" else F
    jx, tx = _mlp_inputs(rows, b, k, hid, "float32", seed=1)
    n_out = 3 if rule == "gated" else 1
    rng = np.random.default_rng(2)
    cot = [rng.normal(size=s).astype(np.float32)
           for s in ((rows, b * F), (rows, b * F), (rows, b))[:n_out]]

    def jref(*a):
        return JM._mlp_ref(*a, b=b, f=F)[:n_out]

    _, vjp = jax.vjp(jref, *jx)
    want = vjp(tuple(jnp.asarray(c) for c in cot))
    tx = [t.clone().requires_grad_(True) for t in tx]
    outs = TM.mlp_fused(*tx)[:n_out]
    loss = sum((o.reshape(rows, -1) * torch.from_numpy(c)).sum()
               for o, c in zip(outs, cot))
    loss.backward()
    S_g = tx[0].grad.reshape(rows, b * F)
    ga_g = tx[1].grad.reshape(rows, b, 2, F).transpose(1, 2).reshape(
        rows, 2 * b * F)
    for got, w in zip([S_g, ga_g, tx[2].grad, tx[3].grad[None], tx[4].grad,
                       tx[5].grad[None]], want):
        _close(got.numpy(), w, MLP_GRAD_RTOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mlp_backward_equals_autograd_through_ref(dtype):
    """The Function's written-out backward against autograd through
    mlp_ref, with a perception wider than the 2F features the MLP reads (a
    z block gets a zero cotangent) and with only the weights needing
    gradients (the rollout's first step): bfloat16 rounds the cotangents as
    autograd does, so the two agree to float32 summation order."""
    rows, b, hid = 32, 2, 16
    tdt = getattr(torch, dtype)
    _, tx = _mlp_inputs(rows, b, 2 * F + 1, hid, dtype, seed=3)
    ga3 = torch.cat([tx[1], torch.randn(rows, b, F).to(tdt)], -1)
    rng = np.random.default_rng(4)
    cot = [torch.from_numpy(rng.normal(size=s).astype(np.float32))
           for s in ((rows, b, F), (rows, b, F), (rows, b))]
    grads = []
    for fn in (TM.mlp_fused, TM.mlp_ref):
        for inputs_need_grad in (True, False):
            args = [t.clone().requires_grad_(inputs_need_grad or i >= 2)
                    for i, t in enumerate([tx[0], ga3] + tx[2:])]
            sum((o * c).sum() for o, c in zip(fn(*args), cot)).backward()
            grads.append([a.grad for a in args])
    for got, want in zip(grads[:2], grads[2:]):
        for g, w in zip(got, want):
            if w is None:
                assert g is None
                continue
            assert g.dtype == w.dtype and g.shape == w.shape
            _close(g.float().numpy(), w.float().numpy(), MLP_GRAD_RTOL)
    assert not grads[0][1][..., 2 * F:].any()


@pytest.mark.parametrize("impl,mlp_dtype", [("pallas", None),
                                             ("blockdiag", None),
                                             ("pallas", "bfloat16")])
@pytest.mark.parametrize("rule", ["gated", "orig"])
def test_update_core_matches_jax(impl, mlp_dtype, rule):
    """The lane-layout update against JAX's _update_core on its Pallas MLP
    (float32 and bfloat16) and on its block-diagonal MLP (float32; in
    bfloat16 that variant rounds its pre-activations to bfloat16, another
    function)."""
    rows, b, d = 64, 3, 3
    jcfg, tcfg = _configs(rule)
    jp, tp = _params(jcfg)
    rng = np.random.default_rng(5)
    SB2 = rng.uniform(-0.5, 1.0, (rows, b * F)).astype(np.float32)
    gaB = rng.normal(size=(rows, d * b * F)).astype(np.float32)
    want = JS._update_core(jp, jcfg, jnp.asarray(SB2), jnp.asarray(gaB), b, F,
                           jax.random.key(0), H, 1.0, mlp_dtype,
                           mlp_impl=impl)
    got = TS._update_core(tp, tcfg, torch.from_numpy(SB2),
                          torch.from_numpy(gaB), b, F, torch.Generator(), H,
                          1.0, mlp_dtype)
    _close(got.numpy(), want, 1e-5)


# ---- the batched step and rollout ------------------------------------------


def test_batched_step_matches_jax(engines, pallas_mlp):
    dtype, (je, te) = engines
    jcfg, tcfg = _configs()
    jp, tp = _params(jcfg)
    A = _states(te.num_particles, 7)
    SB = TB.batched_scatter(te, torch.from_numpy(A))
    want = JB.batched_gather_back(je, JS.nca_step_cells_batched(
        jp, jcfg, je, jnp.asarray(SB.numpy()), B, jax.random.key(0), H,
        fire_rate=1.0), B)
    got = TB.batched_gather_back(te, TS.nca_step_cells_batched(
        tp, tcfg, te, SB, B, torch.Generator(), H, fire_rate=1.0), B)
    _close(got.numpy(), want, STEP_RTOL if dtype == "float32"
           else PASS_RTOL[dtype])


def test_batched_step_perception_transform_matches_jax(pallas_mlp):
    """The step hands the transform the unscaled gradient in JAX's d-major
    lane blocks [C, M, D*B*F] and takes the same layout back."""
    je, te = _engines("float32")
    jcfg, tcfg = _configs()
    jp, tp = _params(jcfg)
    A = _states(te.num_particles, 12)
    SB = TB.batched_scatter(te, torch.from_numpy(A))
    bf = B * F
    seen = []

    def jtransform(gaB):
        return jnp.concatenate([gaB[..., bf:2 * bf], -gaB[..., :bf],
                                gaB[..., 2 * bf:]], axis=-1)

    def ttransform(gaB):
        seen.append(tuple(gaB.shape))
        return torch.cat([gaB[..., bf:2 * bf], -gaB[..., :bf],
                          gaB[..., 2 * bf:]], dim=-1)

    want = JB.batched_gather_back(je, JS.nca_step_cells_batched(
        jp, jcfg, je, jnp.asarray(SB.numpy()), B, jax.random.key(0), H,
        fire_rate=1.0, perception_transform=jtransform), B)
    got = TB.batched_gather_back(te, TS.nca_step_cells_batched(
        tp, tcfg, te, SB, B, torch.Generator(), H, fire_rate=1.0,
        perception_transform=ttransform), B)
    assert seen == [tuple(te.xs.shape[:2]) + (3 * bf,)]
    _close(got.numpy(), want, STEP_RTOL)
    plain = TS.nca_step_cells_batched(tp, tcfg, te, SB, B, torch.Generator(),
                                      H, fire_rate=1.0)
    assert not torch.equal(TB.batched_gather_back(te, plain, B), got)


def test_batched_rollout_freeze_and_collect_match_jax(pallas_mlp):
    """Per-sample n_steps freezes finished samples; the collect buffer holds
    the state after each collect step (0 is SB0, steps past a sample's end
    hold its frozen state)."""
    je, te = _engines("float32")
    jcfg, tcfg = _configs()
    jp, tp = _params(jcfg)
    A = _states(te.num_particles, 8)
    SB = TB.batched_scatter(te, torch.from_numpy(A))
    n_steps, collect = [1, 3, 2], [0, 2, 3]
    out = JS.rollout_cells_batched(
        jp, jcfg, je, jnp.asarray(SB.numpy()), B, jax.random.key(0), 3, H,
        n_steps=jnp.asarray(n_steps), fire_rate=1.0,
        collect_steps=jnp.asarray(collect))
    final, coll = TS.rollout_cells_batched(
        tp, tcfg, te, SB, B, torch.Generator(), 3, H, n_steps=n_steps,
        fire_rate=1.0, collect_steps=collect)
    assert coll.shape == (3,) + tuple(SB.shape)
    _close(TB.batched_gather_back(te, final, B).numpy(),
           JB.batched_gather_back(je, out.final, B), STEP_RTOL)
    for s in range(3):
        _close(TB.batched_gather_back(te, coll[s], B).numpy(),
               JB.batched_gather_back(je, out.collected[s], B), STEP_RTOL)
    assert torch.equal(coll[0], SB)
    one = TS.rollout_cells_batched(tp, tcfg, te, SB, B, torch.Generator(), 1,
                                   H, fire_rate=1.0)
    S_fin, S_one = TB.to_samples(final, B), TB.to_samples(one, B)
    assert torch.equal(S_fin[0], S_one[0])  # stopped after its one step
    assert torch.equal(TB.to_samples(coll[2], B)[2], S_fin[2])
    with pytest.raises(ValueError, match="outside"):
        TS.rollout_cells_batched(tp, tcfg, te, SB, B, torch.Generator(), 2,
                                 H, collect_steps=[3])


@pytest.mark.parametrize("remat", [True, False])
def test_batched_bptt_grads_match_jax(pallas_mlp, monkeypatch, remat):
    """Loss and parameter gradients of a 3-step batched rollout with a
    collected state against jax.value_and_grad of JAX's batched rollout."""
    monkeypatch.setattr(TS, "REMAT", remat)
    je, te = _engines("float32")
    jcfg, tcfg = _configs()
    jp, tp = _params(jcfg, seed=3)
    A = _states(te.num_particles, 9)
    SB = TB.batched_scatter(te, torch.from_numpy(A))
    rng = np.random.default_rng(10)
    R1 = rng.normal(size=A.shape).astype(np.float32)
    R2 = rng.normal(size=A.shape).astype(np.float32)
    SBj = jnp.asarray(SB.numpy())

    def jloss(p):
        out = JS.rollout_cells_batched(
            p, jcfg, je, SBj, B, jax.random.key(0), 3, H, fire_rate=1.0,
            collect_steps=jnp.asarray([2]))
        return (jnp.sum(JB.batched_gather_back(je, out.final, B) * R1)
                + jnp.sum(JB.batched_gather_back(je, out.collected[0], B)
                          * R2))

    want_loss, want_g = jax.value_and_grad(jloss)(jp)
    tp = MLPParams(*(t.clone().requires_grad_(True) for t in tp))
    final, coll = TS.rollout_cells_batched(
        tp, tcfg, te, SB, B, torch.Generator(), 3, H, fire_rate=1.0,
        collect_steps=[2])
    loss = ((TB.batched_gather_back(te, final, B) * torch.from_numpy(R1)).sum()
            + (TB.batched_gather_back(te, coll[0], B)
               * torch.from_numpy(R2)).sum())
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    for got, want in zip(tp, want_g):
        _close(got.grad.numpy(), want, GRAD_RTOL)


def test_batched_rollout_equals_per_sample():
    """A batched rollout against rollout_cells run on each sample alone:
    the same function up to summation order and where the perception scale
    is applied."""
    _, te = _engines("bfloat16")
    _, tcfg = _configs()
    _, tp = _params(_configs()[0], seed=4)
    A = _states(te.num_particles, 11)
    SB = TB.batched_scatter(te, torch.from_numpy(A))
    got = TB.batched_gather_back(te, TS.rollout_cells_batched(
        tp, tcfg, te, SB, B, torch.Generator(), 3, H, fire_rate=1.0), B)
    for b in range(B):
        want = te.gather_back(TS.rollout_cells(
            tp, tcfg, te, te.scatter(torch.from_numpy(A[b])),
            torch.Generator(), 3, H, fire_rate=1.0))
        _close(got[b].numpy(), want.numpy(), STEP_RTOL)
