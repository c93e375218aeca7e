"""Port parity: the differentiable rollout and the plane-mode MSE trainer
against the JAX package (Pallas in interpret mode on the CPU).

The two packages draw fire masks from different RNG streams, so rollouts and
training run at fire_rate 1.0, where the mask is all ones. Host draws (pool
slots, rollout lengths, aux states) come from numpy in both, so they agree.

Tolerances. Parameter gradients of a short BPTT rollout: float32 pair sums
and matmuls in other orders, compounded over 3 steps: 1e-4 of the largest
|g| per parameter. Trainer losses over 3 iterations: 1e-3 relative; Adam's
first steps are ~lr * sign(g), so an element whose gradient sits at the
rounding level can move by 2 lr in one package and not the other (compare
losses, not parameters). Losses and image sampling: 1e-6.
"""

import dataclasses
import functools
import glob
import json
import os

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from sph_nca_tpu.models import SPHNCAConfig as JaxConfig
from sph_nca_tpu.models.cell_step import rollout_cells as jax_rollout
from sph_nca_tpu.models.nca import init_params as jax_init
from sph_nca_tpu.ops.cells import build_cell_engine as jax_build
from sph_nca_tpu.training import MSELossConfig as JaxMSECfg
from sph_nca_tpu.training import Pool as JaxPool
from sph_nca_tpu.training import TrainConfig as JaxTrainConfig
from sph_nca_tpu.training import Trainer as JaxTrainer
from sph_nca_tpu.training import make_mse_bundle as jax_bundle
from sph_nca_tpu.training import mse_loss as jax_mse
from sph_nca_tpu.training import progressive_steps as jax_progressive
from sph_nca_tpu.training.pool import DevicePool as JaxDevicePool
from sph_nca_tpu.utils.geometry import bilinear_sample as jax_bilinear
from sph_nca_tpu.utils.image import flat_color_target as jax_flat
from sph_nca_tpu.utils.seeds import plane_seed as jax_plane_seed
from sph_nca_tpu_torch.cli import test as cli_test
from sph_nca_tpu_torch.cli import train as cli_train
from sph_nca_tpu_torch.io.convert import params_from_jax_numpy
from sph_nca_tpu_torch.io.weights_json import load_weights_json
from sph_nca_tpu_torch.models import cell_step
from sph_nca_tpu_torch.models.cell_step import rollout_cells
from sph_nca_tpu_torch.models.nca import (
    MLPParams,
    SPHNCAConfig,
    init_params,
    num_params,
)
from sph_nca_tpu_torch.ops.cells import build_cell_engine
from sph_nca_tpu_torch.training.losses import MSELossConfig, mse_loss
from sph_nca_tpu_torch.training.pool import DevicePool, Pool
from sph_nca_tpu_torch.training.trainer import (
    TrainConfig,
    Trainer,
    make_mse_bundle,
    make_optimizer,
    progressive_steps,
)
from sph_nca_tpu_torch.utils.geometry import bilinear_sample
from sph_nca_tpu_torch.utils.image import flat_color_target

GRAD_RTOL = 1e-4  # of max |g|, per parameter
LOSS_RTOL = 1e-3


@pytest.fixture(scope="module")
def scene():
    """A random slab of 3D points filling both window-size buckets: (jax
    engine, torch engine, loss-space positions x [N, 2], h)."""
    x = np.random.default_rng(1).uniform(-1, 1, (200, 3)).astype(np.float32)
    x[:, 2] *= 0.3
    h = 0.3
    je = jax_build(jnp.asarray(x), h)
    te = build_cell_engine(x, h, device="cpu")
    assert te.blk_xs.shape[0] > 0 and te.blk2_xs.shape[0] > 0
    return je, te, x[:, :2].copy(), h


def _configs(h, channels=16, hidden=32):
    kw = dict(channels=channels, hidden=hidden, fire_rate=1.0,
              normalize_perception=1.0 / h)
    return JaxConfig(**kw), SPHNCAConfig(**kw)


def _params(jcfg, seed=0):
    jp = jax_init(jax.random.key(seed), jcfg)
    return jp, params_from_jax_numpy(*(np.asarray(a) for a in jp),
                                     device="cpu")


def _target(size=8, seed=2):
    return np.random.default_rng(seed).random((size, size, 4)).astype(
        np.float32)


def test_init_params_law():
    cfg = SPHNCAConfig(channels=16, hidden=64)
    p = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert [tuple(t.shape) for t in p] == [(48, 64), (64,), (64, 33), (33,)]
    assert num_params(p) == 48 * 64 + 64 + 64 * 33 + 33
    for t, fan_in in zip(p, (48, 48, 64, 64)):
        assert float(t.abs().max()) <= 1.0 / np.sqrt(fan_in)
        assert float(t.std()) > 0.4 / np.sqrt(fan_in)  # U(-b, b): b/sqrt(3)
    again = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(p, again))
    orig = init_params(dataclasses.replace(cfg, update_rule="orig"),
                       torch.Generator().manual_seed(0), device="cpu")
    assert not orig.w2.any() and not orig.b2.any()
    assert orig.w2.shape == (64, 16)


ROLL_B, ROLL_STEPS, ROLL_COLLECT = 2, 3, np.asarray([0, 2, 3])


def _rollout_inputs(te):
    rng = np.random.default_rng(3)
    A0 = rng.uniform(-0.2, 1.0, (ROLL_B, te.num_particles, 16)).astype(
        np.float32)
    R1 = rng.normal(size=A0.shape).astype(np.float32)
    R2 = rng.normal(size=(len(ROLL_COLLECT),) + A0.shape).astype(np.float32)
    return A0, R1, R2


@pytest.fixture(scope="module")
def jax_rollout_grads(scene):
    """The JAX loss and parameter gradients of a 3-step BPTT rollout of a
    batch of 2 with collected intermediate states (jax.value_and_grad)."""
    je, te, _, h = scene
    jcfg, _ = _configs(h)
    jp, _ = _params(jcfg)
    A0, R1, R2 = _rollout_inputs(te)

    def jloss(p):
        def one(A):
            out = jax_rollout(p, jcfg, je, je.scatter(A), jax.random.key(0),
                              ROLL_STEPS, h, fire_rate=1.0,
                              collect_steps=jnp.asarray(ROLL_COLLECT))
            return (je.gather_back(out.final),
                    jax.vmap(je.gather_back)(out.collected))

        final, coll = jax.vmap(one)(jnp.asarray(A0))  # coll [B, S, N, F]
        return (jnp.sum(final * R1)
                + jnp.sum(jnp.swapaxes(coll, 0, 1) * R2))

    loss, grads = jax.value_and_grad(jloss)(jp)
    return float(loss), [np.asarray(g) for g in grads]


@pytest.mark.parametrize("remat", [True, False])
def test_rollout_param_grads_match_jax(scene, jax_rollout_grads, remat,
                                       monkeypatch):
    """The port's batched BPTT gives the JAX package's loss and parameter
    gradients, with and without recomputing each step in the backward."""
    monkeypatch.setattr(cell_step, "REMAT", remat)
    _, te, _, h = scene
    jcfg, tcfg = _configs(h)
    _, tp = _params(jcfg)
    A0, R1, R2 = _rollout_inputs(te)
    want_loss, want_g = jax_rollout_grads

    tp = MLPParams(*(t.clone().requires_grad_(True) for t in tp))
    final, coll = rollout_cells(
        tp, tcfg, te, te.scatter(torch.from_numpy(A0)),
        torch.Generator().manual_seed(0), ROLL_STEPS, h, fire_rate=1.0,
        collect_steps=ROLL_COLLECT)
    assert coll.shape == (3, 2) + tuple(te.xs.shape[:2]) + (16,)
    loss = (torch.sum(te.gather_back(final) * torch.from_numpy(R1))
            + torch.sum(te.gather_back(coll) * torch.from_numpy(R2)))
    loss.backward()
    np.testing.assert_allclose(loss.item(), want_loss, rtol=1e-5)
    for got, want in zip(tp, want_g):
        err = float(np.max(np.abs(got.grad.numpy() - want)))
        assert err <= GRAD_RTOL * float(np.max(np.abs(want))), err


def test_rollout_n_steps_and_collect_buffer(scene):
    """The rollout runs n_steps steps; the buffer holds the state after
    each collect step (0 is the initial state, repeats allowed), and a
    collect step outside [0, n_steps] is refused."""
    _, te, _, h = scene
    jcfg, tcfg = _configs(h)
    _, tp = _params(jcfg)
    A0 = torch.from_numpy(np.random.default_rng(4).uniform(
        0.0, 1.0, (te.num_particles, 16)).astype(np.float32))
    S0 = te.scatter(A0)
    gen = torch.Generator().manual_seed(0)
    one = rollout_cells(tp, tcfg, te, S0, gen, 1, h)
    two = rollout_cells(tp, tcfg, te, S0, gen, 2, h)
    final, coll = rollout_cells(tp, tcfg, te, S0, gen, 2, h,
                                collect_steps=[0, 1, 2, 2])
    assert torch.equal(final, two)
    for got, want in zip(coll, [S0, one, two, two]):
        assert torch.equal(got, want)
    with pytest.raises(ValueError, match="outside"):
        rollout_cells(tp, tcfg, te, S0, gen, 2, h, collect_steps=[3])


def test_bilinear_sample_matches_jax():
    rng = np.random.default_rng(0)
    p = rng.uniform(-1.4, 1.4, (300, 2)).astype(np.float32)
    img = rng.random((8, 6, 4)).astype(np.float32)
    want = jax_bilinear(jnp.asarray(p), jnp.asarray(img),
                        jnp.asarray([-0.5, -0.5]), jnp.asarray([1.0, 1.0]))
    pt = torch.from_numpy(p).requires_grad_(True)
    got = bilinear_sample(pt, torch.from_numpy(img), (-0.5, -0.5), (1.0, 1.0))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-6, atol=1e-6)
    got.sum().backward()  # differentiable in the positions
    assert torch.isfinite(pt.grad).all()


@pytest.mark.parametrize("use_alpha", [True, False])
def test_mse_losses_match_jax(use_alpha):
    rng = np.random.default_rng(0)
    x = rng.uniform(-1, 1, (64, 2)).astype(np.float32)
    A = rng.uniform(-1.5, 1.5, (3, 64, 16)).astype(np.float32)
    img = _target()
    kw = dict(gmin=(-1, -1), gsize=(2, 2), image_scale=0.5,
              overflow_weight=0.05, use_alpha=use_alpha)
    jcfg, tcfg = JaxMSECfg(**kw), MSELossConfig(**kw)
    tx, tA, timg = (torch.from_numpy(a) for a in (x, A, img))
    got = mse_loss(tx, tA, timg, tcfg)
    for b in range(3):
        np.testing.assert_allclose(
            got[b].item(), float(jax_mse(jnp.asarray(x), jnp.asarray(A[b]),
                                         jnp.asarray(img), jcfg)), rtol=1e-6)
    want = jax_bundle(jnp.asarray(img), jcfg).batch_total(
        jnp.asarray(x), jnp.asarray(A), None)
    np.testing.assert_allclose(
        make_mse_bundle(timg, tcfg).batch_total(tx, tA).item(), float(want),
        rtol=1e-6)
    np.testing.assert_array_equal(flat_color_target(16), jax_flat(16))


def test_step_schedule_matches_jax():
    got_rng, want_rng = np.random.default_rng(5), np.random.default_rng(5)
    for i in range(0, 260, 7):
        n = progressive_steps(i, (32, 48), 5, got_rng)
        assert n == jax_progressive(i, (32, 48), 5, want_rng)
    assert progressive_steps(3, (4, 6), 0, got_rng) == jax_progressive(
        3, (4, 6), 0, want_rng)


def test_lr_schedule_matches_optax():
    p = torch.zeros(3, requires_grad=True)
    opt, sched = make_optimizer([p], 3e-3, end_factor=0.1, decay_steps=20)
    want = optax.linear_schedule(init_value=3e-3, end_value=3e-4,
                                 transition_steps=20)
    for count in range(30):
        np.testing.assert_allclose(opt.param_groups[0]["lr"],
                                   float(want(count)), rtol=1e-6)
        opt.step()
        sched.step()


def test_pool_draws_match_jax():
    rng = np.random.default_rng(0)
    x = rng.random((40, 2)).astype(np.float32)
    seed_A = rng.random((40, 4)).astype(np.float32)
    pools = [cls(x, seed_A, 10, rng=np.random.default_rng(7),
                 randomized_feat=rand)
             for cls, rand in ((Pool, False), (JaxPool, False),
                               (Pool, True), (JaxPool, True))]
    for got, want in (pools[:2], pools[2:]):
        np.testing.assert_array_equal(got.A, want.A)
        for _ in range(3):
            gi, gA = got.sample(4, degrade_prob=0.2, erase_radius=0.3)
            wi, wA = want.sample(4, degrade_prob=0.2, erase_radius=0.3)
            np.testing.assert_array_equal(gi, wi)
            np.testing.assert_array_equal(gA, wA)
            np.testing.assert_array_equal(got.initial_feature(),
                                          want.initial_feature())
            got.update(gi, gA + 1)
            want.update(wi, wA + 1)
        np.testing.assert_array_equal(got.A, want.A)


def test_trainer_losses_match_jax(scene):
    """Three iterations of the port's Trainer and of the JAX Trainer from
    the same params and pool draws: the same losses."""
    je, te, x2, h = scene
    jcfg, tcfg = _configs(h, channels=8)
    jp, tp = _params(jcfg, seed=1)
    img = _target()
    kw = dict(gmin=(-1, -1), gsize=(2, 2), image_scale=1.0)
    tc = dict(batch_size=2, pool_size=4, steps_range=(3, 5),
              steps_increment=1, aux_states=2, lr_decay_steps=10)
    seed_A = np.asarray(jax_plane_seed(jnp.asarray(x2), 8, gmin=(-1, -1),
                                       gsize=(2, 2), radius=h))

    jt = JaxTrainer(jcfg, JaxTrainConfig(**tc), je, jnp.asarray(x2),
                    jax_bundle(jnp.asarray(img), JaxMSECfg(**kw)), h,
                    params=jp)
    jpool = JaxPool(x2, seed_A, 4, rng=np.random.default_rng(0))
    tt = Trainer(tcfg, TrainConfig(**tc), te, torch.from_numpy(x2),
                 make_mse_bundle(torch.from_numpy(img), MSELossConfig(**kw)),
                 h, params=tp)
    tpool = Pool(x2, seed_A, 4, rng=np.random.default_rng(0))
    want = [jt.run_iteration(i, jpool) for i in range(3)]
    got = [tt.run_iteration(i, tpool) for i in range(3)]
    assert tt.last_steps == 3
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    np.testing.assert_allclose(tpool.A, jpool.A, atol=1e-3)


@pytest.fixture(scope="module")
def table_engines(scene):
    """The scene's engines with float32 pair tables (what the train CLIs
    build)."""
    _, _, x2, h = scene
    x = np.random.default_rng(1).uniform(-1, 1, (200, 3)).astype(np.float32)
    x[:, 2] *= 0.3
    je = jax_build(jnp.asarray(x), h, pair_tables="float32", xla_tables=False)
    te = build_cell_engine(x, h, pair_tables="float32", device="cpu")
    return je, te


def test_table_trainer_losses_match_jax(scene, table_engines):
    """Three iterations of the port's Trainer and of the JAX Trainer on
    table engines (both take their batched-lane rollout) with device pools,
    from the same params and pool draws: the same losses and pool states."""
    _, _, x2, h = scene
    je, te = table_engines
    jcfg, tcfg = _configs(h)
    jp, tp = _params(jcfg, seed=2)
    img = _target()
    kw = dict(gmin=(-1, -1), gsize=(2, 2), image_scale=1.0)
    tc = dict(batch_size=2, pool_size=4, steps_range=(3, 5),
              steps_increment=1, aux_states=2, lr_decay_steps=10)
    seed_A = np.asarray(jax_plane_seed(jnp.asarray(x2), 16, gmin=(-1, -1),
                                       gsize=(2, 2), radius=h))
    jt = JaxTrainer(jcfg, JaxTrainConfig(**tc), je, jnp.asarray(x2),
                    jax_bundle(jnp.asarray(img), JaxMSECfg(**kw)), h,
                    params=jp)
    jpool = JaxDevicePool(x2, seed_A, 4, rng=np.random.default_rng(0))
    tt = Trainer(tcfg, TrainConfig(**tc), te, torch.from_numpy(x2),
                 make_mse_bundle(torch.from_numpy(img), MSELossConfig(**kw)),
                 h, params=tp)
    tpool = DevicePool(x2, seed_A, 4, rng=np.random.default_rng(0),
                       device="cpu")
    calls = []
    batched = cell_step.rollout_cells_batched
    import sph_nca_tpu_torch.training.trainer as trainer_mod

    def spy(*a, **k):
        calls.append(k["n_steps"])
        return batched(*a, **k)

    trainer_mod.rollout_cells_batched = spy
    try:
        got = [tt.run_iteration(i, tpool) for i in range(3)]
    finally:
        trainer_mod.rollout_cells_batched = batched
    want = [float(jt.run_iteration(i, jpool)) for i in range(3)]
    assert calls == [[1, 1], [2, 2], [3, 3]]
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    np.testing.assert_allclose(tpool.state_np(), jpool.state_np(), atol=1e-3)


@pytest.mark.parametrize("randomized", [False, True])
def test_device_pool_draws_match_jax(randomized):
    """The same host index draws as the JAX DevicePool (and the host Pool);
    damage consumes the numpy rng the same way, so later draws still agree,
    and applies the same law: degraded particles hold values in [0, 1),
    erased ones zeros."""
    rng = np.random.default_rng(0)
    x = rng.random((40, 2)).astype(np.float32)
    seed_A = (rng.random((40, 4)) + 2.0).astype(np.float32)
    got = DevicePool(x, seed_A, 10, rng=np.random.default_rng(7),
                     randomized_feat=randomized, device="cpu")
    want = JaxDevicePool(x, seed_A, 10, rng=np.random.default_rng(7),
                         randomized_feat=randomized)
    host = Pool(x, seed_A, 10, rng=np.random.default_rng(7))
    assert got.A.shape == (10, 40, 4) and got.A.device.type == "cpu"
    if not randomized:
        np.testing.assert_array_equal(got.state_np(), want.state_np())
        for _ in range(2):
            gi, gA = got.sample(4)
            wi, wA = want.sample(4)
            hi, hA = host.sample(4)
            np.testing.assert_array_equal(gi, wi)
            np.testing.assert_array_equal(gi, hi)
            np.testing.assert_array_equal(gA.numpy(), np.asarray(wA))
            got.update(gi, gA + 1)
            want.update(wi, wA + 1)
        np.testing.assert_array_equal(got.state_np(), want.state_np())
    else:
        a = got.state_np()
        assert (0 <= a).all() and (a < 1).all() and a.std() > 0.2
    gi, gA = got.sample(4, degrade_prob=0.3)
    wi, _ = want.sample(4, degrade_prob=0.3)
    np.testing.assert_array_equal(gi, wi)
    if not randomized:
        hit = (gA.numpy() < 2.0).all(-1)  # re-randomized particles
        assert 0.1 < hit.mean() < 0.5
        assert (gA.numpy()[hit] < 1.0).all()
    gi, gA = got.sample(4, erase_radius=0.3)
    wi, _ = want.sample(4, erase_radius=0.3)
    np.testing.assert_array_equal(gi, wi)
    erased = (gA.numpy() == 0).all(-1)
    assert erased.any(axis=1).all()
    np.testing.assert_array_equal(got.sample(3)[0], want.sample(3)[0])
    got.load_state(want.state_np())
    np.testing.assert_array_equal(got.state_np(), want.state_np())


def test_train_cli_builds_tables_and_device_pool(tmp_path, monkeypatch):
    """With --engine cells the train CLI builds float32 pair tables and a
    device pool, as the JAX CLI does, so the trainer takes the batched path;
    --device_pool off keeps the host pool."""
    import sph_nca_tpu_torch.ops.cells as cells_mod
    import sph_nca_tpu_torch.training.trainer as trainer_mod

    built, pools, rollouts = [], [], []
    build = cells_mod.build_cell_engine
    batched = trainer_mod.rollout_cells_batched

    def spy_build(*a, **k):
        built.append(k.get("pair_tables"))
        return build(*a, **k)

    def spy_rollout(*a, **k):
        rollouts.append(k["n_steps"])
        return batched(*a, **k)

    run_iteration = trainer_mod.Trainer.run_iteration

    def spy_iteration(self, i, pool):
        pools.append(type(pool).__name__)
        return run_iteration(self, i, pool)

    monkeypatch.setattr(cells_mod, "build_cell_engine", spy_build)
    monkeypatch.setattr(trainer_mod, "rollout_cells_batched", spy_rollout)
    monkeypatch.setattr(trainer_mod.Trainer, "run_iteration", spy_iteration)
    argv = ["--device", "cpu", "--image_size", "12", "--h", "0.3",
            "--training_iter", "2", "--batch_size", "2", "--pool_size", "4",
            "--steps_range", "2,3", "--steps_increment", "1", "--hidden",
            "16", "--log_every", "1", "--engine", "cells"]
    assert cli_train.main(argv + ["--output_dir", str(tmp_path / "a")]) == 0
    assert cli_train.main(argv + ["--output_dir", str(tmp_path / "b"),
                                  "--device_pool", "off"]) == 0
    assert built == ["float32", "float32"]
    assert pools == ["DevicePool"] * 2 + ["Pool"] * 2
    assert rollouts == [[1, 1], [2, 2]] * 2


def test_train_cli_weights_run_in_test_cli(tmp_path):
    out = tmp_path / "train"
    rc = cli_train.main([
        "--device", "cpu", "--image_size", "16", "--h", "0.25",
        "--training_iter", "3", "--batch_size", "2", "--pool_size", "4",
        "--steps_range", "3,5", "--steps_increment", "1", "--hidden", "32",
        "--log_every", "1", "--output_dir", str(out)])
    assert rc == 0
    (metrics,) = glob.glob(str(out / "metrics-*.jsonl"))
    with open(metrics) as f:
        rows = [json.loads(line) for line in f]
    assert [r["iter"] for r in rows] == [0, 1, 2]
    assert [r["steps"] for r in rows] == [1, 2, 3]
    assert all(np.isfinite(r["loss"]) for r in rows)
    (weights,) = glob.glob(str(out / "sphnca-*.json"))
    model = load_weights_json(weights, device="cpu")
    assert (model.cfg.hidden, model.cfg.channels, model.h) == (32, 16, 0.25)
    rc = cli_test.main(["--weights_json", weights, "--image_size", "16",
                        "--steps", "2", "--device", "cpu",
                        "--output_dir", str(tmp_path / "test")])
    assert rc == 0
    (run,) = os.listdir(tmp_path / "test")
    with np.load(tmp_path / "test" / run / "states.npz") as z:
        assert z["states"].shape == (3, 256, 16)
        assert np.isfinite(z["states"]).all()


def _metrics_losses(out_dir, key):
    (path,) = glob.glob(str(out_dir / "metrics-*.jsonl"))
    with open(path) as f:
        return {r[key]: r["loss"] for r in map(json.loads, f)}


def _train_cli_matches_jax(tmp_path, monkeypatch, extra):
    """The port's train CLI with ``extra`` flags against the JAX CLI's, from
    the same initial parameters (a JAX checkpoint given to both as
    --pretrained_checkpoint) at fire_rate 1 (both CLIs build their model
    at 0.5; here both build it at 1): the same losses (LOSS_RTOL), since the
    pool, schedule and aux-state draws are numpy in both."""
    import sph_nca_tpu.models as jax_models
    import sph_nca_tpu_torch.models.nca as port_nca
    from sph_nca_tpu.cli import train as jax_cli
    from sph_nca_tpu.io.checkpoint import save_checkpoint as jax_save

    for mod in (jax_models, port_nca):
        monkeypatch.setattr(mod, "SPHNCAConfig", functools.partial(
            _fire_rate_one, mod.SPHNCAConfig))
    h = 0.3
    jcfg = JaxConfig(hidden=16, fire_rate=1.0, normalize_perception=1 / h)
    jax_save(str(tmp_path / "init"), params=jax_init(jax.random.key(3),
                                                     jcfg),
             model_cfg=jcfg, h=h, step=0)
    common = ["--image_size", "12", "--target_size", "8", "--h", str(h),
              "--batch_size", "2", "--pool_size", "4", "--steps_range",
              "2,4", "--steps_increment", "1", "--hidden", "16",
              "--log_every", "1", "--checkpoint_every",
              "1000", "--save_resume", "false", "--pretrained_checkpoint",
              str(tmp_path / "init")] + list(extra)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        assert cli_train.main(common + [
            "--training_iter", "4", "--device", "cpu", "--output_dir",
            str(tmp_path / "port")]) == 0
    finally:
        torch.set_num_threads(n)
    # the JAX CLI runs iterations 0 .. --training_iter
    assert jax_cli.main(common + ["--training_iter", "3", "--platform",
                                  "cpu", "--output_dir",
                                  str(tmp_path / "jax")]) == 0
    got = _metrics_losses(tmp_path / "port", "iter")
    want = _metrics_losses(tmp_path / "jax", "step")
    assert sorted(got) == sorted(want) == [0, 1, 2, 3]
    np.testing.assert_allclose([got[i] for i in range(4)],
                               [want[i] for i in range(4)], rtol=LOSS_RTOL)


def _fire_rate_one(cls, **kw):
    return cls(**{**kw, "fire_rate": 1.0})


# a tiny run of the port's CLI on the CPU
TINY_ARGV = ["--device", "cpu", "--image_size", "12", "--target_size", "8",
             "--h", "0.3", "--batch_size", "2", "--pool_size", "4",
             "--steps_range", "2,3", "--steps_increment", "1", "--hidden",
             "16", "--training_iter", "2", "--save_resume", "false"]


@pytest.mark.parametrize("argv", [["--engine", "graph"],
                                  ["--loss", "clip_multiscale"],
                                  ["--target", "x"],
                                  ["--optimizer", "SGD"]])
def test_train_cli_names_unported_modes(tmp_path, monkeypatch, argv):
    """Each case is a mode of the JAX CLI that the port's CLI refused by
    name until it was ported; the refusal table is gone and each mode runs.
    ``--engine graph`` and ``--optimizer SGD`` hold the CLI's losses to the
    JAX CLI's from the same parameters at fire_rate 1. ``--loss
    clip_multiscale`` trains from a guide (its parity with the JAX CLI is
    tests/test_torch_clip_cli.py's) and exits naming both flags without
    one.
    ``--target x`` trains on the emoji from a local cache, and raises
    FileNotFoundError, as the JAX package does, when it is not cached."""
    from PIL import Image

    from sph_nca_tpu.utils import image as jax_image

    assert not hasattr(cli_train, "NOT_PORTED")
    if argv[0] in ("--engine", "--optimizer"):
        extra = argv if argv[0] == "--engine" else argv + ["--engine",
                                                           "graph"]
        _train_cli_matches_jax(tmp_path, monkeypatch, extra)
        return
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        if argv[0] == "--loss":
            with pytest.raises(SystemExit, match="--clip_guide"):
                cli_train.main(TINY_ARGV + argv + ["--output_dir",
                                                   str(tmp_path / "none")])
            assert not os.path.exists(tmp_path / "none")
            argv = argv + ["--clip_guide", "a red and yellow spiral"]
        else:
            monkeypatch.setenv("SPH_NCA_EMOJI_CACHE", str(tmp_path))
            monkeypatch.setattr(jax_image, "NOTO_CACHE", str(tmp_path))
            with pytest.raises(FileNotFoundError, match="not cached"):
                jax_image.load_emoji("x")
            with pytest.raises(FileNotFoundError, match="not cached"):
                cli_train.main(TINY_ARGV + argv + ["--output_dir",
                                                   str(tmp_path / "none")])
            assert not os.path.exists(tmp_path / "none")
            Image.fromarray(np.full((16, 16, 4), 200, np.uint8)).save(
                tmp_path / "emoji_u0078.png")
        out = tmp_path / "run"
        assert cli_train.main(TINY_ARGV + argv + ["--output_dir",
                                                  str(out)]) == 0
    finally:
        torch.set_num_threads(n)
    losses = _metrics_losses(out, "iter")
    assert sorted(losses) == [0, 1]
    assert np.isfinite(list(losses.values())).all()


@pytest.mark.parametrize("mode", ["RGBA", "RGB", "L"])
def test_load_image_matches_jax(tmp_path, mode):
    from PIL import Image

    from sph_nca_tpu.utils.image import load_image as jax_load_image
    from sph_nca_tpu_torch.utils.image import load_image

    rng = np.random.default_rng(0)
    chans = {"RGBA": 4, "RGB": 3, "L": 1}[mode]
    arr = rng.integers(0, 256, (40, 30, chans), dtype=np.uint8)
    path = str(tmp_path / f"target_{mode}.png")
    Image.fromarray(arr[..., 0] if mode == "L" else arr, mode).save(path)
    for premultiply in (True, False):
        got = load_image(path, 16, premultiply)
        assert got.shape[-1] == 4 and max(got.shape[:2]) == 16
        np.testing.assert_array_equal(got, jax_load_image(path, 16,
                                                          premultiply))
