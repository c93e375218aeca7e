"""Port parity: the JAX trainer's seven optimizers (``training/optim.py``)
against optax, their state in a checkpoint across the two packages, and the
train CLI's ``--optimizer``.

Each optimizer takes 3 updates from seeded params and gradients under the
gradient normalization and the linear schedule, as the JAX trainer chains
them (``make_optimizer``): the params and every leaf of the optax state
tree (``io/checkpoint.optax_state_tree`` against flax's
``to_state_dict``) agree to 1e-6 of the leaf's largest |value| (float32
updates in other orders; the schedule's lr in float64 here, float32 in
optax). A checkpoint of either package resumes in the other: one more
update from the carried state agrees to the same bar. A tree of another
optimizer's layout raises.
"""

import glob
import json
import os

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch
from flax import serialization

from sph_nca_tpu.io import checkpoint as JC
from sph_nca_tpu.models import SPHNCAConfig as JaxConfig
from sph_nca_tpu.models import init_params as jax_init
from sph_nca_tpu.training.trainer import make_optimizer as jax_optimizer
from sph_nca_tpu_torch.cli import train as cli_train
from sph_nca_tpu_torch.io import checkpoint as TC
from sph_nca_tpu_torch.io.convert import params_from_jax_numpy
from sph_nca_tpu_torch.models.nca import MLPParams, SPHNCAConfig
from sph_nca_tpu_torch.training.optim import (
    LAYOUTS,
    OPTIMIZERS,
    optimizer_name,
)
from sph_nca_tpu_torch.training.trainer import (
    make_optimizer,
    normalize_grads_,
    set_schedule_position,
)

RTOL = 1e-6
LR, DECAY = 3e-3, 10
NAMES = sorted(OPTIMIZERS)


def _configs():
    kw = dict(channels=4, hidden=8, use_alpha=False, normalize_perception=2.0)
    return JaxConfig(**kw), SPHNCAConfig(**kw)


def _grads(shapes, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32) for s in shapes]


def _port(jp, name):
    params = [p.clone().requires_grad_(True) for p in params_from_jax_numpy(
        *(np.asarray(a) for a in jp), device="cpu")]
    opt, sched = make_optimizer(params, LR, decay_steps=DECAY, name=name)
    return params, opt, sched


def _port_update(params, opt, sched, grads):
    for p, g in zip(params, grads):
        p.grad = torch.from_numpy(g.copy())
    normalize_grads_(params)
    opt.step()
    sched.step()


def _jax_update(tx, state, jp, grads):
    g = type(jp)(*(jnp.asarray(a) for a in grads))
    updates, state = tx.update(g, state, jp)
    return state, optax.apply_updates(jp, updates)


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}/{k}")
    else:
        yield path, np.asarray(tree)


def _hold(params, tree, jp, jstate):
    """The port's params and optax tree against JAX's."""
    for p, w in zip(params, jp):
        w = np.asarray(w)
        assert np.abs(p.detach().numpy() - w).max() <= RTOL * np.abs(w).max()
    got = dict(_leaves(tree))
    want = dict(_leaves(serialization.to_state_dict(jstate)))
    assert got.keys() == want.keys()
    for k, w in want.items():
        g = got[k]
        assert g.shape == w.shape and g.dtype == w.dtype, k
        if w.dtype == np.int32:
            assert np.array_equal(g, w), k
        else:
            assert np.abs(g - w).max() <= RTOL * max(np.abs(w).max(),
                                                     1e-30), k


def _three_updates(name, seed=0):
    jcfg, _ = _configs()
    jp = jax_init(jax.random.key(seed), jcfg)
    params, opt, sched = _port(jp, name)
    tx = jax_optimizer(LR, decay_steps=DECAY, name=name)
    state = tx.init(jp)
    shapes = [a.shape for a in jp]
    for s in range(3):
        g = _grads(shapes, seed * 10 + s)
        _port_update(params, opt, sched, g)
        state, jp = _jax_update(tx, state, jp, g)
    return params, opt, sched, tx, state, jp


@pytest.mark.parametrize("name", NAMES)
def test_optimizer_matches_optax(name):
    params, opt, _, _, state, jp = _three_updates(name)
    _hold(params, TC.optax_state_tree(opt, MLPParams(*params), True, name),
          jp, state)
    want_lr = float(optax.linear_schedule(LR, LR * 0.1, DECAY)(3))
    np.testing.assert_allclose(opt.param_groups[0]["lr"], want_lr, rtol=1e-6)


@pytest.mark.parametrize("name", NAMES)
def test_jax_checkpoint_resumes_in_port(tmp_path, name):
    """JAX saves after 3 updates, the port loads the state, and both take a
    fourth update."""
    jcfg, cfg = _configs()
    _, _, _, tx, state, jp = _three_updates(name, seed=1)
    path = str(tmp_path / "ck")
    JC.save_checkpoint(path, params=jp, model_cfg=jcfg, h=0.2, step=3,
                       opt_state=state)
    ck = TC.load_checkpoint(path, device="cpu")
    params = [p.clone().requires_grad_(True) for p in ck["params"]]
    opt, sched = make_optimizer(params, LR, decay_steps=DECAY, name=name)
    count = TC.load_optax_state(opt, MLPParams(*params), ck["opt_state"],
                                name)
    assert count == 3
    set_schedule_position(sched, count)
    g = _grads([a.shape for a in jp], 99)
    _port_update(params, opt, sched, g)
    state, jp = _jax_update(tx, state, jp, g)
    _hold(params, TC.optax_state_tree(opt, MLPParams(*params), True, name),
          jp, state)


@pytest.mark.parametrize("name", NAMES)
def test_port_checkpoint_resumes_in_jax(tmp_path, name):
    """The port saves after 3 updates, JAX restores the state onto its own
    optimizer's template, and both take a fourth update."""
    jcfg, cfg = _configs()
    params, opt, sched, tx, _, jp = _three_updates(name, seed=2)
    path = str(tmp_path / "ck")
    TC.save_checkpoint(path, params=MLPParams(*params), model_cfg=cfg, h=0.2,
                       step=3, opt_state=TC.optax_state_tree(
                           opt, MLPParams(*params), True, name))
    ck = JC.load_checkpoint(path)
    state = JC.restore_opt_state(tx.init(ck["params"]), ck["opt_state"])
    g = _grads([a.shape for a in jp], 98)
    _port_update(params, opt, sched, g)
    state, jp = _jax_update(tx, state, ck["params"], g)
    _hold(params, TC.optax_state_tree(opt, MLPParams(*params), True, name),
          jp, state)


@pytest.mark.parametrize("name", NAMES)
def test_other_layouts_raise(name):
    """A tree of every other optimizer's layout is refused (the layouts
    differ by the chain's length, an entry's fields or its count); the
    optimizer's own tree loads, with and without the normalization."""
    jcfg, _ = _configs()
    jp = jax_init(jax.random.key(0), jcfg)
    params, opt, _ = _port(jp, name)
    for normalize in (True, False):
        tree = TC.optax_state_tree(opt, MLPParams(*params), normalize, name)
        assert TC.load_optax_state(opt, MLPParams(*params), tree, name) == 0
    for other in NAMES:
        if other == name or LAYOUTS[other] == LAYOUTS[name]:
            continue
        oparams, oopt, _ = _port(jp, other)
        tree = TC.optax_state_tree(oopt, MLPParams(*oparams), True, other)
        with pytest.raises(ValueError, match="opt_state"):
            TC.load_optax_state(opt, MLPParams(*params), tree, name)


def test_names_are_case_insensitive_with_adam_fallback():
    assert optimizer_name("LAMB") == "lamb"
    assert optimizer_name("RMSprop") == "rmsprop"
    assert optimizer_name("Adam") == "adam"
    assert optimizer_name("nadam") == "adam"
    p = torch.zeros(3, requires_grad=True)
    opt, _ = make_optimizer([p], name="AdamW")
    assert type(opt).__name__ == "AdamW"
    opt, _ = make_optimizer([p], name="unknown")
    assert isinstance(opt, torch.optim.Adam)


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_train_cli_optimizer_checkpoints_and_resumes(tmp_path, one_thread):
    """``--optimizer lamb`` through the train CLI: its checkpoint carries
    LAMB's optax layout, which the JAX loader restores onto the JAX
    optimizer's template, and ``--resume auto`` continues the run exactly
    (bit-equal losses to a straight run)."""
    common = ["--device", "cpu", "--image_size", "12", "--target_size", "8",
              "--h", "0.3", "--batch_size", "2", "--pool_size", "4",
              "--steps_range", "2,4", "--steps_increment", "1", "--hidden",
              "16", "--optimizer", "LAMB", "--checkpoint_every", "2",
              "--log_every", "1"]
    straight, split = tmp_path / "straight", tmp_path / "split"
    assert cli_train.main(common + ["--training_iter", "4", "--output_dir",
                                    str(straight)]) == 0
    assert cli_train.main(common + ["--training_iter", "2", "--output_dir",
                                    str(split)]) == 0
    (ck,) = glob.glob(str(split / "sphnca-*-0002"))
    got = TC.load_checkpoint(ck, device="cpu")["opt_state"]
    assert set(got["1"]) == {"0", "1", "2", "3"}
    jck = JC.load_checkpoint(ck)
    tx = jax_optimizer(3e-3, name="lamb")
    state = JC.restore_opt_state(tx.init(jck["params"]), jck["opt_state"])
    assert int(state[1][0].count) == int(state[1][3].count) == 2
    assert cli_train.main(common + ["--training_iter", "4", "--output_dir",
                                    str(split), "--resume", "auto"]) == 0

    def losses(out):
        rows = {}
        for path in glob.glob(str(out / "metrics-*.jsonl")):
            with open(path) as f:
                rows.update({r["iter"]: r["loss"] for r in map(json.loads,
                                                               f)})
        return [rows[i] for i in sorted(rows)]

    assert losses(split) == losses(straight) and len(losses(split)) == 4
    assert os.path.exists(os.path.join(ck, "meta.json"))
