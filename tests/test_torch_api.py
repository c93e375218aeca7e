"""Port parity: the public API of ``sph_nca_tpu_torch`` against the JAX
package's, on the CPU.

* Each subpackage's ``__all__`` equals the JAX counterpart's, in its order,
  apart from the names in ``NOT_EXPORTED`` (each with its reason), and every
  name is bound.
* ``utils.batching`` (``pack`` / ``unpack`` / ``pad_ragged``) and
  ``native.fps`` / ``native.cell_hash`` give exactly what the JAX package's
  give on the same seeded inputs.
* ``utils.profiling.StepTimer`` keeps the JAX timer's interface, and
  ``trace`` writes a Chrome trace.
* The golden drive recipe (a checkpoint, a regular grid, ``ops.build_graph``,
  ``utils.plane_seed``, ``models.rollout_states``) through the port's public
  names matches the same recipe through the JAX package's, at 32 x 32 for a
  few steps at fire_rate 1 (the packages draw fire masks from different
  streams): 1e-4 of the largest state value, the rollout tolerance of
  ``tests/test_torch_graph_paths.py``.
"""

import glob
import json
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sph_nca_tpu
import sph_nca_tpu_torch
from sph_nca_tpu import native as jax_native
from sph_nca_tpu.utils import batching as JB
from sph_nca_tpu.utils import profiling as JP
from sph_nca_tpu_torch import native
from sph_nca_tpu_torch.utils import batching as TB
from sph_nca_tpu_torch.utils import profiling as TP

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(ROOT, "sph_nca_tpu_torch", "assets", "gecko_full_8000")
ROLL_RTOL = 1e-4

# The JAX names the port leaves out, and why. Each names JAX machinery that
# the port does not have; a counterpart of another meaning lives under
# another name and is not exported under this one.
NOT_EXPORTED = {
    "training": {
        # rounds a rollout's length up to a static scan length; the port
        # runs exactly the steps asked for
        "bucket_steps",
        # an optax GradientTransformation; the port's trainer normalizes the
        # gradients in place with trainer.normalize_grads_
        "normalize_grads",
    },
    "io": {
        # lays a raw state dict onto a fresh optax tree with flax; the port
        # restores an optimizer from that tree with
        # checkpoint.load_optax_state
        "restore_opt_state",
    },
}
SUBPACKAGES = ["ops", "models", "training", "utils", "io"]


def _sub(pkg, name):
    import importlib

    return importlib.import_module(f"{pkg.__name__}.{name}")


@pytest.mark.parametrize("name", SUBPACKAGES)
def test_public_names_match_jax(name):
    jax_mod = _sub(sph_nca_tpu, name)
    port = _sub(sph_nca_tpu_torch, name)
    left_out = NOT_EXPORTED.get(name, set())
    assert left_out <= set(jax_mod.__all__)
    assert port.__all__ == [n for n in jax_mod.__all__ if n not in left_out]
    for n in port.__all__:
        obj = getattr(port, n)
        # bound to the port's own object, never the JAX package's
        assert not getattr(obj, "__module__", "").startswith(
            "sph_nca_tpu."), n
    for n in left_out:
        assert not hasattr(port, n), n


def test_exception_map_is_exactly_the_listed_names():
    assert {k: sorted(v) for k, v in NOT_EXPORTED.items()} == {
        "training": ["bucket_steps", "normalize_grads"],
        "io": ["restore_opt_state"],
    }


def test_root_imports_ops_like_jax():
    assert sph_nca_tpu_torch.ops is _sub(sph_nca_tpu_torch, "ops")
    assert sph_nca_tpu_torch.ops.dense.__name__ == "sph_nca_tpu_torch.ops.dense"


def _ragged(seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((int(n), 3)).astype(np.float32)
            for n in rng.integers(1, 12, size=5)]


@pytest.mark.parametrize("seed", [0, 1])
def test_batching_matches_jax(seed):
    xs = _ragged(seed)
    want, want_sec = JB.pack(*(jnp.asarray(x) for x in xs))
    got, got_sec = TB.pack(*(torch.from_numpy(x) for x in xs))
    assert got_sec == want_sec
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for g, w in zip(TB.unpack(got, got_sec), JB.unpack(want, want_sec)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    for pad in (0.0, -1.5):
        (gd, gm), (wd, wm) = TB.pad_ragged(xs, pad), JB.pad_ragged(xs, pad)
        assert gd.dtype == wd.dtype and gm.dtype == wm.dtype
        np.testing.assert_array_equal(gd, wd)
        np.testing.assert_array_equal(gm, wm)


def test_step_timer():
    t = TP.StepTimer(num_particles=100, warmup=1)
    for _ in range(3):
        with t:
            time.sleep(0.01)
    s = t.summary()
    assert s["steps"] == 3
    # lower bound only: sleep guarantees >= 10ms, but a loaded shared CPU
    # can stretch wall time arbitrarily
    assert s["mean_ms"] > 5
    assert s["particle_steps_per_sec"] > 0
    # the JAX timer's keys, warmup skip and empty summary
    j = JP.StepTimer(num_particles=100, warmup=1)
    j.times = list(t.times)
    assert set(j.summary()) == set(s)
    np.testing.assert_allclose(s["mean_ms"], j.summary()["mean_ms"])
    assert np.isnan(TP.StepTimer().summary()["mean_ms"])


def test_device_sync_and_trace_on_cpu(tmp_path):
    x = torch.ones(8)
    TP.device_sync(x)
    TP.device_sync({"a": [x, (x,)], "b": 1})
    with TP.trace(str(tmp_path)) as d:
        (x * 2).sum()
    assert d == str(tmp_path)
    files = glob.glob(os.path.join(d, "trace-*.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("cat") == "cpu_op" for e in events)


def test_native_matches_jax(rng):
    assert native.available() and jax_native.available()
    from sph_nca_tpu.ops.hashgrid import _strides, cell_index
    from sph_nca_tpu.utils.meshes import farthest_point_sampling

    x = rng.uniform(-1, 1, (200, 3)).astype(np.float32)
    h, dims = 0.2, 10
    got = native.cell_hash(x, h, dims)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, jax_native.cell_hash(x, h, dims))
    ci = np.asarray(cell_index(jnp.asarray(x), h, (dims,) * 3))
    np.testing.assert_array_equal(got, ci @ _strides((dims,) * 3))

    x = rng.uniform(-1, 1, (500, 3)).astype(np.float32)
    for start in (0, 7):
        got = native.fps(x, 20, start)
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, jax_native.fps(x, 20, start))
    np.testing.assert_array_equal(
        native.fps(x, 20),
        np.asarray(farthest_point_sampling(jnp.asarray(x), 20)))
    for m, start in ((0, 0), (4, 500), (4, -1)):
        with pytest.raises(ValueError, match="fps"):
            native.fps(x, m, start)


def _jax_recipe(side, steps):
    from sph_nca_tpu import io, models, ops
    from sph_nca_tpu.utils import geometry, seeds

    ck = io.load_checkpoint(CKPT)
    h, cfg = ck["h"], ck["model_cfg"]
    x = geometry.grange((side, side), jnp.asarray([-1., -1.]),
                        jnp.asarray([2., 2.])).reshape(-1, 2)
    dims = ops.default_dims(h)
    mpc, k = ops.suggest_capacity(np.asarray(x), h, dims)
    g = ops.build_graph(x, h, dims, max_per_cell=mpc, k=k)
    A0 = seeds.plane_seed(x, cfg.channels, gmin=(-1, -1), gsize=(2, 2),
                          radius=h)
    states = models.rollout_states(ck["params"], cfg, g, A0,
                                   jax.random.key(0), steps, h,
                                   fire_rate=1.0)
    return np.asarray(x), np.asarray(states)


def _port_recipe(side, steps):
    from sph_nca_tpu_torch import io, models, ops, utils

    ck = io.load_checkpoint(CKPT, device="cpu")
    h, cfg = ck["h"], ck["model_cfg"]
    x = utils.grange((side, side), [-1., -1.], [2., 2.]).reshape(-1, 2)
    dims = ops.default_dims(h)
    mpc, k = ops.suggest_capacity(x, h, dims)
    g = ops.build_graph(x, h, dims, max_per_cell=mpc, k=k)
    A0 = utils.plane_seed(x, cfg.channels, gmin=(-1, -1), gsize=(2, 2),
                          radius=h)
    states = models.rollout_states(ck["params"], cfg, g, A0,
                                   torch.Generator().manual_seed(0), steps,
                                   h, fire_rate=1.0)
    return x.numpy(), states.numpy()


def test_golden_recipe_matches_jax():
    side, steps = 32, 6
    jx, want = _jax_recipe(side, steps)
    tx, got = _port_recipe(side, steps)
    np.testing.assert_array_equal(tx, jx)
    assert got.shape == want.shape == (steps + 1, side * side, 16)
    np.testing.assert_array_equal(got[0], want[0])
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= ROLL_RTOL * scale, (err, scale)
    # the rollout does something: the seed grows
    assert not np.allclose(want[-1], want[0])
