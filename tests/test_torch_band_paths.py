"""Port parity: the paths that run on the band engine — the batched step and
rollout (``models/cell_step.py``), the batched surface rollouts and
``diffuse_band`` (``models/surface.py``), the random seed's pre-diffusion,
the trainer and both CLIs — against the JAX package on the CPU.

The JAX side steps on its band engine with its update MLP through the
Pallas kernel in interpret mode (its module default set to ``"pallas"``,
the implementation the port carries, for each test); the port's wrappers
run their plain PyTorch versions. Fire masks come from different RNG
streams in the two packages, so steps and rollouts run at fire_rate 1.0.

Tolerances.
- A step and a 3-step rollout: 1e-4 of the largest state (float32 sums in
  another order, compounded over the steps). Both packages cast the band
  products' right-hand sides to the table dtype and test alive on the cast
  state, so bfloat16 tables are held to the same 1e-4. With a bfloat16 MLP
  the perception is rounded to bfloat16 on both sides: one step 1e-2 of the
  largest state.
- The surface rollouts: 1e-4 absolute on states (|A| <~ 1) and unit
  tangents; the JAX package fuses step t's diffusion into step t+1's
  perception, the port diffuses at the end of each step (the same
  function). ``diffuse_band`` and the pre-diffusion: 1e-5 absolute on unit
  tangents.
- BPTT parameter gradients of a 3-step rollout against
  ``jax.value_and_grad``: 1e-4 of the largest |g| per parameter, as the
  cell engine's (tests/test_torch_batched.py); against the port's cell
  engine, an extra check of the same function, 1e-4 too.
- The trainer: three iterations on a band engine against three on a cell
  engine with float32 pair tables (the same function; fire_rate 1.0 so the
  fire draws do not matter): losses to 1e-4 relative.
States keep their alpha lane 0.005 away from the alive threshold 0.1.
"""

import functools
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import sph_nca_tpu.models.cell_step as JCS
from sph_nca_tpu.models import SPHNCAConfig as JaxConfig
from sph_nca_tpu.models import init_params as jax_init_params
from sph_nca_tpu.models import surface as JSF
from sph_nca_tpu.ops import batched as JBT
from sph_nca_tpu.ops.bands import build_band_engine as jax_build_band
from sph_nca_tpu.utils import meshes as JM
from sph_nca_tpu_torch.cli import test as cli_test
from sph_nca_tpu_torch.cli import train as cli_train
from sph_nca_tpu_torch.io.convert import params_from_jax_numpy
from sph_nca_tpu_torch.io.weights_json import load_weights_json
from sph_nca_tpu_torch.models import cell_step as TCS
from sph_nca_tpu_torch.models import surface as TSF
from sph_nca_tpu_torch.models.nca import SPHNCAConfig
from sph_nca_tpu_torch.ops import batched as TBT
from sph_nca_tpu_torch.ops.bands import build_band_engine
from sph_nca_tpu_torch.ops.cells import build_cell_engine
from sph_nca_tpu_torch.training.losses import MSELossConfig
from sph_nca_tpu_torch.training.pool import Pool
from sph_nca_tpu_torch.training.trainer import (
    TrainConfig,
    Trainer,
    make_mse_bundle,
)
from sph_nca_tpu_torch.utils.seeds import prediffuse_tangents

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GECKO = os.path.join(ROOT, "sph_nca_tpu", "demo", "web", "weights",
                     "gecko.json")
F, B, H = 16, 3, 0.3
STEP_RTOL = 1e-4
BF16_RTOL = 1e-2
ATOL = 1e-4
DIFFUSE_ATOL = 1e-5
# the surface scene (tests/test_torch_surface_batched.py's sphere)
NS, HS, HS_D, STEPS = 1200, 0.22, 0.3, 3


@functools.cache
def _plane_engines(dtype):
    """A 3D cloud of 300 points squashed in z (the JAX band tests' kind of
    scene), blocks of 16 rows and far groups of 8."""
    x = np.random.default_rng(0).uniform(-1, 1, (300, 3)).astype(np.float32)
    x[:, 2] *= 0.3
    kw = dict(block_rows=16, far_group=8, table_dtype=dtype)
    je = jax_build_band(jnp.asarray(x), H, **kw)
    te = build_band_engine(x, H, device="cpu", **kw)
    assert len(te.far_tabs) > 0
    return x, je, te


@functools.cache
def _sphere_engines():
    x = JM.fibonacci_sphere(NS, 0.8)
    nrm = JM.sphere_normals(x)
    engines = []
    for h in (HS, HS_D):
        engines.append((jax_build_band(jnp.asarray(x), h),
                        build_band_engine(x, h, device="cpu")))
    return x, nrm, engines


@pytest.fixture
def pallas_mlp(monkeypatch):
    monkeypatch.setattr(JCS, "_MLP_IMPL_DEFAULT", "pallas")


def _states(n, seed, b=B, lo=-0.5, hi=1.0):
    """[b, n, F] states whose alpha lane keeps 0.005 away from 0.1."""
    A = np.random.default_rng(seed).uniform(lo, hi, (b, n, F)).astype(
        np.float32)
    a = A[..., 3]
    near = np.abs(a - 0.1) < 0.005
    A[..., 3] = np.where(near, np.where(a < 0.1, 0.09, 0.11), a)
    return A


def _model(h, hidden=32, use_alpha=True):
    kw = dict(channels=F, hidden=hidden, fire_rate=1.0, use_alpha=use_alpha,
              normalize_perception=1.0 / h)
    jcfg, cfg = JaxConfig(**kw), SPHNCAConfig(**kw)
    jp = jax_init_params(jax.random.key(0), jcfg)
    tp = params_from_jax_numpy(*(np.asarray(a) for a in jp), device="cpu")
    return jcfg, jp, cfg, tp


def _rel(got, want, rtol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(float(np.max(np.abs(want))), 1e-30)
    err = float(np.max(np.abs(got - want)))
    assert err <= rtol * scale, (err, scale)


def _abs(got, want, atol):
    err = float(np.max(np.abs(np.asarray(got) - np.asarray(want))))
    assert err <= atol, err


# ---- the batched step and rollout -------------------------------------------


@pytest.mark.parametrize("dtype,mlp_dtype", [
    ("float32", None), ("bfloat16", None), ("bfloat16", "bfloat16")])
def test_band_step_matches_jax(pallas_mlp, dtype, mlp_dtype):
    x, je, te = _plane_engines(dtype)
    jcfg, jp, cfg, tp = _model(H)
    A = _states(len(x), 1)
    SB = TBT.batched_scatter(te, torch.from_numpy(A))
    want = JBT.batched_gather_back(je, JCS.nca_step_cells_batched(
        jp, jcfg, je, jnp.asarray(SB.numpy()), B, jax.random.key(0), H,
        fire_rate=1.0, mlp_dtype=mlp_dtype), B)
    got = TBT.batched_gather_back(te, TCS.nca_step_cells_batched(
        tp, cfg, te, SB, B, torch.Generator(), H, fire_rate=1.0,
        mlp_dtype=mlp_dtype), B)
    _rel(got.numpy(), want, BF16_RTOL if mlp_dtype else STEP_RTOL)


def test_band_rollout_matches_jax(pallas_mlp):
    """3 steps with per-sample lengths and a collect buffer."""
    x, je, te = _plane_engines("float32")
    jcfg, jp, cfg, tp = _model(H)
    A = _states(len(x), 2)
    SB = TBT.batched_scatter(te, torch.from_numpy(A))
    n_steps, collect = [3, 2, 3], [0, 1, 3]
    out = JCS.rollout_cells_batched(
        jp, jcfg, je, jnp.asarray(SB.numpy()), B, jax.random.key(0), 3, H,
        n_steps=jnp.asarray(n_steps), fire_rate=1.0,
        collect_steps=jnp.asarray(collect))
    final, coll = TCS.rollout_cells_batched(
        tp, cfg, te, SB, B, torch.Generator(), 3, H, n_steps=n_steps,
        fire_rate=1.0, collect_steps=collect)
    _rel(TBT.batched_gather_back(te, final, B).numpy(),
         JBT.batched_gather_back(je, out.final, B), STEP_RTOL)
    for s in range(len(collect)):
        _rel(TBT.batched_gather_back(te, coll[s], B).numpy(),
             JBT.batched_gather_back(je, out.collected[s], B), STEP_RTOL)


@pytest.mark.parametrize("remat", [True, False])
def test_band_bptt_grads_match_jax(pallas_mlp, monkeypatch, remat):
    """Loss and parameter gradients of a 3-step band rollout with a
    collected state (plain autograd over the band products) against
    jax.value_and_grad of JAX's batched rollout on its band engine
    (float32 tables)."""
    monkeypatch.setattr(TCS, "REMAT", remat)
    x, je, te = _plane_engines("float32")
    jcfg, jp, cfg, tp0 = _model(H)
    A = _states(len(x), 9)
    SB = TBT.batched_scatter(te, torch.from_numpy(A))
    rng = np.random.default_rng(10)
    R1 = rng.normal(size=A.shape).astype(np.float32)
    R2 = rng.normal(size=A.shape).astype(np.float32)
    SBj = jnp.asarray(SB.numpy())

    def jloss(p):
        out = JCS.rollout_cells_batched(
            p, jcfg, je, SBj, B, jax.random.key(0), 3, H, fire_rate=1.0,
            collect_steps=jnp.asarray([2]))
        return (jnp.sum(JBT.batched_gather_back(je, out.final, B) * R1)
                + jnp.sum(JBT.batched_gather_back(je, out.collected[0], B)
                          * R2))

    want_loss, want_g = jax.value_and_grad(jloss)(jp)
    tp = type(tp0)(*(p.clone().requires_grad_(True) for p in tp0))
    final, coll = TCS.rollout_cells_batched(
        tp, cfg, te, SB, B, torch.Generator(), 3, H, fire_rate=1.0,
        collect_steps=[2])
    loss = ((TBT.batched_gather_back(te, final, B)
             * torch.from_numpy(R1)).sum()
            + (TBT.batched_gather_back(te, coll[0], B)
               * torch.from_numpy(R2)).sum())
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    for got, want in zip(tp, want_g):
        _rel(got.grad.numpy(), want, STEP_RTOL)


def test_band_rollout_grads_equal_cell_engine():
    """BPTT through 2 steps on the band engine (plain autograd over the band
    products) against the cell engine's table adjoint on the same points:
    the same function, so the same parameter gradients (float32)."""
    x, _, te = _plane_engines("float32")
    ce = build_cell_engine(x, H, pair_tables="float32", device="cpu")
    _, _, cfg, tp0 = _model(H)
    A = torch.from_numpy(_states(len(x), 3))
    grads = []
    for eng in (te, ce):
        tp = type(tp0)(*(p.clone().requires_grad_(True) for p in tp0))
        final = TCS.rollout_cells_batched(
            tp, cfg, eng, TBT.batched_scatter(eng, A), B, torch.Generator(),
            2, H, fire_rate=1.0)
        TBT.batched_gather_back(eng, final, B).square().sum().backward()
        grads.append([p.grad.numpy() for p in tp])
    for g, w in zip(*grads):
        _rel(g, w, STEP_RTOL)


def test_trainer_on_band_engine_equals_cell_engine():
    """Three Trainer iterations on a band engine (the train CLI's default)
    against three on a cell engine with float32 pair tables, from the same
    params and pool draws: the batched path on both, the same losses."""
    m, h = 12, 0.3
    x2 = torch.stack(torch.meshgrid(torch.linspace(-0.9, 0.9, m),
                                    torch.linspace(-0.9, 0.9, m),
                                    indexing="ij"), -1).reshape(-1, 2)
    x = torch.nn.functional.pad(x2, (0, 1))
    cfg = _model(h, hidden=16)[2]
    img = np.random.default_rng(4).uniform(0, 1, (8, 8, 4)).astype(
        np.float32)
    kw = dict(gmin=(-1, -1), gsize=(2, 2), image_scale=8 / m)
    tc = dict(batch_size=2, pool_size=4, steps_range=(2, 3),
              steps_increment=1, aux_states=1, lr_decay_steps=10)
    seed_A = np.zeros((m * m, F), np.float32)
    seed_A[m * m // 2 + m // 2, 3:] = 1.0
    losses = []
    for eng in (build_band_engine(x, h, device="cpu"),
                build_cell_engine(x, h, pair_tables="float32",
                                  device="cpu")):
        tr = Trainer(cfg, TrainConfig(**tc), eng, x2,
                     make_mse_bundle(torch.from_numpy(img),
                                     MSELossConfig(**kw)), h)
        pool = Pool(x2.numpy(), seed_A, 4, rng=np.random.default_rng(0))
        losses.append([tr.run_iteration(i, pool) for i in range(3)])
    assert tr.last_steps == 2  # the progressive schedule: 1, 1, 2
    assert all(np.isfinite(losses[0]))
    np.testing.assert_allclose(losses[0], losses[1], rtol=STEP_RTOL)


# ---- the surface paths -------------------------------------------------------


def _surface_inputs(seed, nrm, b=2):
    A = _states(NS, seed, b)
    t = np.random.default_rng(seed + 100).normal(size=(b, NS, 3)).astype(
        np.float32)
    t = np.stack([np.asarray(JSF.orthogonalize(jnp.asarray(nrm),
                                               jnp.asarray(ti))) for ti in t])
    return A, t


def test_surface_rollouts_match_jax(pallas_mlp):
    """rollout_mesh_batched (one band engine; JAX's fused schedule) and
    rollout_mesh_batched_dual (the diffusion on a second band engine at
    another radius) against the JAX package's, 3 steps."""
    x, nrm, ((je, te), (je_d, te_d)) = _sphere_engines()
    jcfg, jp, cfg, tp = _model(HS)
    A, t = _surface_inputs(5, nrm)
    args = (torch.from_numpy(A), torch.from_numpy(nrm), torch.from_numpy(t),
            torch.Generator(), STEPS, HS)
    jargs = (jnp.asarray(A), jnp.asarray(nrm), jnp.asarray(t),
             jax.random.key(1), STEPS, HS)
    want_A, want_T = JSF.rollout_mesh_batched(jp, jcfg, je, *jargs,
                                              fire_rate=1.0)
    got_A, got_T = TSF.rollout_mesh_batched(tp, cfg, te, *args,
                                            fire_rate=1.0)
    _abs(got_A.numpy(), want_A, ATOL)
    _abs(got_T.numpy(), want_T, ATOL)
    want_A, want_T, want_states = JSF.rollout_mesh_batched_dual(
        jp, jcfg, je, je_d, *jargs, fire_rate=1.0, collect_all=True)
    got_A, got_T, states = TSF.rollout_mesh_batched_dual(
        tp, cfg, te, te_d, *args, fire_rate=1.0, collect_all=True)
    _abs(got_A.numpy(), want_A, ATOL)
    _abs(got_T.numpy(), want_T, ATOL)
    _abs(states.numpy(), want_states, ATOL)


def test_diffuse_band_and_prediffusion_match_jax():
    x, nrm, ((_, _), (je_d, te_d)) = _sphere_engines()
    A, t = _surface_inputs(6, nrm, b=1)
    for lerp, wm in ((1.0, 1.0), (0.0, 0.5)):
        want = JSF.diffuse_band(je_d, jnp.asarray(nrm), jnp.asarray(t[0]),
                                jnp.asarray(A[0]), lerp_multiplier=lerp,
                                w_multiplier=wm)
        got = TSF.diffuse_band(te_d, torch.from_numpy(nrm),
                               torch.from_numpy(t[0]), torch.from_numpy(A[0]),
                               lerp_multiplier=lerp, w_multiplier=wm)
        _abs(got.numpy(), want, DIFFUSE_ATOL)
    want = jnp.asarray(t[0])
    ones = jnp.ones((NS, F))
    for _ in range(3):
        want = JSF.diffuse_band(je_d, jnp.asarray(nrm), want, ones,
                                lerp_multiplier=0.0)
    got = prediffuse_tangents(te_d, torch.from_numpy(nrm),
                              torch.from_numpy(t[0]), 3)
    _abs(got.numpy(), want, DIFFUSE_ATOL)


# ---- the CLIs ----------------------------------------------------------------


def _run_test_cli(out, *extra):
    rc = cli_test.main(["--weights_json", GECKO, "--device", "cpu",
                        "--output_dir", str(out)] + list(extra))
    assert rc == 0
    (run,) = os.listdir(out)
    with np.load(out / run / "states.npz") as z:
        return z["states"]


def test_test_cli_defaults_to_band_engine(tmp_path, monkeypatch):
    """Image mode builds a bfloat16 band engine and runs the batched
    rollout at B = 1 with every state kept; --engine cells keeps the
    recompute path."""
    import sph_nca_tpu_torch.ops.bands as bands_mod

    built = []
    build = bands_mod.build_band_engine

    def spy(*a, **k):
        built.append(k.get("table_dtype"))
        return build(*a, **k)

    monkeypatch.setattr(bands_mod, "build_band_engine", spy)
    band = _run_test_cli(tmp_path / "band", "--image_size", "16", "--steps",
                         "3")
    assert built == ["bfloat16"]
    cells = _run_test_cli(tmp_path / "cells", "--image_size", "16",
                          "--steps", "3", "--engine", "cells")
    assert built == ["bfloat16"]
    assert band.shape == cells.shape == (4, 256, 16)
    assert np.isfinite(band).all() and np.array_equal(band[0], cells[0])
    assert not np.array_equal(band[-1], band[0])


def test_test_cli_runs_wendland_models_on_band_engine(tmp_path):
    import json

    data = json.load(open(GECKO))
    data["config"]["smoothing"] = "wendlandC4"
    weights = tmp_path / "gecko-c4.json"
    weights.write_text(json.dumps(data))
    rc = cli_test.main(["--weights_json", str(weights), "--device", "cpu",
                        "--image_size", "12", "--steps", "2",
                        "--output_dir", str(tmp_path / "out")])
    assert rc == 0


def test_test_cli_surface_on_cell_engines(tmp_path):
    """--engine cells keeps cell engines in the surface mode (the JAX CLI
    maps both names to band engines)."""
    from scipy.spatial import ConvexHull

    v = JM.fibonacci_sphere(162, 1.0)
    obj = tmp_path / "sphere.obj"
    faces = ConvexHull(v).simplices
    with open(obj, "w") as f:
        f.writelines(f"v {a:.6f} {b:.6f} {c:.6f}\n" for a, b, c in v)
        f.writelines(f"f {i + 1} {j + 1} {k + 1}\n" for i, j, k in faces)
    states = {}
    for engine in ("band", "cells"):
        states[engine] = _run_test_cli(
            tmp_path / engine, "--surface", str(obj), "--surface_numpoints",
            "300", "--surface_numseed", "3", "--steps", "2", "--engine",
            engine)
    assert states["band"].shape == states["cells"].shape == (3, 300, 16)
    np.testing.assert_array_equal(states["band"][0], states["cells"][0])
    assert np.isfinite(states["cells"]).all()


def test_train_cli_defaults_to_band_engine(tmp_path, monkeypatch):
    """The train CLI builds a float32 band engine by default, carries
    --smoothing_kernel into the model and its weights JSON, and refuses a
    Wendland kernel on the cell engine."""
    import sph_nca_tpu_torch.ops.bands as bands_mod

    built = []
    build = bands_mod.build_band_engine

    def spy(*a, **k):
        built.append((k.get("table_dtype"), k.get("smoothing")))
        return build(*a, **k)

    monkeypatch.setattr(bands_mod, "build_band_engine", spy)
    argv = ["--device", "cpu", "--image_size", "12", "--h", "0.3",
            "--training_iter", "2", "--batch_size", "2", "--pool_size", "4",
            "--steps_range", "2,3", "--steps_increment", "1", "--hidden",
            "16", "--log_every", "1"]
    assert cli_train.main(argv + ["--output_dir", str(tmp_path / "a")]) == 0
    assert cli_train.main(argv + ["--output_dir", str(tmp_path / "b"),
                                  "--smoothing_kernel", "wendlandC2"]) == 0
    assert built == [("float32", "poly6"), ("float32", "wendlandC2")]
    (weights,) = (tmp_path / "b").glob("sphnca-*.json")
    assert load_weights_json(str(weights), device="cpu").cfg.smoothing == \
        "wendlandC2"
    with pytest.raises(SystemExit, match="poly6-only"):
        cli_train.main(argv + ["--output_dir", str(tmp_path / "c"),
                               "--engine", "cells", "--smoothing_kernel",
                               "wendlandC4"])
    assert not (tmp_path / "c").exists()
