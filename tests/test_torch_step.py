"""Port parity: weights, the cell-engine NCA step and rollout against the JAX
package with ``use_pallas=True`` (Pallas interpret mode on the CPU), using
the in-repo gecko weights.

The two packages draw the fire mask from different RNG streams, so step and
rollout run at fire_rate 1.0, where the mask is all ones.

Tolerance: the float32 pair sums and the MLP's matmuls run in other orders,
so states agree to 1e-5 relative plus 1e-5 absolute (the gated rule keeps
|A| <~ 1; measured ~4e-7 over a short rollout, ~2e-6 relative for one step of
the unbounded orig rule).
"""

import dataclasses
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from sph_nca_tpu.io import load_weights_json as jax_load
from sph_nca_tpu.models.cell_step import nca_step_cells as jax_step
from sph_nca_tpu.models.cell_step import rollout_states_cells as jax_rollout
from sph_nca_tpu.models.nca import apply_mlp as jax_apply_mlp
from sph_nca_tpu.models.nca import to_rgba as jax_to_rgba
from sph_nca_tpu.ops.cells import build_cell_engine as jax_build
from sph_nca_tpu.utils.geometry import grange as jax_grange
from sph_nca_tpu.utils.seeds import plane_seed as jax_plane_seed
from sph_nca_tpu_torch.cli import test as cli_test
from sph_nca_tpu_torch.io.convert import params_from_jax_numpy
from sph_nca_tpu_torch.io.weights_json import load_weights_json
from sph_nca_tpu.models.cell_step import cell_activity_s as jax_activity
from sph_nca_tpu_torch.models.cell_step import (
    cell_activity_s,
    nca_step_cells,
    rollout_cells,
    rollout_states_cells,
)
from sph_nca_tpu_torch.models.nca import apply_mlp, to_rgba
from sph_nca_tpu_torch.ops.cells import build_cell_engine
from sph_nca_tpu_torch.utils.geometry import grange
from sph_nca_tpu_torch.utils.seeds import plane_seed

GECKO = os.path.join(os.path.dirname(__file__), "..", "sph_nca_tpu", "demo",
                     "web", "weights", "gecko.json")
RTOL = ATOL = 1e-5


@pytest.fixture(scope="module")
def gecko():
    return jax_load(GECKO), load_weights_json(GECKO, device="cpu")


def _grid_setup(jm, tm, m=24):
    jx2 = jax_grange((m, m), jnp.asarray((-1.0, -1.0)),
                     jnp.asarray((2.0, 2.0))).reshape(-1, 2)
    tx2 = grange((m, m), (-1.0, -1.0), (2.0, 2.0)).reshape(-1, 2)
    np.testing.assert_array_equal(tx2.numpy(), np.asarray(jx2))
    jA = jax_plane_seed(jx2, 16, gmin=(-1.0, -1.0), gsize=(2.0, 2.0),
                        radius=jm.h)
    tA = plane_seed(tx2, 16, gmin=(-1.0, -1.0), gsize=(2.0, 2.0),
                    radius=tm.h)
    np.testing.assert_array_equal(tA.numpy(), np.asarray(jA))
    je = jax_build(jnp.pad(jx2, ((0, 0), (0, 1))), jm.h)
    te = build_cell_engine(torch.nn.functional.pad(tx2, (0, 1)), tm.h,
                           device="cpu")
    return je, te, jA, tA


def test_weights_loaders_agree(gecko):
    jm, tm = gecko
    assert dataclasses.asdict(tm.cfg) == dataclasses.asdict(jm.cfg)
    assert (tm.h, tm.mode) == (jm.h, jm.mode)
    for a, b in zip(tm.params, jm.params):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_params_converter_and_mlp(gecko, rng):
    jm, _ = gecko
    p = params_from_jax_numpy(*(np.asarray(a) for a in jm.params),
                              device="cpu")
    for a, b in zip(p, jm.params):
        assert a.dtype == torch.float32
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    y = rng.normal(size=(64, 48)).astype(np.float32)
    np.testing.assert_allclose(apply_mlp(p, torch.from_numpy(y)).numpy(),
                               np.asarray(jax_apply_mlp(jm.params, y)),
                               rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError):
        params_from_jax_numpy(np.zeros((48, 8)), np.zeros(7), np.zeros((8, 3)),
                              np.zeros(3), device="cpu")


def test_to_rgba_and_activity_match_jax(rng):
    A = rng.normal(size=(10, 16)).astype(np.float32)
    for use_alpha in (True, False):
        np.testing.assert_array_equal(
            to_rgba(torch.from_numpy(A), use_alpha).numpy(),
            np.asarray(jax_to_rgba(A, use_alpha)))
        S = A.reshape(5, 2, 16)
        np.testing.assert_array_equal(
            cell_activity_s(torch.from_numpy(S), use_alpha).numpy(),
            np.asarray(jax_activity(S, use_alpha)))


@pytest.mark.parametrize("rule", ["gated", "orig"])
def test_step_matches_jax(gecko, rng, rule):
    jm, tm = gecko
    je, te, _, _ = _grid_setup(jm, tm)
    jcfg = dataclasses.replace(jm.cfg, update_rule=rule, fire_rate=1.0)
    tcfg = dataclasses.replace(tm.cfg, update_rule=rule, fire_rate=1.0)
    jp, tp = jm.params, tm.params
    if rule == "orig":  # the orig rule reads the first C outputs
        jp = jp._replace(w2=jp.w2[:, :16], b2=jp.b2[:16])
        tp = tp._replace(w2=tp.w2[:, :16].contiguous(), b2=tp.b2[:16])
    # a state with live and dead slots everywhere
    A = rng.uniform(-0.2, 1.0, size=(te.num_particles, 16)).astype(np.float32)
    jS, tS = je.scatter(jnp.asarray(A)), te.scatter(torch.from_numpy(A))
    gen = torch.Generator().manual_seed(0)
    want = je.gather_back(jax_step(jp, jcfg, je, jS, jax.random.key(0),
                                   jm.h, fire_rate=1.0, use_pallas=True))
    got = te.gather_back(nca_step_cells(tp, tcfg, te, tS, gen, tm.h,
                                        fire_rate=1.0))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def test_rollout_matches_jax(gecko):
    jm, tm = gecko
    je, te, jA, tA = _grid_setup(jm, tm)
    jcfg = dataclasses.replace(jm.cfg, fire_rate=1.0)
    tcfg = dataclasses.replace(tm.cfg, fire_rate=1.0)
    want = np.asarray(jax_rollout(jm.params, jcfg, je, jA, jax.random.key(0),
                                  6, jm.h, fire_rate=1.0, use_pallas=True))
    gen = torch.Generator().manual_seed(0)
    got = rollout_states_cells(tm.params, tcfg, te, tA, gen, 6, tm.h,
                               fire_rate=1.0)
    assert got.shape == want.shape == (7, 24 * 24, 16)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    final = rollout_cells(tm.params, tcfg, te, te.scatter(tA),
                          torch.Generator().manual_seed(0), 6, tm.h,
                          fire_rate=1.0)
    np.testing.assert_array_equal(te.gather_back(final).numpy(),
                                  got[-1].numpy())


def test_fire_mask_keeps_unfired_slots(gecko):
    """fire_rate 0: no slot updates, so the state only loses dead slots."""
    jm, tm = gecko
    _, te, _, tA = _grid_setup(jm, tm, m=16)
    S = te.scatter(tA)
    out = nca_step_cells(tm.params, tm.cfg, te, S,
                         torch.Generator().manual_seed(0), tm.h,
                         fire_rate=0.0)
    kept = out.abs().sum(-1) > 0
    assert torch.equal(out[kept], S[kept])


def test_cli_writes_trajectory(tmp_path):
    rc = cli_test.main(["--weights_json", GECKO, "--image_size", "16",
                        "--steps", "2", "--device", "cpu",
                        "--output_dir", str(tmp_path)])
    assert rc == 0
    (run,) = os.listdir(tmp_path)
    with np.load(tmp_path / run / "states.npz") as z:
        assert z["x"].shape == (256, 2)
        assert z["states"].shape == (3, 256, 16)
        assert np.isfinite(z["states"]).all()


def _obj(path):
    """A small ellipsoid mesh as an OBJ: quad bands and triangle caps."""
    nu, nv = 24, 12
    verts = [(0.0, 0.9, 0.0), (0.0, -0.9, 0.0)]
    for j in range(1, nv):
        th = np.pi * j / nv
        for i in range(nu):
            ph = 2 * np.pi * i / nu
            verts.append((1.3 * np.sin(th) * np.cos(ph), 0.9 * np.cos(th),
                          np.sin(th) * np.sin(ph)))
    lines = [f"v {a:.6f} {b:.6f} {c:.6f}" for a, b, c in verts]

    def ring(j, i):  # 1-based index of band j, column i
        return 3 + j * nu + i % nu

    for j in range(nv - 2):
        for i in range(nu):
            lines.append(f"f {ring(j, i)} {ring(j, i + 1)} "
                         f"{ring(j + 1, i + 1)} {ring(j + 1, i)}")
    for i in range(nu):
        lines.append(f"f 1 {ring(0, i + 1)} {ring(0, i)}")
        lines.append(f"f 2 {ring(nv - 2, i)} {ring(nv - 2, i + 1)}")
    path.write_text("\n".join(lines) + "\n")
    return str(path)


def _states_of(out_dir):
    (run,) = os.listdir(out_dir)
    with np.load(out_dir / run / "states.npz") as z:
        return z["x"], z["states"]


@pytest.fixture
def one_thread():
    """Torch on one intra-op thread: the tier-1 run's workers share the
    cores, and torch's own pools would oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("argv", [["--engine", "graph", "--surface",
                                   "mesh.obj"],
                                  ["--engine", "graph"]])
def test_cli_names_unported_modes(tmp_path, argv, monkeypatch, one_thread):
    """``--engine graph`` was refused here until the graph engine was
    ported; now both modes run (image, and ``--surface`` on a procedural
    mesh with radial seeds, at h 0.3), and each trajectory holds to the JAX CLI's at
    fire_rate 1.0 (1e-4 of max). The surface seeds' tangents are the JAX
    CLI's own draws, carried into the port's seed, which draws its own from
    a torch generator."""
    from sph_nca_tpu.cli import test as jax_cli
    from sph_nca_tpu.models.surface import orthogonalize as jax_orth
    from sph_nca_tpu.utils.meshes import farthest_point_sampling as jax_fps
    from sph_nca_tpu_torch.utils import seeds

    argv = [str(tmp_path / a) if a == "mesh.obj" else a for a in argv]
    common = ["--weights_json", GECKO, "--steps", "3", "--firerate", "1.0",
              "--seed", "0"] + argv
    if "--surface" in argv:
        _obj(tmp_path / "mesh.obj")
        # h 0.3: ~7 neighbours a point at this density (both CLIs take an
        # --h other than 0.08)
        common += ["--surface_numpoints", "300", "--surface_numseed", "3",
                   "--h", "0.3"]
        radial = seeds.surface_radial_seed

        def with_jax_tangents(x, nrm, channels, n_seeds, radius, gen):
            A0, t0 = radial(x, nrm, channels, n_seeds, radius, gen)
            sel = np.asarray(jax_fps(jnp.asarray(x.numpy()), n_seeds))
            assert set(sel.tolist()) == set(
                np.flatnonzero(t0.norm(dim=-1).numpy() > 0).tolist())
            key, t = jax.random.key(0), torch.zeros_like(t0)
            for i in sel.tolist():
                key, kt = jax.random.split(key)
                t[i] = torch.tensor(np.asarray(jax_orth(
                    jnp.asarray(nrm[i].numpy()),
                    jax.random.normal(kt, (3,)))))
            return A0, t

        monkeypatch.setattr(seeds, "surface_radial_seed", with_jax_tangents)
    else:
        common += ["--image_size", "32"]
    assert cli_test.main(common + ["--device", "cpu", "--output_dir",
                                   str(tmp_path / "port")]) == 0
    assert jax_cli.main(common + ["--platform", "cpu", "--output_dir",
                                  str(tmp_path / "jax")]) == 0
    x, got = _states_of(tmp_path / "port")
    jx, want = _states_of(tmp_path / "jax")
    np.testing.assert_array_equal(x, jx)
    assert got.shape == want.shape == (4, x.shape[0], 16)
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()
    assert not np.array_equal(got[-1], got[0])
