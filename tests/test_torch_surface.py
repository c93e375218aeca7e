"""Port parity: the surface rollout on the cell engine (tangent frames,
tangent diffusion over the poly6 table, tangent-space perception), the
procedural surfaces and farthest-point sampling, against the JAX package.

The JAX side runs its Pallas table kernels in interpret mode on the CPU; the
port's wrappers run their plain PyTorch versions. The fire mask comes from
different RNG streams in the two packages, so rollouts run at fire_rate 1.0.

Tolerances: the frame maths is a few f32 operations (1e-6 absolute on unit
vectors); the diffusion is a blur over the same f32 table in another order,
then a normalization (1e-5 absolute on unit tangents); a 4-step rollout holds
the final states and tangents to 1e-4 absolute (|A| <~ 1, unit tangents). The
meshes are the same numpy arithmetic (exact), and farthest-point sampling
picks the same indices.
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from sph_nca_tpu.models import SPHNCAConfig as JaxConfig
from sph_nca_tpu.models import init_params as jax_init_params
from sph_nca_tpu.models import surface as JS
from sph_nca_tpu.ops.cells import build_cell_engine as jax_build
from sph_nca_tpu.utils import meshes as JM
from sph_nca_tpu.utils.seeds import add_radial_seed as jax_add_radial_seed
from sph_nca_tpu_torch.io.convert import params_from_jax_numpy
from sph_nca_tpu_torch.models import surface as TS
from sph_nca_tpu_torch.models.nca import SPHNCAConfig
from sph_nca_tpu_torch.ops.cells import build_cell_engine
from sph_nca_tpu_torch.utils import meshes as TM
from sph_nca_tpu_torch.utils.seeds import add_radial_seed, surface_radial_seed

# tests/test_surface.py:140's scene: a sphere of 1200 points, h = 0.22
N, H = 1200, 0.22


@functools.cache
def _sphere():
    x = JM.fibonacci_sphere(N, 0.8)
    nrm = JM.sphere_normals(x)
    je = jax_build(jnp.asarray(x), H, xla_tables=False, pair_tables="float32")
    te = build_cell_engine(x, H, pair_tables="float32", device="cpu")
    return x, nrm, je, te


def _normal(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def test_normalize_and_orthogonalize_match_jax():
    v = _normal((64, 3), 0)
    v[:4] = 0.0  # a zero vector maps to 0
    n = JM.sphere_normals(_normal((64, 3), 1))
    np.testing.assert_allclose(TS.normalize(torch.from_numpy(v)).numpy(),
                               np.asarray(JS.normalize(jnp.asarray(v))),
                               atol=1e-6)
    got = TS.orthogonalize(torch.from_numpy(n), torch.from_numpy(v)).numpy()
    want = np.asarray(JS.orthogonalize(jnp.asarray(n), jnp.asarray(v)))
    np.testing.assert_allclose(got, want, atol=1e-6)
    assert np.all(got[:4] == 0)


def test_project_tangent_space_cells_matches_jax():
    gA = _normal((5, 8, 16, 3), 2)
    n = JM.sphere_normals(_normal((5, 8, 3), 3))
    t = np.array(JS.orthogonalize(jnp.asarray(n),
                                  jnp.asarray(_normal((5, 8, 3), 4))))
    want = JS.project_tangent_space_cells(jnp.asarray(gA), jnp.asarray(n),
                                          jnp.asarray(t))
    got = TS.project_tangent_space_cells(torch.from_numpy(gA),
                                         torch.from_numpy(n),
                                         torch.from_numpy(t))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("lerp", [1.0, 0.0])
def test_diffuse_cells_matches_jax(lerp):
    x, nrm, je, te = _sphere()
    A = np.zeros((N, 8), np.float32)
    A[:, 3] = np.random.default_rng(5).random(N)  # the alpha lane weighs
    t = np.array(JS.orthogonalize(jnp.asarray(nrm),
                                  jnp.asarray(_normal((N, 3), 6))))
    want = je.gather_back(JS.diffuse_cells(
        je, je.scatter(jnp.asarray(nrm)), je.scatter(jnp.asarray(t)),
        je.scatter(jnp.asarray(A)), lerp_multiplier=lerp))
    got = te.gather_back(TS.diffuse_cells(
        te, te.scatter(torch.from_numpy(nrm)), te.scatter(torch.from_numpy(t)),
        te.scatter(torch.from_numpy(A)), lerp_multiplier=lerp))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_rollout_mesh_cells_matches_jax():
    """tests/test_surface.py:140's rollout (8 channels, 32 hidden, a radial
    seed at point 0, tangents orthogonalized ones, 4 steps at fire_rate 1)
    through both packages' cell-engine surface rollouts."""
    x, nrm, je, te = _sphere()
    jcfg = JaxConfig(channels=8, hidden=32, normalize_perception=1.0 / H)
    jp = jax_init_params(jax.random.key(0), jcfg)
    jA0 = jax_add_radial_seed(jnp.asarray(x), jnp.zeros((N, 8)),
                              jnp.asarray(x)[0], 0.3)
    jt0 = jax.vmap(JS.orthogonalize)(jnp.asarray(nrm),
                                     jnp.ones((N, 3), jnp.float32))
    want_A, want_t, want_states = JS.rollout_mesh_cells(
        jp, jcfg, je, jA0, jnp.asarray(nrm), jt0, jax.random.key(1), 4, H,
        fire_rate=1.0, collect_all=True)

    cfg = SPHNCAConfig(channels=8, hidden=32, normalize_perception=1.0 / H)
    tp = params_from_jax_numpy(*(np.asarray(a) for a in jp), device="cpu")
    xt = torch.from_numpy(x)
    A0 = add_radial_seed(xt, torch.zeros(N, 8), xt[0], 0.3)
    np.testing.assert_allclose(A0.numpy(), np.asarray(jA0), atol=1e-7)
    t0 = torch.from_numpy(np.array(jt0))
    gen = torch.Generator().manual_seed(0)
    got_A, got_t, states = TS.rollout_mesh_cells(
        tp, cfg, te, A0, torch.from_numpy(nrm), t0, gen, 4, H,
        fire_rate=1.0, collect_all=True)
    assert states.shape == (5, N, 8)
    np.testing.assert_allclose(got_A.numpy(), np.asarray(want_A), atol=1e-4)
    np.testing.assert_allclose(got_t.numpy(), np.asarray(want_t), atol=1e-4)
    np.testing.assert_allclose(states.numpy(), np.asarray(want_states),
                               atol=1e-4)
    assert float(got_t.norm(dim=-1).max()) <= 1.0 + 1e-5  # unit or zero


def test_rollout_mesh_cells_needs_tables():
    x = JM.fibonacci_sphere(200, 0.8)
    eng = build_cell_engine(x, 0.3, device="cpu")
    cfg = SPHNCAConfig(channels=8, hidden=16)
    params = params_from_jax_numpy(
        *(np.zeros(s, np.float32) for s in ((24, 16), (16,), (16, 17), (17,))),
        device="cpu")
    z = torch.zeros(200, 3)
    with pytest.raises(ValueError, match="pair_tables"):
        TS.rollout_mesh_cells(params, cfg, eng, torch.zeros(200, 8), z, z,
                              torch.Generator(), 1, 0.3)


def test_meshes_match_jax():
    np.testing.assert_array_equal(TM.fibonacci_sphere(2000, 1.0),
                                  JM.fibonacci_sphere(2000, 1.0))
    x = JM.fibonacci_sphere(500)
    np.testing.assert_array_equal(TM.sphere_normals(x), JM.sphere_normals(x))
    for got, want in zip(TM.torus_points(700, seed=3),
                         JM.torus_points(700, seed=3)):
        np.testing.assert_array_equal(got, want)
    v = _normal((300, 3), 7) * 3.0 + 1.0
    np.testing.assert_array_equal(TM.normalize_mesh(v, 1.0),
                                  JM.normalize_mesh(v, 1.0))
    np.testing.assert_array_equal(TM.normalize_mesh(v, 0.5, axis_swap=False),
                                  JM.normalize_mesh(v, 0.5, axis_swap=False))


@pytest.mark.parametrize("cloud", ["sphere", "sphere2000", "torus",
                                   "random"])
def test_farthest_point_sampling_matches_jax(cloud):
    x = {"sphere": lambda: JM.fibonacci_sphere(3000, 1.0),
         "sphere2000": lambda: JM.fibonacci_sphere(2000, 1.0),  # near-ties
         "torus": lambda: JM.torus_points(2000, seed=1)[0],
         "random": lambda: _normal((1500, 3), 8)}[cloud]()
    want = np.asarray(JM.farthest_point_sampling(jnp.asarray(x), 24))
    got = TM.farthest_point_sampling(torch.from_numpy(x), 24)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)
    assert TM.farthest_point_sampling(torch.from_numpy(x), 5,
                                      start=7)[0] == 7


def test_surface_radial_seed_follows_the_jax_cli():
    """The JAX test CLI's radial surface seed (cli/test.py:204-213): radial
    seeds of the given radius at the farthest-point-sampled seeds, a unit
    tangent orthogonal to the normal at each seed and zero elsewhere (the
    tangent draws come from another generator)."""
    x = JM.fibonacci_sphere(2000, 1.0)
    nrm = JM.sphere_normals(x)
    sel = np.asarray(JM.farthest_point_sampling(jnp.asarray(x), 10))
    want = jnp.zeros((2000, 16))
    for i in sel:
        want = jax_add_radial_seed(jnp.asarray(x), want,
                                   jnp.asarray(x)[int(i)], 0.1)
    A0, t0 = surface_radial_seed(torch.from_numpy(x), torch.from_numpy(nrm),
                                 16, 10, 0.1, torch.Generator().manual_seed(0))
    np.testing.assert_allclose(A0.numpy(), np.asarray(want), atol=1e-6)
    norms = t0.norm(dim=-1).numpy()
    np.testing.assert_allclose(norms[sel], 1.0, atol=1e-5)
    assert np.all(np.delete(norms, sel) == 0)
    assert float((t0 * torch.from_numpy(nrm)).sum(-1).abs().max()) < 1e-5
