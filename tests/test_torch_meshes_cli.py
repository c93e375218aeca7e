"""Port parity: the mesh utilities (OBJ loading, normals, surface sampling,
PLY files), the random seeds (``plane_seed(randomized=True)``, the random
surface seed) and the test CLI's 3D surface mode and random initial feature,
against the JAX package.

The mesh functions are numpy in both packages and must agree bit for bit on a
procedural OBJ that the tests write (quads, ``v/vt/vn`` and ``v//vn`` faces,
negative indices); PLY files round-trip between the two packages. The CLI
runs on the CPU (``--device cpu``), where every kernel wrapper runs its plain
version; its PLYs must read back through the JAX package's
``load_ply_points``, as ``tests/test_cli.py``'s surface test (which needs a
mesh file the repo does not hold) reads the JAX CLI's.
"""

import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from sph_nca_tpu.utils import meshes as JM
from sph_nca_tpu_torch.cli import test as cli_test
from sph_nca_tpu_torch.utils import meshes as TM
from sph_nca_tpu_torch.utils.seeds import plane_seed, surface_random_seed

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WEIGHTS = os.path.join(ROOT, "sph_nca_tpu", "demo", "web", "weights")
GECKO = os.path.join(WEIGHTS, "gecko.json")
STRIPES = os.path.join(WEIGHTS, "stripes.json")


def write_obj(path, nu=24, nv=12):
    """An ellipsoid as an OBJ: quad bands with ``v/vt/vn`` entries,
    triangle caps (one with ``v//vn``, one with negative indices), a
    pentagon fan over the first band and comment and blank lines."""
    verts = [(0.0, 0.9, 0.0), (0.0, -0.9, 0.0)]
    for j in range(1, nv):
        th = np.pi * j / nv
        for i in range(nu):
            ph = 2 * np.pi * i / nu
            verts.append((1.3 * np.sin(th) * np.cos(ph), 0.9 * np.cos(th),
                          np.sin(th) * np.sin(ph)))
    lines = ["# procedural ellipsoid", ""]
    lines += [f"v {a:.6f} {b:.6f} {c:.6f}" for a, b, c in verts]
    lines += ["vt 0 0", "vn 0 1 0"]

    def ring(j, i):  # 1-based index of band j, column i
        return 3 + j * nu + i % nu

    for j in range(nv - 2):
        for i in range(nu):
            quad = (ring(j, i), ring(j, i + 1), ring(j + 1, i + 1),
                    ring(j + 1, i))
            lines.append("f " + " ".join(f"{k}/1/1" for k in quad))
    n = len(verts)
    for i in range(nu):
        lines.append(f"f 1//1 {ring(0, i + 1)}//1 {ring(0, i)}//1")
        a, b = ring(nv - 2, i), ring(nv - 2, i + 1)
        lines.append(f"f {2 - n - 1} {a - n - 1} {b - n - 1}")
    lines.append("f " + " ".join(str(ring(0, i)) for i in range(5)))
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return path


@pytest.fixture(scope="module")
def obj_path(tmp_path_factory):
    return write_obj(str(tmp_path_factory.mktemp("mesh") / "ellipsoid.obj"))


def test_mesh_functions_bit_equal_to_jax(obj_path):
    v, f = TM.load_obj(obj_path)
    jv, jf = JM.load_obj(obj_path)
    assert v.dtype == np.float32 and f.dtype == np.int32
    np.testing.assert_array_equal(v, jv)
    np.testing.assert_array_equal(f, jf)
    assert f.shape[0] == 10 * 24 * 2 + 2 * 24 + 3  # quads split, the fan
    assert f.min() >= 0 and f.max() < v.shape[0]
    v = TM.normalize_mesh(v, 0.9)
    np.testing.assert_array_equal(v, JM.normalize_mesh(jv, 0.9))
    for got, want in zip(TM.face_normals_areas(v, f),
                         JM.face_normals_areas(v, f)):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(TM.vertex_normals(v, f),
                                  JM.vertex_normals(v, f))
    got = TM.sample_surface(v, f, 3000, np.random.default_rng(4))
    want = JM.sample_surface(v, f, 3000, np.random.default_rng(4))
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    for g, w in zip(TM.sample_surface(v, f, 50),
                    JM.sample_surface(v, f, 50)):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("channels", [3, 4])
def test_ply_round_trips_between_packages(tmp_path, channels):
    rng = np.random.default_rng(5)
    pts = rng.normal(size=(257, 3)).astype(np.float32)
    rgba = rng.uniform(-0.2, 1.2, (257, channels)).astype(np.float32)
    TM.save_ply(str(tmp_path / "t.ply"), pts, rgba)
    JM.save_ply(str(tmp_path / "j.ply"), pts, rgba)
    assert ((tmp_path / "t.ply").read_bytes()
            == (tmp_path / "j.ply").read_bytes())
    for load in (JM.load_ply_points, TM.load_ply_points):
        p, c = load(str(tmp_path / "t.ply"))
        np.testing.assert_array_equal(p, pts)
        assert c.dtype == np.uint8 and c.shape == (257, 4)
        if channels == 3:
            assert np.all(c[:, 3] == 255)
    p, c = TM.load_ply_points(str(tmp_path / "j.ply"))
    np.testing.assert_array_equal(c, JM.load_ply_points(
        str(tmp_path / "j.ply"))[1])
    u8 = (rng.uniform(0, 1, (257, 4)) * 255).astype(np.uint8)
    TM.save_ply(str(tmp_path / "u.ply"), pts, u8)
    np.testing.assert_array_equal(
        JM.load_ply_points(str(tmp_path / "u.ply"))[1], u8)


def test_cli_surface_points_match_jax(obj_path):
    """The CLI's points and normals equal the JAX CLI's
    (sph_nca_tpu/cli/test.py:154-166) for the same seed."""
    n_pts, scale, seed = 300, 0.8, 3
    rng = np.random.default_rng(seed)
    v, f = JM.load_obj(obj_path)
    v = JM.normalize_mesh(v, scale)
    vn = JM.vertex_normals(v, f)
    pts, fi, w = JM.sample_surface(v, f, n_pts * 8, rng)
    nrm = np.einsum("nc,ncd->nd", w, vn[f[fi]])
    nrm /= np.maximum(np.linalg.norm(nrm, axis=-1, keepdims=True), 1e-20)
    sel = np.asarray(JM.farthest_point_sampling(jnp.asarray(pts), n_pts))
    trng = np.random.default_rng(seed)
    x, n, secs = cli_test.surface_points(obj_path, scale, n_pts, trng, "cpu")
    np.testing.assert_array_equal(x, pts[sel])
    np.testing.assert_array_equal(n, nrm[sel])
    assert x.dtype == n.dtype == np.float32 and secs >= 0
    # the generator is left where the JAX CLI's is (the random seed draws
    # its points from it next)
    assert trng.integers(1 << 30) == rng.integers(1 << 30)


def test_plane_seed_random():
    x = torch.rand(50, 2)
    a = plane_seed(x, 16, gmin=(-1, -1), gsize=(2, 2), radius=0.1,
                   randomized=True, generator=torch.Generator().manual_seed(3))
    b = plane_seed(x, 16, gmin=(-1, -1), gsize=(2, 2), radius=0.1,
                   randomized=True, generator=torch.Generator().manual_seed(3))
    assert a.shape == (50, 16) and torch.equal(a, b)
    assert float(a.min()) >= 0.0 and float(a.max()) < 1.0
    assert float(a.std()) > 0.2
    with pytest.raises(ValueError, match="generator"):
        plane_seed(x, 16, gmin=(-1, -1), gsize=(2, 2), radius=0.1,
                   randomized=True)


def test_surface_random_seed_draws_like_the_jax_cli():
    """The seeded points are the JAX CLI's ``rng.integers`` draws, each a
    unit tangent orthogonal to its normal (before the pre-diffusion); the
    features are uniform; the passes spread the field orthogonal to the
    normals, unit vectors where it has mass (a normalization by 1e-8 + |t|
    shortens the faintest, at its edge)."""
    from sph_nca_tpu_torch.ops.cells import build_cell_engine

    x = TM.fibonacci_sphere(400, 1.0)
    n = TM.sphere_normals(x)
    eng = build_cell_engine(x, 0.2, pair_tables="float32", w6_only=True,
                            device="cpu")
    want = np.random.default_rng(7)
    picks = {int(want.integers(400)) for _ in range(10)}
    A, t = surface_random_seed(torch.from_numpy(x), torch.from_numpy(n), 16,
                               np.random.default_rng(7),
                               torch.Generator().manual_seed(0), eng, 0)
    assert set(np.flatnonzero(t.norm(dim=-1).numpy() > 0)) == picks
    assert A.shape == (400, 16) and 0.0 <= float(A.min())
    assert float(A.max()) < 1.0
    _, t = surface_random_seed(torch.from_numpy(x), torch.from_numpy(n), 16,
                               np.random.default_rng(7),
                               torch.Generator().manual_seed(0), eng, 5)
    norms = t.norm(dim=-1).numpy()
    spread = norms > 0
    assert spread.sum() > 4 * len(picks)
    assert norms.max() <= 1.0 + 1e-5
    np.testing.assert_allclose(norms[sorted(picks)], 1.0, atol=1e-5)
    assert float((t * torch.from_numpy(n)).sum(-1).abs().max()) < 1e-5


def _run(tmp_path, weights, *extra):
    out = tmp_path / "out"
    rc = cli_test.main(["--weights_json", weights, "--device", "cpu",
                        "--output_dir", str(out)] + list(extra))
    assert rc == 0
    (run,) = os.listdir(out)
    return out / run


@pytest.mark.parametrize("weights,extra", [
    (GECKO, []),  # an image model: radial seeds, one engine
    (STRIPES, []),  # a texture model: the random seed
    (STRIPES, ["--h", "0.12"]),  # h != 0.1: the diffusion on a second engine
], ids=["gecko-radial", "stripes-random", "stripes-dual"])
def test_cli_surface_mode(tmp_path, obj_path, weights, extra):
    run = _run(tmp_path, weights, "--surface", obj_path,
               "--surface_numpoints", "600", "--surface_numseed", "3",
               "--steps", "3", *extra)
    with np.load(run / "states.npz") as z:
        x, states = z["x"], z["states"]
    assert x.shape == (600, 3) and states.shape == (4, 600, 16)
    assert np.isfinite(states).all()
    assert np.abs(x).max() <= 1.0 + 1e-5  # the normalized mesh
    plys = sorted(f for f in os.listdir(run) if f.endswith(".ply"))
    assert plys == [f"{i:04d}.ply" for i in range(4)]
    for i, name in enumerate(plys):
        pts, rgba = JM.load_ply_points(str(run / name))
        np.testing.assert_array_equal(pts, x)
        want = np.clip(states[i][:, :3], 0, 1)
        np.testing.assert_allclose(rgba[:, :3] / 255.0, want, atol=1 / 254)
    if weights == GECKO:  # radial seeds: most points start at 0
        assert (np.abs(states[0]).max(-1) > 0).mean() < 0.5
    else:  # uniform random features
        assert states[0].min() >= 0.0 and states[0].max() < 1.0
        assert (np.abs(states[0]).max(-1) > 0).all()


def test_cli_surface_export_every(tmp_path, obj_path):
    run = _run(tmp_path, GECKO, "--surface", obj_path, "--surface_numpoints",
               "300", "--steps", "4", "--export_every", "3")
    assert sorted(f for f in os.listdir(run) if f.endswith(".ply")) == [
        "0000.ply", "0003.ply"]


def test_cli_surface_raises_without_card(tmp_path, obj_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli_test.main(["--weights_json", STRIPES, "--surface", obj_path,
                       "--output_dir", str(tmp_path)])
    assert os.listdir(tmp_path) == []


def test_cli_stripes_image_mode_random_init(tmp_path):
    """A texture model in image mode: no alpha, a periodic plane (the
    derived --wrap) and uniform random initial features."""
    run = _run(tmp_path, STRIPES, "--image_size", "16", "--steps", "2")
    with np.load(run / "states.npz") as z:
        states = z["states"]
    assert states.shape == (3, 256, 16) and np.isfinite(states).all()
    assert states[0].min() >= 0.0 and states[0].max() < 1.0
    assert float(states[0].std()) > 0.2
    assert not np.array_equal(states[-1], states[0])
    run2 = _run(tmp_path / "again", STRIPES, "--image_size", "16", "--steps",
                "2")
    with np.load(run2 / "states.npz") as z:
        np.testing.assert_array_equal(z["states"], states)  # seeded
