"""Port parity: ``eval.py`` (image metrics, the density sweep, texture
statistics), the ``.npy`` targets and assets, and the texture path through
the three CLIs, against the JAX package on the CPU.

Tolerances. The metrics are the JAX package's numpy code in float64: 1e-12.
``rollout_on_points`` at fire_rate 1 (the fire draws do not matter): 1e-4 of
the largest |rgba| (float32 sums in another order over 8 steps). The
density sweep at fire_rate 1: PSNR to 1e-3 dB, SSIM to 1e-5. The texture
baselines: 1e-6 (their blur goes through a float32 resize). Targets read
from the assets: bit-equal to the JAX loader's output from the PNGs.
"""

import glob
import json
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from sph_nca_tpu import eval as JE
from sph_nca_tpu.models import SPHNCAConfig as JaxConfig
from sph_nca_tpu.models import init_params as jax_init
from sph_nca_tpu.utils.image import load_image as jax_load_image
from sph_nca_tpu_torch import eval as TE
from sph_nca_tpu_torch.cli import eval as cli_eval
from sph_nca_tpu_torch.cli import test as cli_test
from sph_nca_tpu_torch.cli import train as cli_train
from sph_nca_tpu_torch.io.convert import params_from_jax_numpy
from sph_nca_tpu_torch.models.nca import SPHNCAConfig
from sph_nca_tpu_torch.utils.image import load_image

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ASSETS = os.path.join(ROOT, "sph_nca_tpu_torch", "assets")
METRIC_ATOL = 1e-12
ROLLOUT_RTOL = 1e-4
PSNR_ATOL = 1e-3
SSIM_ATOL = 1e-5
BASELINE_ATOL = 1e-6


def _model(h, seed=0, use_alpha=True):
    kw = dict(channels=8, hidden=32, fire_rate=1.0, use_alpha=use_alpha,
              normalize_perception=1.0 / h)
    jcfg, cfg = JaxConfig(**kw), SPHNCAConfig(**kw)
    jp = jax_init(jax.random.key(seed), jcfg)
    return jcfg, jp, cfg, params_from_jax_numpy(
        *(np.asarray(a) for a in jp), device="cpu")


def test_metrics_match_jax():
    rng = np.random.default_rng(0)
    a = rng.random((20, 24, 4)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.1, a.shape), 0, 1).astype(np.float32)
    x = rng.uniform(-1.2, 1.2, (500, 2)).astype(np.float32)
    v = rng.random((500, 4)).astype(np.float32)
    pairs = [
        (TE.psnr(a, b), JE.psnr(a, b)),
        (TE.ssim(a, b), JE.ssim(a, b)),
        (TE.ssim(a[..., 0], b[..., 0]), JE.ssim(a[..., 0], b[..., 0])),
        (TE.render_points(x, v, 16), JE.render_points(x, v, 16)),
        (TE.render_points(x, v, 9, gmin=(-0.5, -0.5), gsize=(1.0, 1.0)),
         JE.render_points(x, v, 9, gmin=(-0.5, -0.5), gsize=(1.0, 1.0))),
        (TE.radial_power_spectrum(a), JE.radial_power_spectrum(a)),
        (TE.color_histogram(b), JE.color_histogram(b)),
    ]
    for got, want in pairs:
        np.testing.assert_allclose(got, want, atol=METRIC_ATOL, rtol=0)
    got, want = TE.texture_stats_distance(a, b), JE.texture_stats_distance(a, b)
    assert got.keys() == want.keys()
    for k in got:
        assert abs(got[k] - want[k]) <= METRIC_ATOL
    assert TE.psnr(a, a) == float("inf")


def test_rollout_on_points_matches_jax():
    """An irregular point set (a jittered 16x16 grid), the radial seed, 8
    steps at fire_rate 1."""
    h = 0.3
    jcfg, jp, cfg, tp = _model(h, use_alpha=False)
    jit = np.random.default_rng(1).uniform(-0.04, 0.04, (256, 2))
    grid = np.stack(np.meshgrid(np.linspace(-0.94, 0.94, 16),
                                np.linspace(-0.94, 0.94, 16),
                                indexing="ij"), -1).reshape(-1, 2)
    x2 = (grid + jit).astype(np.float32)
    want = JE.rollout_on_points(jp, jcfg, jnp.asarray(x2), h, 8,
                                jax.random.key(0), seed_radius=0.5)
    got = TE.rollout_on_points(tp, cfg, x2, h, 8,
                               torch.Generator().manual_seed(0),
                               seed_radius=0.5)
    assert got.shape == (256, 4) and np.isfinite(got).all()
    gap = np.abs(got - want).max() / np.abs(want).max()
    assert gap <= ROLLOUT_RTOL
    assert np.abs(want[:, :3]).max() > 0.05  # the seed grew


def test_density_sweep_matches_jax():
    """Base 12, densities 1 and 2, jittered, 4 steps at fire_rate 1; the
    target fills the centre half of the domain, so each render is resized
    (8 -> 16 pixels) before the comparison."""
    h = 0.3
    jcfg, jp, cfg, tp = _model(h, seed=3)
    target = np.random.default_rng(2).random((16, 16, 4)).astype(np.float32)
    kw = dict(base_size=12, densities=(1.0, 2.0), steps=4, jitter=0.2,
              seed=5, image_scale=0.5, seed_radius=0.6)
    want = JE.density_sweep(jp, jcfg, h, target, **kw)
    got = TE.density_sweep(tp, cfg, h, target, device="cpu", **kw)
    assert [r["n_particles"] for r in got] == [144, 289]
    for g, w in zip(got, want):
        assert g["density"] == w["density"]
        assert g["n_particles"] == w["n_particles"]
        assert abs(g["psnr"] - w["psnr"]) <= PSNR_ATOL
        assert abs(g["ssim"] - w["ssim"]) <= SSIM_ATOL


@pytest.mark.parametrize("exemplar", ["dotted", "random"])
def test_texture_baselines_match_jax(exemplar):
    if exemplar == "dotted":
        ex = load_image(os.path.join(ASSETS, "dotted_synth_64.npy"))[..., :3]
    else:
        ex = np.random.default_rng(4).random((40, 36, 3)).astype(np.float32)
    jcfg, jp, _, tp = _model(0.3)
    want = JE.texture_eval(jp, jcfg, 0.3, ex, densities=())
    got = TE.texture_baselines(ex)
    assert want.pop("sweep") == []
    assert got.keys() == want.keys()
    for k in got:
        for stat in ("spectrum_l1", "color_l1"):
            assert abs(got[k][stat] - want[k][stat]) <= BASELINE_ATOL
    if exemplar == "dotted":
        with open(os.path.join(ROOT, "runs", "ot_gabor_dotted",
                               "texture_eval_800.json")) as f:
            recorded = json.load(f)
        for k in got:
            for stat in ("spectrum_l1", "color_l1"):
                assert abs(got[k][stat] - recorded[k][stat]) <= BASELINE_ATOL


@pytest.mark.parametrize("asset,png", [
    ("dotted_synth_64.npy", "runs/data/dotted_synth.png"),
    ("face_target_64.npy", "artifacts/train_target_face.png")])
def test_target_assets_equal_the_jax_loader(asset, png):
    for premultiply in (True, False):
        got = load_image(os.path.join(ASSETS, asset), 64, premultiply)
        want = jax_load_image(os.path.join(ROOT, png), 64, premultiply)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)


def test_npy_targets(tmp_path):
    """RGB is padded to alpha 1, RGBA premultiplied; a target larger than
    max_size, of another shape or dtype, or outside [0, 1] is refused."""
    rng = np.random.default_rng(0)
    rgba = rng.random((10, 12, 4)).astype(np.float32)
    np.save(tmp_path / "rgba.npy", rgba)
    np.save(tmp_path / "rgb.npy", rgba[..., :3])
    got = load_image(str(tmp_path / "rgba.npy"), 12)
    np.testing.assert_array_equal(got[..., :3], rgba[..., :3] * rgba[..., 3:])
    np.testing.assert_array_equal(
        load_image(str(tmp_path / "rgba.npy"), 12, False), rgba)
    got = load_image(str(tmp_path / "rgb.npy"), 16)
    assert (got[..., 3] == 1).all() and got.shape == (10, 12, 4)
    with pytest.raises(ValueError, match="not resized"):
        load_image(str(tmp_path / "rgba.npy"), 8)
    for bad in (rgba[..., :2], rgba.astype(np.float64), rgba + 1.0):
        np.save(tmp_path / "bad.npy", bad)
        with pytest.raises(ValueError):
            load_image(str(tmp_path / "bad.npy"), 16)


# ---- the texture path through the CLIs ------------------------------------------


@pytest.fixture
def one_thread():
    """The CLIs run on one intra-op thread: the suite runs several worker
    processes at once, and torch's thread pools oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def texture_checkpoint(tmp_path_factory):
    """A 2-iteration OT training run of the train CLI: its checkpoint."""
    out = tmp_path_factory.mktemp("train")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    rc = cli_train.main([
        "--device", "cpu", "--loss", "ot", "--texture_features",
        "vgg_random", "--wrap", "true", "--use_alpha", "false",
        "--initial_feature", "random", "--img",
        os.path.join(ASSETS, "dotted_synth_64.npy"), "--image_size", "16",
        "--h", "0.25", "--training_iter", "2", "--checkpoint_every", "2",
        "--batch_size", "2", "--pool_size", "4", "--steps_range", "2,3",
        "--steps_increment", "1", "--hidden", "16", "--log_every", "1",
        "--output_dir", str(out)])
    torch.set_num_threads(n)
    assert rc == 0
    (ck,) = glob.glob(str(out / "sphnca-*-0002"))
    assert os.path.exists(os.path.join(ck, "resume.npz"))
    return ck


def test_test_cli_reads_a_texture_checkpoint(texture_checkpoint, tmp_path,
                                             monkeypatch, one_thread):
    """The checkpoint's texture mode gives a periodic plane, no alpha and the
    random seed (uniform features), in image and surface mode."""
    import sph_nca_tpu_torch.ops.bands as bands_mod
    from scipy.spatial import ConvexHull

    from sph_nca_tpu.utils.meshes import fibonacci_sphere

    periods = []
    build = bands_mod.build_band_engine

    def spy(*a, **k):
        periods.append(k.get("period"))
        return build(*a, **k)

    monkeypatch.setattr(bands_mod, "build_band_engine", spy)
    out = tmp_path / "image"
    assert cli_test.main(["--checkpoint", texture_checkpoint, "--device",
                          "cpu", "--image_size", "16", "--steps", "2",
                          "--output_dir", str(out)]) == 0
    assert periods == [[2.0, 2.0, 2.0]]
    (run,) = os.listdir(out)
    with np.load(out / run / "states.npz") as z:
        states = z["states"]
    assert states.shape == (3, 256, 16) and np.isfinite(states).all()
    assert (0 <= states[0]).all() and (states[0] < 1).all()
    assert states[0].std() > 0.2

    v = fibonacci_sphere(162, 1.0)
    obj = tmp_path / "sphere.obj"
    with open(obj, "w") as f:
        f.writelines(f"v {a:.6f} {b:.6f} {c:.6f}\n" for a, b, c in v)
        f.writelines(f"f {i + 1} {j + 1} {k + 1}\n"
                     for i, j, k in ConvexHull(v).simplices)
    out = tmp_path / "surface"
    assert cli_test.main(["--checkpoint", texture_checkpoint, "--device",
                          "cpu", "--surface", str(obj),
                          "--surface_numpoints", "200", "--steps", "2",
                          "--output_dir", str(out)]) == 0
    (run,) = os.listdir(out)
    with np.load(out / run / "states.npz") as z:
        assert z["states"].shape == (3, 200, 16)
        assert np.isfinite(z["states"]).all() and z["states"][0].std() > 0.2
    with pytest.raises(SystemExit, match="need --checkpoint or"):
        cli_test.main(["--device", "cpu", "--output_dir", str(tmp_path)])


def test_eval_cli_reads_a_texture_checkpoint(texture_checkpoint, tmp_path,
                                             one_thread):
    """Texture mode and the density study on the trained checkpoint, with
    the geometry recorded in its meta (the exemplar's path too)."""
    out = tmp_path / "texture.json"
    assert cli_eval.main(["--checkpoint", texture_checkpoint, "--device",
                          "cpu", "--texture", "true", "--steps", "2",
                          "--densities", "1", "--out", str(out)]) == 0
    res = json.loads(out.read_text())
    assert [(r["density"], r["jitter"]) for r in res["sweep"]] == [
        (1.0, 0.0), (1.0, 0.5)]
    for r in res["sweep"]:
        assert 0 <= r["spectrum_l1"] <= 2 and 0 <= r["color_l1"] <= 2
    assert abs(res["baseline_gray"]["spectrum_l1"] - 1.0) < 1e-9
    out = tmp_path / "sweep.json"
    assert cli_eval.main(["--checkpoint", texture_checkpoint, "--device",
                          "cpu", "--steps", "2", "--densities", "0.5,1",
                          "--out", str(out)]) == 0
    rows = json.loads(out.read_text())
    assert [r["n_particles"] for r in rows] == [121, 256]
    assert all(np.isfinite(r["psnr"]) and -1 <= r["ssim"] <= 1
               for r in rows)
    with pytest.raises(SystemExit, match="need --img"):
        cli_eval.main(["--weights_json", texture_checkpoint + ".json",
                       "--device", "cpu"])


def test_train_cli_needs_vgg_weights(tmp_path):
    """--texture_features vgg without --vgg_weights raises, as the JAX
    package's get_texture_features does, before anything is written."""
    with pytest.raises(ValueError, match="requires weights_path"):
        cli_train.main(["--device", "cpu", "--loss", "ot",
                        "--texture_features", "vgg", "--image_size", "8",
                        "--h", "0.5", "--output_dir", str(tmp_path / "o")])
    assert not (tmp_path / "o").exists()
