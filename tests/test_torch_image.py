"""Port parity: emoji targets, PNG frames, the metrics stream and
``trilinear_sample`` against the JAX package, and the test CLI's frames and
flags.

The port writes its PNGs with the standard library (the card's machine has
no PIL); decoded with PIL here, they equal the JAX package's PIL-written
files pixel for pixel. Emoji come from a cache of PNGs the tests write into
a temporary directory (nothing is downloaded); the JAX package reads its
cache path at import, so the tests patch ``NOTO_CACHE`` on its side and set
``$SPH_NCA_EMOJI_CACHE`` on the port's, which reads it at each call.
"""

import glob
import json
import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from PIL import Image

from sph_nca_tpu.utils import geometry as JG
from sph_nca_tpu.utils import image as JI
from sph_nca_tpu.utils.profiling import MetricsLogger as JaxMetricsLogger
from sph_nca_tpu_torch.cli import test as cli_test
from sph_nca_tpu_torch.cli import train as cli_train
from sph_nca_tpu_torch.utils import geometry as TG
from sph_nca_tpu_torch.utils import image as TI
from sph_nca_tpu_torch.utils.profiling import MetricsLogger

GECKO = os.path.join(os.path.dirname(__file__), "..", "sph_nca_tpu", "demo",
                     "web", "weights", "gecko.json")
EMOJI = "\U0001f98e"  # the lizard: emoji_u1f98e.png


@pytest.mark.parametrize("channels", [4, 3])
@pytest.mark.parametrize("layout", ["particles", "image"])
def test_png_frames_match_jax(tmp_path, channels, layout):
    """[N, C] particles (with the side given and derived) and [H, W, C]
    images, values beyond [0, 1] included."""
    rng = np.random.default_rng(channels)
    img = rng.uniform(-0.2, 1.2, (9, 9, channels)).astype(np.float32)
    arg = img.reshape(81, channels) if layout == "particles" else img
    for side in ((9, None) if layout == "particles" else (None,)):
        mine, theirs = tmp_path / "port.png", tmp_path / "jax.png"
        TI.save_frame_png(str(mine), arg, side=side)
        JI.save_frame_png(str(theirs), arg, side=side)
        got, want = Image.open(mine), Image.open(theirs)
        assert got.mode == want.mode == ("RGBA" if channels == 4 else "RGB")
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_png_encoder_round_trips_through_pil():
    rng = np.random.default_rng(1)
    for shape in ((5, 7), (5, 7, 1), (5, 7, 2), (6, 3, 3), (4, 4, 4)):
        img = rng.integers(0, 256, shape, dtype=np.uint8)
        import io

        got = np.asarray(Image.open(io.BytesIO(TI.encode_png(img))))
        np.testing.assert_array_equal(got.reshape(img.shape), img)
    with pytest.raises(ValueError, match="uint8"):
        TI.encode_png(np.zeros((2, 2, 3), np.float32))
    with pytest.raises(ValueError, match="channels"):
        TI.encode_png(np.zeros((2, 2, 5), np.uint8))


def _emoji_cache(tmp_path):
    """A cache holding the lizard: an RGBA PNG with a transparent border."""
    cache = tmp_path / "emoji"
    cache.mkdir()
    rng = np.random.default_rng(3)
    arr = rng.integers(0, 256, (72, 72, 4), dtype=np.uint8)
    arr[:6, :, 3] = 0
    Image.fromarray(arr, "RGBA").save(cache / "emoji_u1f98e.png")
    return cache


def test_load_emoji_matches_jax(tmp_path, monkeypatch):
    cache = _emoji_cache(tmp_path)
    monkeypatch.setenv("SPH_NCA_EMOJI_CACHE", str(cache))
    monkeypatch.setattr(JI, "NOTO_CACHE", str(cache))
    assert TI.emoji_path(EMOJI) == str(cache / "emoji_u1f98e.png")
    for premultiply in (True, False):
        got = TI.load_emoji(EMOJI, 40, premultiply)
        np.testing.assert_array_equal(got, JI.load_emoji(EMOJI, 40,
                                                         premultiply))
        assert got.shape == (40, 40, 4)
    for mod in (TI, JI):
        with pytest.raises(FileNotFoundError, match="not cached"):
            mod.load_emoji("\U0001f600")


def test_train_cli_target_loads_the_emoji(tmp_path, monkeypatch):
    """``--target`` resolves through the cache into the MSE target, as the
    JAX CLI's does: the port's first loss equals the one it gives with the
    same target written as an ``.npy`` image; a missing emoji raises before
    anything is written."""
    cache = _emoji_cache(tmp_path)
    monkeypatch.setenv("SPH_NCA_EMOJI_CACHE", str(cache))
    straight = JI.load_image(str(cache / "emoji_u1f98e.png"), 8, False)
    np.save(tmp_path / "target.npy", straight)
    common = ["--device", "cpu", "--image_size", "12", "--target_size", "8",
              "--h", "0.3", "--batch_size", "2", "--pool_size", "4",
              "--steps_range", "2,3", "--steps_increment", "1", "--hidden",
              "16", "--training_iter", "1", "--save_resume", "false"]
    losses = {}
    for label, flag in (("emoji", ["--target", EMOJI]),
                        ("npy", ["--img", str(tmp_path / "target.npy")])):
        out = tmp_path / label
        assert cli_train.main(common + flag + ["--output_dir", str(out)]) == 0
        (path,) = glob.glob(str(out / "metrics-*.jsonl"))
        with open(path) as f:
            losses[label] = json.loads(f.readline())["loss"]
    assert losses["emoji"] == losses["npy"]
    with pytest.raises(FileNotFoundError, match="not cached"):
        cli_train.main(common + ["--target", "\U0001f600", "--output_dir",
                                 str(tmp_path / "missing")])
    assert not os.path.exists(tmp_path / "missing")


def test_metrics_stream_carries_jax_keys(tmp_path, monkeypatch):
    """The port's logger writes the JAX logger's record (step, t and the
    metrics as floats) and keeps Python ints as ints."""
    rows = []
    for cls, name in ((MetricsLogger, "port"), (JaxMetricsLogger, "jax")):
        path = str(tmp_path / f"{name}.jsonl")
        m = cls(path)
        m.log(3, loss=np.float32(0.25), it_per_sec=2.0, rss_gb=1.5)
        m.close()
        m.log(4, loss=1.0)  # closed: nothing more
        with open(path) as f:
            rows.append([json.loads(line) for line in f])
    (got,), (want,) = rows
    assert got.keys() == want.keys() == {"step", "t", "loss", "it_per_sec",
                                         "rss_gb"}
    assert {k: got[k] for k in got if k != "t"} == {
        k: want[k] for k in want if k != "t"}
    m = MetricsLogger(str(tmp_path / "ints.jsonl"))
    m.log(0, iter=0, steps=7, loss=torch.tensor(0.5), flag=True, tag="x")
    m.close()
    with open(tmp_path / "ints.jsonl") as f:
        row = json.loads(f.readline())
    assert row["steps"] == 7 and isinstance(row["steps"], int)
    assert row["loss"] == 0.5 and row["flag"] == 1.0 and row["tag"] == "x"
    MetricsLogger(None).log(0, loss=1.0)


def test_train_cli_metrics_rows_carry_jax_keys(tmp_path):
    assert cli_train.main([
        "--device", "cpu", "--image_size", "12", "--target_size", "8",
        "--h", "0.3", "--batch_size", "2", "--pool_size", "4",
        "--steps_range", "2,3", "--steps_increment", "1", "--hidden", "16",
        "--training_iter", "3", "--log_every", "2", "--save_resume",
        "false", "--output_dir", str(tmp_path)]) == 0
    (path,) = glob.glob(str(tmp_path / "metrics-*.jsonl"))
    with open(path) as f:
        rows = [json.loads(line) for line in f]
    assert [r["step"] for r in rows] == [r["iter"] for r in rows] == [0, 1, 2]
    for r in rows:
        assert {"step", "t", "loss", "it_per_sec", "rss_gb", "iter", "steps",
                "seconds"} == set(r)
        assert r["it_per_sec"] > 0 and np.isfinite(r["loss"])


@pytest.mark.parametrize("value_shape", [(), (4,)])
def test_trilinear_sample_matches_jax(value_shape):
    rng = np.random.default_rng(5)
    grid = rng.normal(size=(5, 6, 7) + value_shape).astype(np.float32)
    p = rng.uniform(-1.3, 1.3, (50, 3)).astype(np.float32)
    gmin, gsize = (-1.0, -1.0, -1.0), (2.0, 2.0, 2.0)
    got = TG.trilinear_sample(torch.from_numpy(p), torch.from_numpy(grid),
                              gmin, gsize).numpy()
    want = np.asarray(JG.trilinear_sample(jnp.asarray(p), jnp.asarray(grid),
                                          jnp.asarray(gmin),
                                          jnp.asarray(gsize)))
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("every", [1, 2])
def test_test_cli_writes_png_frames(tmp_path, every):
    """Image mode writes ``{i:04d}.png`` every ``--export_every`` states
    beside states.npz: RGBA for the gecko (alpha), each frame the JAX
    package's PNG of that state."""
    from sph_nca_tpu.models.nca import to_rgba as jax_to_rgba

    assert cli_test.main(["--weights_json", GECKO, "--image_size", "16",
                          "--steps", "3", "--export_every", str(every),
                          "--device", "cpu", "--output_dir",
                          str(tmp_path)]) == 0
    (run,) = os.listdir(tmp_path)
    run = tmp_path / run
    with np.load(run / "states.npz") as z:
        states = z["states"]
    names = sorted(p.name for p in run.glob("*.png"))
    assert names == [f"{i:04d}.png" for i in range(0, 4, every)]
    for name in names:
        i = int(name[:4])
        got = Image.open(run / name)
        assert got.mode == "RGBA" and got.size == (16, 16)
        JI.save_frame_png(str(tmp_path / "want.png"), np.asarray(
            jax_to_rgba(jnp.asarray(states[i]), True)), side=16)
        np.testing.assert_array_equal(np.asarray(got), np.asarray(
            Image.open(tmp_path / "want.png")))


def test_test_cli_accepts_nca_update(tmp_path):
    """``--nca_update`` parses as the JAX CLI's does and changes nothing:
    the model's rule is its weights'."""
    p = cli_test.build_parser()
    for rule in ("orig", "gated"):
        args = p.parse_args(["--output_dir", "o", "--nca_update", rule])
        assert args.nca_update == rule
    assert p.parse_args(["--output_dir", "o"]).nca_update == "gated"
    with pytest.raises(SystemExit):
        p.parse_args(["--output_dir", "o", "--nca_update", "other"])
    runs = {}
    for rule in ("orig", "gated"):
        out = tmp_path / rule
        assert cli_test.main(["--weights_json", GECKO, "--image_size", "16",
                              "--steps", "2", "--nca_update", rule,
                              "--device", "cpu", "--output_dir",
                              str(out)]) == 0
        (run,) = os.listdir(out)
        with np.load(out / run / "states.npz") as z:
            runs[rule] = z["states"]
    np.testing.assert_array_equal(runs["orig"], runs["gated"])
