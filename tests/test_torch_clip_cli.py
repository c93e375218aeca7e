"""Port parity: the train CLI in CLIP mode (``--loss clip_multiscale``)
against the JAX CLI on the CPU, from the same initial parameters at
fire_rate 1, with the prompt encoded by each package's text tower or given
as text features (``--clip_text_embed``).

Tolerance: the losses to 1e-3 of their value, as the MSE and graph CLI
parity tests (``tests/test_torch_train.py``): float32 rollouts and towers in
other orders, then Adam's first steps, which are ~lr * sign(g).
"""

import functools
import glob
import json
import os

import numpy as np
import jax
import pytest
import torch

from sph_nca_tpu.training import clip_text as JT

CLI_LOSS_RTOL = 1e-3


# ---- the train CLI in CLIP mode -----------------------------------------------


def _fire_rate_one(cls, **kw):
    return cls(**{**kw, "fire_rate": 1.0})


@pytest.fixture(scope="module")
def jax_clip_run(tmp_path_factory):
    """The JAX CLI in CLIP mode from a JAX checkpoint at fire_rate 1: its
    losses by iteration, its text features (saved as a .npy) and the
    common arguments."""
    import sph_nca_tpu.models as jax_models
    from sph_nca_tpu.cli import train as jax_cli
    from sph_nca_tpu.io.checkpoint import save_checkpoint as jax_save
    from sph_nca_tpu.models import SPHNCAConfig as JaxConfig
    from sph_nca_tpu.models import init_params as jax_init

    tmp = tmp_path_factory.mktemp("clip_cli")
    h = 0.3
    jcfg = JaxConfig(hidden=16, fire_rate=1.0, normalize_perception=1 / h)
    jax_save(str(tmp / "init"), params=jax_init(jax.random.key(3), jcfg),
             model_cfg=jcfg, h=h, step=0)
    common = ["--loss", "clip_multiscale", "--image_size", "12",
              "--target_size", "8", "--h", str(h), "--batch_size", "2",
              "--pool_size", "4", "--steps_range", "2,4", "--steps_increment",
              "1", "--hidden", "16", "--log_every", "1",
              "--clip_multiscale_scales", "1", "--checkpoint_every", "1000",
              "--save_resume", "false", "--pretrained_checkpoint",
              str(tmp / "init")]
    guide = ["--clip_guide", "a red and yellow spiral"]
    mp = pytest.MonkeyPatch()
    mp.setattr(jax_models, "SPHNCAConfig",
               functools.partial(_fire_rate_one, jax_models.SPHNCAConfig))
    try:
        # the JAX CLI runs iterations 0 .. --training_iter
        assert jax_cli.main(common + guide + [
            "--training_iter", "2", "--platform", "cpu", "--output_dir",
            str(tmp / "jax")]) == 0
    finally:
        mp.undo()
    (path,) = glob.glob(str(tmp / "jax" / "metrics-*.jsonl"))
    with open(path) as f:
        losses = {r["step"]: r["loss"] for r in map(json.loads, f)}
    embed = str(tmp / "text.npy")
    np.save(embed, np.asarray(JT.get_text_features(guide[1])))
    return losses, embed, common, guide, tmp


@pytest.mark.parametrize("source", ["clip_guide", "clip_text_embed"])
def test_train_cli_clip_matches_jax(jax_clip_run, monkeypatch, source):
    """The port's CLI in CLIP mode (default band engine, scale 1) from
    the JAX checkpoint's parameters at fire_rate 1: the JAX CLI's losses,
    with the prompt encoded by the port's text tower or given as the JAX
    package's text features; the metrics rows carry the JAX CLI's keys, and
    the checkpoint's mode is texture, as in JAX."""
    import sph_nca_tpu_torch.models.nca as port_nca
    from sph_nca_tpu_torch.cli import train as cli_train

    want, embed, common, guide, tmp = jax_clip_run
    monkeypatch.setattr(port_nca, "SPHNCAConfig", functools.partial(
        _fire_rate_one, port_nca.SPHNCAConfig))
    extra = guide if source == "clip_guide" else ["--clip_text_embed", embed]
    out = tmp / f"port-{source}"
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        assert cli_train.main(common + extra + [
            "--training_iter", "3", "--checkpoint_every", "3", "--device",
            "cpu", "--output_dir", str(out)]) == 0
    finally:
        torch.set_num_threads(n)
    (path,) = glob.glob(str(out / "metrics-*.jsonl"))
    with open(path) as f:
        rows = [json.loads(line) for line in f]
    assert [r["iter"] for r in rows] == [r["step"] for r in rows] == [0, 1, 2]
    for r in rows:
        assert {"step", "t", "loss", "it_per_sec", "rss_gb"} <= set(r)
    got = [r["loss"] for r in rows]
    np.testing.assert_allclose(got, [want[i] for i in range(3)],
                               rtol=CLI_LOSS_RTOL)
    (ck,) = glob.glob(str(out / "sphnca-*-0003"))
    with open(os.path.join(ck, "meta.json")) as f:
        assert json.load(f)["extra"]["mode"] == "texture"


def test_train_cli_clip_needs_a_prompt(tmp_path, capsys):
    from sph_nca_tpu_torch.cli import train as cli_train

    with pytest.raises(SystemExit, match="needs --clip_guide"):
        cli_train.main(["--loss", "clip_multiscale", "--device", "cpu",
                        "--output_dir", str(tmp_path)])
    assert os.listdir(tmp_path) == []
