"""Port parity: the texture features, the OT and Gram losses, the exemplar
resize and one OT training iteration, against the JAX package on the CPU.

The OT loss subsamples each feature set to 1024 rows with random draws,
from other streams in the two packages. At image side 32 every feature set
(Gabor: 1024 / 256 / 64 rows; VGG: 1024 / 1024 / 256 / 256 / 64) has at most
1024 rows on both sides, so the subsample is a full permutation and the
relaxed EMD and the moments do not depend on it: the draws are irrelevant,
not matched.

Tolerances. Features: 1e-5 of the largest |feature| per set (float32
convolutions summed in other orders). The OT and Gram losses: 1e-5 of the
value, their gradients with respect to the states 1e-4 of the largest |g|.
Resizes: 1e-6 absolute on [0, 1] images. One training iteration at
fire_rate 1 (the fire draws do not matter): loss and updated parameters to
1e-4 (of the loss; of the largest |p| per parameter), the bar of the BPTT
gradient tests.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from sph_nca_tpu.models import SPHNCAConfig as JaxConfig
from sph_nca_tpu.models import init_params as jax_init
from sph_nca_tpu.ops.bands import build_band_engine as jax_build_band
from sph_nca_tpu.training import OTLossConfig as JaxOTCfg
from sph_nca_tpu.training import Pool as JaxPool
from sph_nca_tpu.training import TrainConfig as JaxTrainConfig
from sph_nca_tpu.training import Trainer as JaxTrainer
from sph_nca_tpu.training import features as JF
from sph_nca_tpu.training import losses as JL
from sph_nca_tpu.training.trainer import make_ot_bundle as jax_ot_bundle
from sph_nca_tpu_torch.io.convert import params_from_jax_numpy
from sph_nca_tpu_torch.models.nca import SPHNCAConfig
from sph_nca_tpu_torch.ops.bands import build_band_engine
from sph_nca_tpu_torch.training import features as TF
from sph_nca_tpu_torch.training import losses as TL
from sph_nca_tpu_torch.training.pool import Pool
from sph_nca_tpu_torch.training.trainer import (
    TrainConfig,
    Trainer,
    make_ot_bundle,
)
from sph_nca_tpu_torch.utils.geometry import grange

FEAT_RTOL = 1e-5
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
RESIZE_ATOL = 1e-6
ITER_RTOL = 1e-4


def _images(b, side, seed):
    return np.random.default_rng(seed).random((b, side, side, 3)).astype(
        np.float32)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


@pytest.fixture(scope="module")
def vgg_pair(tmp_path_factory):
    """JAX's random VGG19 filters, carried to the port through the .npz
    that ``load_vgg19_features`` reads."""
    jv = JF.random_vgg19_features(3)
    path = tmp_path_factory.mktemp("vgg") / "vgg_random.npz"
    np.savez(path, **{f"conv{i + 1}_{k}": np.asarray(a)
                      for i in range(5)
                      for k, a in (("w", jv.weights[i]), ("b", jv.biases[i]))})
    return jv, TF.load_vgg19_features(str(path), device="cpu"), str(path)


@pytest.fixture(scope="module")
def extractors(vgg_pair):
    return {"gabor": (JF.gabor_texture_features(),
                      TF.gabor_texture_features(device="cpu")),
            "vgg": vgg_pair[:2]}


def test_gabor_bank_is_the_jax_bank():
    for args in ((9, 4.0, 6), (7, 3.0, 4)):
        for got, want in zip(TF._gabor_bank_np(*args),
                             JF._gabor_bank_np(*args)):
            assert got.dtype == want.dtype == np.float32
            np.testing.assert_array_equal(got, want)
    ex = TF.gabor_texture_features(device="cpu")
    np.testing.assert_array_equal(
        ex.even.permute(2, 3, 1, 0).numpy(),
        np.asarray(JF.gabor_texture_features().even))


@pytest.mark.parametrize("kind", ["gabor", "vgg"])
def test_features_match_jax(extractors, kind):
    jx, tx = extractors[kind]
    imgs = _images(2, 32, seed=4)
    got = tx(torch.from_numpy(imgs))
    for b in range(2):
        want = jx(jnp.asarray(imgs[b]))
        assert len(got) == len(want) == (3 if kind == "gabor" else 5)
        for g, w in zip(got, want):
            assert tuple(g.shape[1:]) == w.shape
            assert _rel(g[b].numpy(), w) <= FEAT_RTOL


def test_random_vgg_law_and_registry(tmp_path):
    """The port's random filters: VGG19's shapes, He-normal scale, zero
    biases, the same for the same seed; 'vgg' needs weights, as in the JAX
    package."""
    a = TF.random_vgg19_features(0, device="cpu")
    b = TF.random_vgg19_features(0, device="cpu")
    cin = 3
    for wa, wb, ba, cout in zip(a.weights, b.weights, a.biases,
                                TF._VGG_CHANNELS):
        assert tuple(wa.shape) == (cout, cin, 3, 3)
        assert torch.equal(wa, wb) and not ba.any()
        np.testing.assert_allclose(float(wa.std()), np.sqrt(2 / (9 * cin)),
                                   rtol=0.1)
        cin = cout
    assert not torch.equal(
        TF.random_vgg19_features(1, device="cpu").weights[0], a.weights[0])
    with pytest.raises(ValueError, match="requires weights_path"):
        TF.get_texture_features("vgg", device="cpu")
    with pytest.raises(ValueError, match="unknown texture feature"):
        TF.get_texture_features("clip", device="cpu")
    assert isinstance(TF.get_texture_features("vgg_random", device="cpu"),
                      TF.VGGFeatures)
    bad = {f"conv{i}_{k}": np.zeros((3, 3, 3, 8) if k == "w" else (8,),
                                    np.float32)
           for i in range(1, 6) for k in "wb"}
    np.savez(tmp_path / "bad.npz", **bad)
    with pytest.raises(ValueError, match="filters, expected"):
        TF.load_vgg19_features(str(tmp_path / "bad.npz"), device="cpu")


def test_torchvision_conversion_matches_jax(tmp_path):
    rng = np.random.default_rng(0)
    sd, cin = {}, 3
    for li, cout in zip((0, 2, 5, 7, 10), TF._VGG_CHANNELS):
        sd[f"features.{li}.weight"] = rng.normal(
            size=(cout, cin, 3, 3)).astype(np.float32)
        sd[f"features.{li}.bias"] = rng.normal(size=cout).astype(np.float32)
        cin = cout
    TF.convert_torchvision_vgg19({k: torch.from_numpy(v)
                                  for k, v in sd.items()},
                                 str(tmp_path / "t.npz"))
    JF.convert_torchvision_vgg19(sd, str(tmp_path / "j.npz"))
    with np.load(tmp_path / "t.npz") as t, np.load(tmp_path / "j.npz") as j:
        assert sorted(t.files) == sorted(j.files)
        for k in t.files:
            np.testing.assert_array_equal(t[k], j[k])


@pytest.mark.parametrize("src,dst", [(64, 32), (100, 64), (16, 40),
                                     (64, 64)])
def test_resize_matches_jax_image_resize(src, dst):
    """The train CLI's exemplar resize (and eval's): antialiased when it
    shrinks, plain bilinear when it enlarges."""
    img = np.random.default_rng(src).random((src, src, 4)).astype(np.float32)
    got = TF.resize_image(torch.from_numpy(img), (dst, dst)).numpy()
    want = np.asarray(jax.image.resize(jnp.asarray(img), (dst, dst, 4),
                                       "bilinear"))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=RESIZE_ATOL, rtol=0)


def test_loss_primitives_match_jax():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(3, 50, 7)).astype(np.float32)
    y = rng.normal(size=(3, 40, 7)).astype(np.float32)
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    for fn_t, fn_j in ((TL.pairwise_cos_distance, JL.pairwise_cos_distance),
                       (TL.relaxed_emd, JL.relaxed_emd),
                       (TL.moment_loss, JL.moment_loss)):
        got = fn_t(tx, ty).numpy()
        for b in range(3):
            want = np.asarray(fn_j(jnp.asarray(x[b]), jnp.asarray(y[b])))
            assert _rel(got[b], want) <= LOSS_RTOL
    got = TL.gram_style_loss([tx, tx[:, :, :3]], [ty, ty[:, :, :3]]).numpy()
    for b in range(3):
        want = JL.gram_style_loss([jnp.asarray(x[b]), jnp.asarray(x[b, :, :3])],
                                  [jnp.asarray(y[b]), jnp.asarray(y[b, :, :3])])
        assert _rel(got[b], want) <= LOSS_RTOL
    np.testing.assert_allclose(TL.gram_matrix(tx[0]).numpy(),
                               np.asarray(JL.gram_matrix(jnp.asarray(x[0]))),
                               rtol=1e-5, atol=1e-7)


def test_subsample_draws_per_sample():
    """Above max_samples each sample keeps its own random subset of rows;
    at or below it every row, in order."""
    f = torch.arange(40.0).reshape(1, 20, 2).expand(3, 20, 2)
    gen = torch.Generator().manual_seed(0)
    sub = TL._subsample(f, 3, 8, gen)
    assert sub.shape == (3, 8, 2)
    rows = sub[..., 0] / 2
    assert all(len(set(r.tolist())) == 8 for r in rows)
    assert not torch.equal(rows[0], rows[1])
    assert torch.equal(TL._subsample(f[0], 3, 20, None), f)
    with pytest.raises(ValueError, match="generator"):
        TL._subsample(f, 3, 8, None)


@pytest.mark.parametrize("kind", ["gabor", "vgg"])
def test_ot_loss_and_grad_match_jax(extractors, kind):
    jx, tx = extractors[kind]
    side, c = 32, 8
    rng = np.random.default_rng(7)
    A = rng.uniform(-0.2, 1.2, (2, side * side, c)).astype(np.float32)
    target = rng.random((side, side, 3)).astype(np.float32)
    cfg = dict(image_size=side, use_alpha=False)
    x = jnp.zeros((side * side, 2))
    jfeats = [jax.lax.stop_gradient(f) for f in jx(jnp.asarray(target))]

    tA = torch.from_numpy(A).requires_grad_(True)
    ttarget = torch.from_numpy(target)
    with torch.no_grad():
        tfeats = [f[0] for f in tx(ttarget[None])]
    loss = TL.ot_loss(None, tA, tfeats, ttarget, tx,
                      torch.Generator().manual_seed(0),
                      TL.OTLossConfig(**cfg))
    loss.sum().backward()
    loss = loss.detach()
    value_and_grad = jax.jit(jax.value_and_grad(
        lambda a, key: JL.ot_loss(x, a, jfeats, jnp.asarray(target), jx,
                                  key, JaxOTCfg(**cfg))))
    for b in range(2):
        val, grad = value_and_grad(jnp.asarray(A[b]), jax.random.key(b))
        assert abs(float(loss[b]) - float(val)) <= LOSS_RTOL * abs(float(val))
        assert _rel(tA.grad[b].numpy(), grad) <= GRAD_RTOL


def test_ot_training_iteration_matches_jax():
    """One iteration of the port's Trainer and of the JAX Trainer with the
    OT bundle on a periodic band engine, a host pool and fire_rate 1: the
    same loss and updated parameters."""
    side, h, c = 16, 0.3, 8
    x2 = grange((side, side), (-1.0, -1.0), (2.0, 2.0)).reshape(-1, 2)
    x = torch.nn.functional.pad(x2, (0, 1)).numpy()
    period = [2.0, 2.0, 2.0]
    kw = dict(channels=c, hidden=32, fire_rate=1.0, use_alpha=False,
              normalize_perception=1.0 / h)
    jcfg, tcfg = JaxConfig(**kw), SPHNCAConfig(**kw)
    jp = jax_init(jax.random.key(5), jcfg)
    tp = params_from_jax_numpy(*(np.asarray(a) for a in jp), device="cpu")
    target = np.random.default_rng(3).random((side, side, 4)).astype(
        np.float32)
    ocfg = dict(image_size=side, use_alpha=False)
    tc = dict(batch_size=2, pool_size=4, steps_range=(2, 3),
              steps_increment=1, aux_states=2, lr_decay_steps=10)
    seed_A = np.random.default_rng(4).random((side * side, c)).astype(
        np.float32)

    jt = JaxTrainer(jcfg, JaxTrainConfig(**tc),
                    jax_build_band(jnp.asarray(x), h,
                                   period=jnp.asarray(period),
                                   table_dtype="float32"),
                    jnp.asarray(x2.numpy()),
                    jax_ot_bundle(jnp.asarray(target),
                                  JF.gabor_texture_features(),
                                  JaxOTCfg(**ocfg)), h, params=jp)
    tt = Trainer(tcfg, TrainConfig(**tc),
                 build_band_engine(x, h, period=period,
                                   table_dtype="float32", device="cpu"),
                 x2, make_ot_bundle(torch.from_numpy(target),
                                    TF.gabor_texture_features(device="cpu"),
                                    TL.OTLossConfig(**ocfg)), h, params=tp)
    want = jt.run_iteration(0, JaxPool(x2.numpy(), seed_A, 4,
                                       rng=np.random.default_rng(0)))
    got = tt.run_iteration(0, Pool(x2.numpy(), seed_A, 4,
                                   rng=np.random.default_rng(0)))
    assert abs(got - want) <= ITER_RTOL * abs(want)
    for g, w in zip(tt.params, jt.params):
        assert _rel(g.detach().numpy(), w) <= ITER_RTOL


def _first_loss(out_dir, key):
    """The iteration-0 loss of a train CLI run's metrics file (the JAX CLI
    keys its rows by "step", the port's by "iter")."""
    import glob
    import json
    (path,) = glob.glob(str(out_dir / "metrics-*.jsonl"))
    with open(path) as f:
        rows = [json.loads(line) for line in f]
    return next(r["loss"] for r in rows if r[key] == 0)


def test_iteration0_loss_follows_initial_params(tmp_path):
    """Iteration 0 of OT training at runs/ot_gabor_dotted's configuration
    (a one-step rollout from uniform states) takes its level from the
    initial parameters' draw, not from the loss: the port's train CLI,
    started from the JAX trainer's seed-1 initial parameters
    (--pretrained_checkpoint), gives the JAX CLI's own iteration-0 loss
    within 10% (the fire and pool draws differ), while its own seed-1 draw
    (the same law) lands more than 50% away. Pool and fire streams stay the
    packages' own."""
    from sph_nca_tpu.cli import train as jax_cli
    from sph_nca_tpu.io.checkpoint import save_checkpoint as jax_save
    from sph_nca_tpu_torch.cli import train as cli

    seed, h = 1, 0.08
    common = ["--loss", "ot", "--texture_features", "gabor", "--image_size",
              "64", "--target_size", "64", "--wrap", "true", "--use_alpha",
              "false", "--initial_feature", "random", "--h", str(h),
              "--batch_size", "4", "--pool_size", "128", "--steps_range",
              "24,36", "--channels", "16", "--hidden", "256",
              "--checkpoint_every", "1000", "--save_resume", "false",
              "--seed", str(seed)]
    # the JAX CLI runs iterations 0 .. --training_iter, the port's
    # 0 .. --training_iter - 1
    assert jax_cli.main(common + ["--training_iter", "0", "--platform",
                                  "cpu", "--img",
                                  "runs/data/dotted_synth.png",
                                  "--output_dir", str(tmp_path / "jax")]) == 0
    want = _first_loss(tmp_path / "jax", "step")

    # the JAX trainer's initial parameters (sph_nca_tpu/training/trainer.py:
    # the first split of key(seed)), as the JAX CLI configures the model
    jcfg = JaxConfig(channels=16, hidden=256, fire_rate=0.5,
                     update_rule="gated", use_alpha=False,
                     normalize_perception=1.0 / h)
    _, k = jax.random.split(jax.random.key(seed))
    jax_save(str(tmp_path / "jax_init"), params=jax_init(k, jcfg),
             model_cfg=jcfg, h=h, step=0)
    port = common + ["--training_iter", "1", "--device", "cpu", "--img",
                     "sph_nca_tpu_torch/assets/dotted_synth_64.npy"]
    assert cli.main(port + ["--pretrained_checkpoint",
                            str(tmp_path / "jax_init"), "--output_dir",
                            str(tmp_path / "carried")]) == 0
    assert cli.main(port + ["--output_dir", str(tmp_path / "own")]) == 0
    carried = _first_loss(tmp_path / "carried", "iter")
    own = _first_loss(tmp_path / "own", "iter")
    assert abs(carried - want) <= 0.1 * want, (carried, want)
    assert abs(own - want) > 0.5 * want, (own, want)


@pytest.mark.parametrize("src,dst", [((64, 64), (32, 32)), ((100, 60),
                                                             (64, 64)),
                                     ((16, 40), (40, 24)), ((32, 32),
                                                            (64, 64))])
def test_resize_value_and_gradient_match_jax(src, dst):
    """``resize_bilinear``, two products with jax.image.resize's
    interpolation matrices, shrinking, enlarging and both at once: values
    and the gradient of a weighted sum against ``jax.vjp`` (1e-6 of max);
    the backward is products too, so two runs give it bit for bit."""
    rng = np.random.default_rng(sum(src) + sum(dst))
    img = rng.random((2,) + src + (3,)).astype(np.float32)
    W = rng.normal(size=(2,) + dst + (3,)).astype(np.float32)
    want, vjp = jax.vjp(
        lambda z: jax.image.resize(z, (2,) + dst + (3,), "bilinear"),
        jnp.asarray(img))
    (want_g,) = vjp(jnp.asarray(W))
    z = torch.from_numpy(img).permute(0, 3, 1, 2).requires_grad_(True)
    got = TF.resize_bilinear(z, dst).permute(0, 2, 3, 1)
    (g,) = torch.autograd.grad(got, z, torch.from_numpy(W))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=RESIZE_ATOL, rtol=0)
    assert _rel(g.permute(0, 2, 3, 1), want_g) <= RESIZE_ATOL
    z2 = z.detach().clone().requires_grad_(True)
    (g2,) = torch.autograd.grad(TF.resize_bilinear(z2, dst).permute(
        0, 2, 3, 1), z2, torch.from_numpy(W))
    assert torch.equal(g, g2)


@pytest.mark.parametrize("k,cin,cout", [(9, 1, 6), (3, 4, 5)])
def test_conv_backward_is_a_forward_convolution(k, cin, cout):
    """The feature convolutions' backward (a forward convolution with the
    filters flipped, in and out swapped) against autograd through
    ``F.conv2d``, and a float64 gradcheck; constant filters only."""
    rng = np.random.default_rng(k)
    z = torch.tensor(rng.normal(size=(2, cin, 11, 9)), requires_grad=True)
    w = torch.tensor(rng.normal(size=(cout, cin, k, k)))
    G = torch.tensor(rng.normal(size=(2, cout, 11, 9)))
    want = torch.autograd.grad(torch.nn.functional.conv2d(
        z, w, padding=k // 2), z, G)[0]
    got = torch.autograd.grad(TF._conv_same(z, w), z, G)[0]
    assert _rel(got, want) <= 1e-12
    assert torch.autograd.gradcheck(lambda a: TF._conv_same(a, w), (z,))
    with pytest.raises(ValueError, match="constant filters"):
        TF._conv_same(z, w.clone().requires_grad_(True))
