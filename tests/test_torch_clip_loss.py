"""Port parity: the CLIP loss against the JAX package on the CPU (the view
pyramid of ``training/features.py``, the CLIP parts of
``training/losses.py`` and ``make_clip_bundle``), and the CLIP assets of
``chip_smoke.py``.

The image tower is the JAX package's fixed-seed random tower in both
packages (equal bit for bit: ``test_torch_clip.py``), at full size.

Tolerances. The loss: 1e-5 of its value; its gradient with respect to the
states: 1e-4 of the largest |g| (float32 products of 12 blocks in other
orders). At scales 1 and 2 the loss draws nothing; a crop scale (0.5)
draws its window from another stream in each package, so it is held to its
window and a finite gradient only.

``python tests/test_torch_clip_loss.py --write`` recomputes the CLIP assets
of ``chip_smoke.py`` with the JAX package: the numbers its [clip-parity]
holds the card to (``sph_nca_tpu_torch/assets/clip_parity_*.npy``) and the
JAX run's initial parameters that its [clip-train] starts from
(``assets/clip_smoke_init/``); two tests keep them current.
"""

import os
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402  (JAX-free; holds the parity inputs)
from sph_nca_tpu.training import clip_encoder as JE  # noqa: E402
from sph_nca_tpu.training import clip_text as JT  # noqa: E402
from sph_nca_tpu.training import features as JF  # noqa: E402
from sph_nca_tpu.training import losses as JL  # noqa: E402
from sph_nca_tpu.training.trainer import make_clip_bundle as jax_bundle  # noqa: E402
from sph_nca_tpu_torch.training import clip_encoder as TE  # noqa: E402
from sph_nca_tpu_torch.training import features as TF  # noqa: E402
from sph_nca_tpu_torch.training import losses as TL  # noqa: E402
from sph_nca_tpu_torch.training.trainer import make_clip_bundle  # noqa: E402

LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
FEAT_ATOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Torch on one intra-op thread: the tier-1 run's workers share the
    cores, and torch's own pools would oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def image_towers():
    return JE.random_clip_encoder(0), TE.random_clip_encoder(0, device="cpu")


def _loss_inputs(b=2, side=48, seed=7):
    rng = np.random.default_rng(seed)
    A = rng.uniform(-0.2, 1.2, (b, side * side, 16)).astype(np.float32)
    text = rng.normal(size=TE.EMBED).astype(np.float32)
    return A, text / np.linalg.norm(text)


def test_clip_loss_matches_jax(image_towers):
    """clip_loss per sample and the bundle's batch_total at scales (1, 2),
    with their gradients with respect to the states, against jax.grad
    (alpha off here; the parity assets' test holds it on)."""
    jt, tt = image_towers
    A, text = _loss_inputs()
    jcfg = JL.CLIPLossConfig(image_size=48, scales=(1.0, 2.0),
                             use_alpha=False)
    cfg = TL.CLIPLossConfig(image_size=48, scales=(1.0, 2.0),
                            use_alpha=False)
    x = np.zeros((A.shape[1], 2), np.float32)
    key = jax.random.key(0)
    jb = jax_bundle(jnp.asarray(text), jt, jcfg)
    want, want_g = jax.value_and_grad(
        lambda a: jb.batch_total(jnp.asarray(x), a, key))(jnp.asarray(A))
    want_each = [float(JL.clip_loss(jnp.asarray(x), jnp.asarray(a),
                                    jnp.asarray(text), jt, key, jcfg))
                 for a in A]

    At = torch.from_numpy(A).requires_grad_(True)
    bundle = make_clip_bundle(torch.from_numpy(text), tt, cfg)
    got = bundle.batch_total(torch.from_numpy(x), At, None)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want),
                               rtol=LOSS_RTOL)
    g, wg = At.grad.numpy(), np.asarray(want_g)
    assert np.abs(g - wg).max() <= GRAD_RTOL * np.abs(wg).max()
    with torch.no_grad():
        each = bundle.per_sample(torch.from_numpy(x), torch.from_numpy(A),
                                 None).numpy()
        one = TL.clip_loss(torch.from_numpy(x), torch.from_numpy(A[1]),
                           torch.from_numpy(text), tt, None, cfg)
    np.testing.assert_allclose(each, want_each, rtol=LOSS_RTOL)
    assert one.dim() == 0
    np.testing.assert_allclose(float(one), want_each[1], rtol=LOSS_RTOL)


def test_clip_crop_scale_draws_a_window(image_towers):
    """Scale 0.5 crops a 24x24 window of each 48x48 image at offsets drawn
    from the generator; the loss through it has a finite gradient."""
    _, tt = image_towers
    img = torch.rand((3, 48, 48, 3), generator=torch.Generator().manual_seed(
        0))
    gen = torch.Generator().manual_seed(5)
    state = gen.get_state()
    (view,) = TF.scale_pyramid(img, (0.5,), gen)
    gen.set_state(state)
    y0 = torch.randint(0, 25, (3,), generator=gen)
    x0 = torch.randint(0, 25, (3,), generator=gen)
    assert view.shape == (3, 24, 24, 3)
    for b in range(3):
        assert torch.equal(view[b], img[b, y0[b]:y0[b] + 24,
                                        x0[b]:x0[b] + 24])
    with pytest.raises(ValueError, match="generator"):
        TF.scale_pyramid(img, (1.0, 0.5), None)
    A, text = _loss_inputs(b=2)
    At = torch.from_numpy(A).requires_grad_(True)
    cfg = TL.CLIPLossConfig(image_size=48, scales=(1.0, 0.5))
    loss = TL.clip_loss(torch.zeros(A.shape[1], 2), At,
                        torch.from_numpy(text), tt,
                        torch.Generator().manual_seed(1), cfg)
    loss.sum().backward()
    assert loss.shape == (2,) and torch.isfinite(loss).all()
    assert torch.isfinite(At.grad).all() and At.grad.abs().max() > 0


@pytest.mark.parametrize("scales", [(1.0,), (2.0,), (1.0, 2.0, 3.0)])
def test_scale_pyramid_matches_jax(scales):
    img = np.random.default_rng(9).random((2, 48, 48, 3)).astype(np.float32)
    got = TF.scale_pyramid(torch.from_numpy(img), scales, None)
    for b in range(2):
        want = JF.scale_pyramid(jnp.asarray(img[b]), scales,
                                jax.random.key(0))
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g[b].numpy(), np.asarray(w),
                                       atol=1e-6, rtol=0)


def test_spherical_distance_and_overflow_match_jax():
    rng = np.random.default_rng(11)
    u = rng.normal(size=(3, 4, 8)).astype(np.float32)
    u /= np.linalg.norm(u, axis=-1, keepdims=True)
    v = u[0, 0] * 0.6 + 0.8 * np.eye(8, dtype=np.float32)[1]
    got = TL.spherical_distance(torch.from_numpy(u), torch.from_numpy(v))
    for i in range(3):
        np.testing.assert_allclose(
            float(got[i]), float(JL.spherical_distance(jnp.asarray(u[i]),
                                                       jnp.asarray(v))),
            rtol=1e-6)
    A = rng.uniform(-1, 2, (2, 30, 5)).astype(np.float32)
    got = TL.clip_overflow_penalty(torch.from_numpy(A)).numpy()
    want = [float(JL.clip_overflow_penalty(jnp.asarray(a))) for a in A]
    np.testing.assert_allclose(got, want, rtol=1e-6)


# ---- the parity assets of chip_smoke.py's [clip-parity] --------------------


def clip_parity_reference(enc=None):
    """The JAX package's numbers for chip_smoke's parity inputs: the guide's
    text features (fallback tokenizer, random text tower), the image
    features of the seeded images (``enc``: the random image tower), and
    clip_loss and its gradient with respect to the seeded state."""
    images, A = chip_smoke.clip_parity_inputs()
    enc = enc or JE.random_clip_encoder(0)
    text = JT.get_text_features(chip_smoke.CLIP_GUIDE)
    cfg = JL.CLIPLossConfig(image_size=chip_smoke.CLIP_SIDE,
                            scales=chip_smoke.CLIP_PARITY_SCALES)
    x = jnp.zeros((A.shape[0], 2), jnp.float32)
    loss, grad = jax.value_and_grad(lambda a: JL.clip_loss(
        x, a, text, enc, jax.random.key(0), cfg))(jnp.asarray(A))
    return {"text": np.asarray(text, np.float32),
            "image": np.stack([np.asarray(enc(jnp.asarray(im)))
                               for im in images]).astype(np.float32),
            "loss": np.asarray(loss, np.float32),
            "grad": np.asarray(grad, np.float32)}


def test_clip_parity_assets_are_current(image_towers):
    """The shipped assets equal a fresh JAX computation (the same
    arithmetic on the same host: 1e-6 of max), and the port on the CPU
    meets this file's bars against them."""
    ref = clip_parity_reference(image_towers[0])
    shipped = chip_smoke.clip_parity_assets()
    assert sorted(shipped) == sorted(ref)
    for k, v in ref.items():
        assert shipped[k].shape == v.shape and shipped[k].dtype == np.float32
        assert np.abs(shipped[k] - v).max() <= 1e-6 * max(
            np.abs(v).max(), 1e-30), k
    errs = chip_smoke.clip_parity_errors(torch.device("cpu"), shipped,
                                         image_towers[1])
    assert errs["text"] <= FEAT_ATOL and errs["image"] <= FEAT_ATOL
    assert errs["loss_rel"] <= LOSS_RTOL and errs["grad_rel"] <= GRAD_RTOL


def clip_smoke_init():
    """The JAX trainer's initial parameters at runs/clip_smoke's
    configuration (seed 0: the Trainer splits its key once and draws
    init_params from the second half) and the config."""
    from sph_nca_tpu.models import SPHNCAConfig as JaxConfig
    from sph_nca_tpu.models import init_params as jax_init

    h = 0.08
    cfg = JaxConfig(channels=16, hidden=256, fire_rate=0.5,
                    normalize_perception=1.0 / h)
    _, k = jax.random.split(jax.random.key(0))
    return jax_init(k, cfg), cfg, h


def test_clip_init_asset_is_the_jax_runs_draw():
    """chip_smoke's CLIP_INIT holds the JAX run's initial parameters, bit
    for bit, as the port loads them."""
    from sph_nca_tpu_torch.io.checkpoint import load_checkpoint

    params, cfg, h = clip_smoke_init()
    ck = load_checkpoint(chip_smoke.CLIP_INIT, device="cpu")
    assert ck["h"] == h and ck["step"] == 0
    assert ck["model_cfg"].normalize_perception == cfg.normalize_perception
    for got, want in zip(ck["params"], params):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


if __name__ == "__main__" and sys.argv[1:] == ["--write"]:
    from sph_nca_tpu.io.checkpoint import save_checkpoint as jax_save

    for name, arr in clip_parity_reference().items():
        np.save(chip_smoke.clip_parity_path(name), arr)
        print(f"wrote {chip_smoke.clip_parity_path(name)} {arr.shape}")
    params, cfg, h = clip_smoke_init()
    jax_save(chip_smoke.CLIP_INIT, params=params, model_cfg=cfg, h=h, step=0)
    print(f"wrote {chip_smoke.CLIP_INIT}")
