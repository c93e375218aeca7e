"""Port parity: the CLIP towers and tokenizer against the JAX package on the
CPU (``training/clip_encoder.py``, ``training/clip_text.py``).

Both packages draw their random towers from the same numpy stream, so the
towers are equal bit for bit; the towers run at full size (50 image tokens,
77 text tokens), drawn once per module. Nothing is downloaded: the BPE
tests use a synthetic merges table. The loss is held in
``test_torch_clip_loss.py``, the train CLI in ``test_torch_clip_cli.py``.

Tolerances. Image and text features: 1e-5 absolute (unit vectors, float32
products of 12 blocks in other orders). Tokens and converted arrays:
exactly.
"""

import gzip
import random

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from sph_nca_tpu.training import clip_encoder as JE
from sph_nca_tpu.training import clip_text as JT
from sph_nca_tpu_torch.training import clip_encoder as TE
from sph_nca_tpu_torch.training import clip_text as TT

FEAT_ATOL = 1e-5
PROMPTS = ["a red and yellow spiral", "Hello, World! it's 2 o'clock",
           "jellybeans &amp; zebras", "  café\tnoir\n", "x" * 120]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Torch on one intra-op thread: the tier-1 run's workers share the
    cores, and torch's own pools would oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _merges(path):
    """A tiny merges table exercising the real BPE code path (the JAX
    package's test table plus a few)."""
    lines = ["#version: 0.2", "h e", "he l", "hel l", "hell o</w>", "w o",
             "wo r", "wor l", "worl d</w>", "r e", "re d</w>", "a n",
             "an d</w>"]
    with gzip.open(path, "wt", encoding="utf-8") as f:
        f.write("\n".join(lines))
    return path


@pytest.fixture(scope="module")
def merges(tmp_path_factory):
    return _merges(str(tmp_path_factory.mktemp("bpe") / "merges.txt.gz"))


@pytest.fixture(scope="module")
def image_towers():
    return JE.random_clip_encoder(0), TE.random_clip_encoder(0, device="cpu")


@pytest.fixture(scope="module")
def text_towers():
    return JT.random_text_encoder(1), TT.random_text_encoder(1, device="cpu")


@pytest.mark.parametrize("tower", ["image", "text"])
def test_random_towers_equal_jax(image_towers, text_towers, tower):
    jt, tt = image_towers if tower == "image" else text_towers
    assert set(tt.w) == set(jt.w)
    for k, v in jt.w.items():
        got = tt.w[k].numpy()
        assert got.dtype == np.float32, k
        np.testing.assert_array_equal(got, np.asarray(v), err_msg=k)


@pytest.mark.parametrize("text", PROMPTS)
def test_tokens_match_jax(merges, text):
    want_tok, got_tok = JT.SimpleTokenizer(merges), TT.SimpleTokenizer(merges)
    assert got_tok.encode(text) == want_tok.encode(text)
    for tok in (None, (want_tok, got_tok)):
        want = JT.tokenize(text, tok and tok[0])
        got = TT.tokenize(text, tok and tok[1])
        assert got.dtype == want.dtype == np.int32
        np.testing.assert_array_equal(got, want)
    assert TT.fallback_tokenize(text) == JT.fallback_tokenize(text)
    assert TT.basic_clean(text) == JT.basic_clean(text)


def test_word_splitter_matches_the_regex():
    """``split_words`` against the JAX tokenizer's compiled pattern on random
    strings over ASCII, Latin-1, Greek, CJK, digits of several scripts,
    punctuation, the special tokens and contractions."""
    import regex

    pat = regex.compile(
        r"""<start_of_text>|<end_of_text>|'s|'t|'re|'ve|'m|'ll|'d|"""
        r"""[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+""", regex.IGNORECASE)
    pieces = (list("abcXYZ éüßñ.,;!?'\"-_()[]") + ["'s", "'ll", "'re", "'d",
              "<start_of_text>", "<end_of_text>", "²", "٣", "Ⅻ", "中文",
              "αβγ", " ", "  ", "…", "🙂", "a1b2"])
    rnd = random.Random(0)
    for _ in range(300):
        text = "".join(rnd.choice(pieces) for _ in range(rnd.randint(0, 30)))
        text = " ".join(text.split()).lower()
        assert TT.split_words(text) == regex.findall(pat, text), text


@pytest.mark.parametrize("side", [48, 224])
def test_image_features_match_jax(image_towers, side):
    jt, tt = image_towers
    imgs = np.random.default_rng(side).random((2, side, side, 3)).astype(
        np.float32)
    got = tt(torch.from_numpy(imgs)).numpy()
    want = np.stack([np.asarray(jt(jnp.asarray(im))) for im in imgs])
    assert got.shape == (2, TE.EMBED)
    np.testing.assert_allclose(got, want, atol=FEAT_ATOL, rtol=0)
    np.testing.assert_allclose(tt(torch.from_numpy(imgs[0])).numpy(),
                               want[0], atol=FEAT_ATOL, rtol=0)


@pytest.mark.parametrize("bpe", [False, True])
def test_text_features_match_jax(text_towers, merges, bpe):
    jt, tt = text_towers
    texts = ["a red and yellow spiral", "hello world"]
    want_tok = JT.SimpleTokenizer(merges) if bpe else None
    got_tok = TT.SimpleTokenizer(merges) if bpe else None
    want = np.asarray(jt(JT.tokenize(texts, want_tok)))
    got = tt(TT.tokenize(texts, got_tok)).numpy()
    np.testing.assert_allclose(got, want, atol=FEAT_ATOL, rtol=0)
    np.testing.assert_allclose(tt(TT.tokenize(texts[0], got_tok)[0]).numpy(),
                               want[0], atol=FEAT_ATOL, rtol=0)
    # get_text_features: the same prompt through the same path
    if not bpe:
        got1 = TT.get_text_features(texts[0], device="cpu").numpy()
        np.testing.assert_allclose(got1, want[0], atol=FEAT_ATOL, rtol=0)


def _visual_state_dict(rng):
    """An open_clip-shaped visual state dict at the tower's sizes."""
    w = TE.WIDTH
    sd = {"visual.conv1.weight": rng.normal(0, 0.02, (w, 3, TE.PATCH,
                                                        TE.PATCH)),
          "visual.class_embedding": rng.normal(0, 0.02, w),
          "visual.positional_embedding": rng.normal(0, 0.02, (50, w)),
          "visual.ln_pre.weight": 1 + rng.normal(0, 0.1, w),
          "visual.ln_pre.bias": rng.normal(0, 0.1, w),
          "visual.ln_post.weight": 1 + rng.normal(0, 0.1, w),
          "visual.ln_post.bias": rng.normal(0, 0.1, w),
          "visual.proj": rng.normal(0, 0.02, (w, TE.EMBED))}
    for i in range(TE.LAYERS):
        sd.update(_block_sd(rng, f"visual.transformer.resblocks.{i}.", w))
    return {k: v.astype(np.float32) for k, v in sd.items()}


def _text_state_dict(rng):
    w = TT.T_WIDTH
    sd = {"token_embedding.weight": rng.normal(0, 0.02, (TT.VOCAB, w)),
          "positional_embedding": rng.normal(0, 0.02, (TT.CONTEXT, w)),
          "ln_final.weight": 1 + rng.normal(0, 0.1, w),
          "ln_final.bias": rng.normal(0, 0.1, w),
          "text_projection": rng.normal(0, 0.02, (w, TT.EMBED))}
    for i in range(TT.T_LAYERS):
        sd.update(_block_sd(rng, f"transformer.resblocks.{i}.", w))
    return {k: v.astype(np.float32) for k, v in sd.items()}


def _block_sd(rng, rb, w):
    return {rb + "ln_1.weight": 1 + rng.normal(0, 0.1, w),
            rb + "ln_1.bias": rng.normal(0, 0.1, w),
            rb + "ln_2.weight": 1 + rng.normal(0, 0.1, w),
            rb + "ln_2.bias": rng.normal(0, 0.1, w),
            rb + "attn.in_proj_weight": rng.normal(0, 0.02, (3 * w, w)),
            rb + "attn.in_proj_bias": rng.normal(0, 0.02, 3 * w),
            rb + "attn.out_proj.weight": rng.normal(0, 0.02, (w, w)),
            rb + "attn.out_proj.bias": rng.normal(0, 0.02, w),
            rb + "mlp.c_fc.weight": rng.normal(0, 0.02, (4 * w, w)),
            rb + "mlp.c_fc.bias": rng.normal(0, 0.02, 4 * w),
            rb + "mlp.c_proj.weight": rng.normal(0, 0.02, (w, 4 * w)),
            rb + "mlp.c_proj.bias": rng.normal(0, 0.02, w)}


def _same_npz(a, b):
    with np.load(a) as x, np.load(b) as y:
        assert sorted(x.files) == sorted(y.files)
        for k in x.files:
            np.testing.assert_array_equal(x[k], y[k], err_msg=k)


def test_convert_open_clip_matches_jax(tmp_path):
    """The image converter writes the JAX converter's arrays, each package
    loads the other's file, and both towers on it agree (1e-5)."""
    sd = _visual_state_dict(np.random.default_rng(3))
    mine, theirs = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    TE.convert_open_clip(sd, mine)
    JE.convert_open_clip(sd, theirs)
    _same_npz(mine, theirs)
    img = np.random.default_rng(4).random((40, 40, 3)).astype(np.float32)
    want = np.asarray(JE.load_clip_encoder(mine)(jnp.asarray(img)))
    got = TE.get_clip_encoder(theirs, device="cpu")(
        torch.from_numpy(img)).numpy()
    np.testing.assert_allclose(got, want, atol=FEAT_ATOL, rtol=0)


def test_convert_open_clip_text_matches_jax(tmp_path, image_towers):
    """The text converter likewise; a file holding both towers loads as
    each tower in the port."""
    sd = _text_state_dict(np.random.default_rng(5))
    mine, theirs = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    TT.convert_open_clip_text(sd, mine)
    JT.convert_open_clip_text(sd, theirs)
    _same_npz(mine, theirs)
    tokens = TT.tokenize("a red and yellow spiral")[0]
    want = np.asarray(JT.load_text_encoder(mine)(tokens))
    got = TT.load_text_encoder(theirs, device="cpu")(tokens).numpy()
    np.testing.assert_allclose(got, want, atol=FEAT_ATOL, rtol=0)
    both = str(tmp_path / "both.npz")
    with np.load(mine) as text:
        np.savez(both, **{k: text[k] for k in text.files},
                 **{k: v.numpy() for k, v in image_towers[1].w.items()})
    got = TT.get_text_features("a red and yellow spiral",
                               weights_path=both, device="cpu").numpy()
    np.testing.assert_allclose(got, want, atol=FEAT_ATOL, rtol=0)
    img = torch.rand((1, 32, 32, 3), generator=torch.Generator().manual_seed(
        0))
    assert torch.equal(TE.get_clip_encoder(both, device="cpu")(img),
                       image_towers[1](img))
