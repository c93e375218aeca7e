"""The CLIP ViT-B/32 image tower for the text-guidance loss (counterpart of
``sph_nca_tpu/training/clip_encoder.py``).

The tower is a function over a dict of weights, in the JAX package's key
names and layouts, and encodes a batch of images [B, H, W, 3] in [0, 1] in
one pass (the JAX package encodes one image and ``vmap``s it):

  resize to 224 (bilinear, half-pixel, antialiased when shrinking) ->
  normalize -> 32x32 patches as a reshape and a product with the patch
  kernel [3072, 768] (not a convolution) -> class token + position
  embedding -> pre-LN -> 12 x {LN, attention (12 heads), LN, MLP 3072 with
  QuickGELU} -> LN -> the class token through ``proj`` -> 512,
  L2-normalized.

Attention is the JAX package's: products and a softmax (plain PyTorch; the
JAX package computes the towers in XLA, outside any Pallas kernel). The
entry points keep TF32 off, so the products run in fp32.

Weights: ``load_clip_encoder`` reads the ``.npz`` that ``convert_open_clip``
(pure numpy, here as in the JAX package) writes from an open_clip state
dict; ``random_clip_encoder(seed)`` draws the JAX package's fixed-seed
random tower from the same numpy stream, array for array (not semantically
CLIP: it runs the pipeline when no weights are at hand). Nothing is
downloaded.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from .. import resolve_device
from .features import resize_bilinear

IMAGE_RES = 224
PATCH = 32
WIDTH = 768
LAYERS = 12
HEADS = 12
EMBED = 512

# OpenAI CLIP normalization
CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)

# the image tower's own keys besides its blocks (the text tower's loader
# skips them in a combined file)
IMAGE_KEYS = ("patch_kernel", "class_embedding", "pos_embedding", "ln_pre_g",
              "ln_pre_b", "ln_post_g", "ln_post_b", "proj")


def _layernorm(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    return F.layer_norm(x, (x.shape[-1],), g, b, eps)


def _block(t: torch.Tensor, w: Dict[str, torch.Tensor], i: int,
           width: int = WIDTH, heads: int = HEADS,
           attn_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One CLIP residual attention block on tokens [B, T, width] (shared by
    the image and the text towers; the text tower passes a causal mask)."""
    p = f"blk{i}_"
    h = _layernorm(t, w[p + "ln1_g"], w[p + "ln1_b"])
    qkv = h @ w[p + "attn_w"] + w[p + "attn_b"]  # [B, T, 3 * width]
    hd = width // heads

    def split_heads(a):  # [B, T, width] -> [B, H, T, hd]
        return a.reshape(*a.shape[:-1], heads, hd).transpose(-3, -2)

    q, k, v = (split_heads(a) for a in qkv.chunk(3, dim=-1))
    att = (q @ k.transpose(-1, -2)) / math.sqrt(hd)
    if attn_mask is not None:
        att = att + attn_mask
    att = torch.softmax(att, dim=-1)
    o = (att @ v).transpose(-3, -2).reshape(*t.shape[:-1], width)
    t = t + (o @ w[p + "attn_out_w"] + w[p + "attn_out_b"])

    h = _layernorm(t, w[p + "ln2_g"], w[p + "ln2_b"])
    h = h @ w[p + "mlp1_w"] + w[p + "mlp1_b"]
    h = h * torch.sigmoid(1.702 * h)  # QuickGELU, as CLIP ViT-B/32
    h = h @ w[p + "mlp2_w"] + w[p + "mlp2_b"]
    return t + h


def _tensors(arrays, device) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(np.asarray(v, np.float32), device=device)
            for k, v in arrays.items()}


class CLIPImageEncoder:
    """Weights as a dict of tensors; call with images [B, H, W, 3] (or one
    [H, W, 3]) in [0, 1] -> unit features [B, EMBED] (or [EMBED])."""

    def __init__(self, w: Dict[str, torch.Tensor]):
        self.w = w

    def __call__(self, img: torch.Tensor) -> torch.Tensor:
        if img.dim() == 3:
            return self(img[None])[0]
        w = self.w
        b = img.shape[0]
        x = resize_bilinear(img.permute(0, 3, 1, 2),
                            (IMAGE_RES, IMAGE_RES)).permute(0, 2, 3, 1)
        mean = torch.tensor(CLIP_MEAN, dtype=x.dtype, device=x.device)
        std = torch.tensor(CLIP_STD, dtype=x.dtype, device=x.device)
        x = (x - mean) / std

        # patchify: pixels of a patch ordered [ph, pw, c], as the kernel's
        # rows (a 32x32 stride-32 convolution as a reshape and a product)
        g = IMAGE_RES // PATCH
        x = x.reshape(b, g, PATCH, g, PATCH, 3).permute(0, 1, 3, 2, 4, 5)
        tok = x.reshape(b, g * g, PATCH * PATCH * 3) @ w["patch_kernel"]

        cls = w["class_embedding"].expand(b, 1, WIDTH)
        t = torch.cat([cls, tok], dim=1) + w["pos_embedding"]
        t = _layernorm(t, w["ln_pre_g"], w["ln_pre_b"])
        for i in range(LAYERS):
            t = _block(t, w, i)
        t = _layernorm(t, w["ln_post_g"], w["ln_post_b"])
        feat = t[:, 0] @ w["proj"]  # the class token -> [B, EMBED]
        return feat / torch.linalg.vector_norm(feat, dim=-1, keepdim=True)


def load_clip_encoder(path: str, device="cuda") -> CLIPImageEncoder:
    """The image tower from an ``.npz`` (``convert_open_clip``'s, or one
    file holding both towers)."""
    device = resolve_device(device)
    with np.load(path) as data:
        return CLIPImageEncoder(_tensors({k: data[k] for k in data.files},
                                         device))


def random_clip_encoder(seed: int = 0, device="cuda") -> CLIPImageEncoder:
    """The JAX package's fixed-seed random tower, drawn from the same numpy
    stream in the same order (NOT semantically CLIP)."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)

    def r(*shape, scale=0.02):
        return rng.normal(0, scale, shape).astype(np.float32)

    ones, zeros = np.ones(WIDTH, np.float32), np.zeros(WIDTH, np.float32)
    w = {
        "patch_kernel": r(PATCH * PATCH * 3, WIDTH),
        "class_embedding": r(WIDTH),
        "pos_embedding": r((IMAGE_RES // PATCH) ** 2 + 1, WIDTH),
        "ln_pre_g": ones, "ln_pre_b": zeros,
        "ln_post_g": ones, "ln_post_b": zeros,
        "proj": r(WIDTH, EMBED),
    }
    for i in range(LAYERS):
        p = f"blk{i}_"
        w.update({
            p + "ln1_g": ones, p + "ln1_b": zeros,
            p + "ln2_g": ones, p + "ln2_b": zeros,
            p + "attn_w": r(WIDTH, 3 * WIDTH),
            p + "attn_b": np.zeros(3 * WIDTH, np.float32),
            p + "attn_out_w": r(WIDTH, WIDTH),
            p + "attn_out_b": zeros,
            p + "mlp1_w": r(WIDTH, 4 * WIDTH),
            p + "mlp1_b": np.zeros(4 * WIDTH, np.float32),
            p + "mlp2_w": r(4 * WIDTH, WIDTH),
            p + "mlp2_b": zeros,
        })
    return CLIPImageEncoder(_tensors(w, device))


def convert_open_clip(state_dict, out_path: str) -> None:
    """An open_clip ViT-B-32 visual state dict (keys with or without the
    ``visual.`` prefix; arrays or CPU tensors) -> the tower's ``.npz``."""
    sd = {k: np.asarray(v) for k, v in state_dict.items()}

    def g(k):
        return sd[k] if k in sd else sd["visual." + k]

    out = {
        # conv [768, 3, 32, 32] -> [32*32*3, 768], pixels ordered [ph, pw, c]
        "patch_kernel": g("conv1.weight").transpose(2, 3, 1, 0).reshape(
            PATCH * PATCH * 3, WIDTH),
        "class_embedding": g("class_embedding"),
        "pos_embedding": g("positional_embedding"),
        "ln_pre_g": g("ln_pre.weight"), "ln_pre_b": g("ln_pre.bias"),
        "ln_post_g": g("ln_post.weight"), "ln_post_b": g("ln_post.bias"),
        "proj": g("proj"),
    }
    for i in range(LAYERS):
        out.update(_block_arrays(g, f"transformer.resblocks.{i}.",
                                 f"blk{i}_"))
    np.savez(out_path, **out)


def _block_arrays(g, rb: str, p: str) -> Dict[str, np.ndarray]:
    """One open_clip residual block's arrays under our names (the linear
    layers' weights transposed to [in, out])."""
    return {
        p + "ln1_g": g(rb + "ln_1.weight"), p + "ln1_b": g(rb + "ln_1.bias"),
        p + "ln2_g": g(rb + "ln_2.weight"), p + "ln2_b": g(rb + "ln_2.bias"),
        p + "attn_w": g(rb + "attn.in_proj_weight").T,
        p + "attn_b": g(rb + "attn.in_proj_bias"),
        p + "attn_out_w": g(rb + "attn.out_proj.weight").T,
        p + "attn_out_b": g(rb + "attn.out_proj.bias"),
        p + "mlp1_w": g(rb + "mlp.c_fc.weight").T,
        p + "mlp1_b": g(rb + "mlp.c_fc.bias"),
        p + "mlp2_w": g(rb + "mlp.c_proj.weight").T,
        p + "mlp2_b": g(rb + "mlp.c_proj.bias"),
    }


def get_clip_encoder(weights_path: Optional[str] = None, seed: int = 0,
                     device="cuda") -> CLIPImageEncoder:
    device = resolve_device(device)
    if weights_path:
        return load_clip_encoder(weights_path, device=device)
    return random_clip_encoder(seed, device=device)
