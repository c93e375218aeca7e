"""Texture feature extractors for the OT style loss (counterpart of the Gabor
and VGG parts of ``sph_nca_tpu/training/features.py``).

Every extractor maps a batch of images [B, H, W, 3] in [0, 1] to a list of
feature sets [B, n_i, c_i] (flattened pixels x channels, row-major), ready
for ``losses.ot_feature_loss``:

  * ``gabor_texture_features()``: a fixed quadrature Gabor bank over a
    3-level pyramid with cross-scale magnitude products (the default; no
    weights, no draws);
  * ``load_vgg19_features(path)``: the first five convs of VGG19 from an
    ``.npz`` (``conv{i}_w`` [kh, kw, cin, cout] HWIO, ``conv{i}_b``), the
    layout the JAX package reads; ``convert_torchvision_vgg19`` writes it
    from a torchvision state dict;
  * ``random_vgg19_features(seed)``: He-normal random filters of VGG19's
    shapes. The JAX package draws them with ``jax.random.normal``, which the
    port cannot reproduce: here they come from a seeded CPU
    ``torch.Generator``, the same law from another stream.

``scale_pyramid`` gives the CLIP loss its views of a batch of images, one
per scale (a downsized copy, the images, or a random crop of each, drawn
from a ``torch.Generator`` where the JAX package draws from its key).

The convolutions are ``F.conv2d`` (HWIO filters as OIHW, padding k // 2,
the JAX package's ``SAME``), the pools ``F.avg_pool2d`` / ``F.max_pool2d``
of 2. The entry points keep TF32 off, so on the card they run in fp32 on
cuDNN, as the JAX package's run at ``Precision.HIGHEST``. The filters are
constants (no extractor is trained), and a convolution's backward is itself
a forward convolution (the filters flipped, in and out swapped), since
cuDNN's backward-data algorithms may add atomically. The bilinear resize is
``jax.image.resize``'s: two products with fixed interpolation matrices, so
its backward is two products too (PyTorch's ``interpolate`` backward adds
atomically on the card). Both give the same gradient on every run.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from .. import resolve_device

# ImageNet normalization
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)

# channel widths of VGG19 convs 1..5 (conv1_1 .. conv3_1) and whether a 2x2
# max-pool precedes the conv
_VGG_CHANNELS = (64, 64, 128, 128, 256)
_VGG_POOL_BEFORE = (False, False, True, False, True)

LUMA = (0.299, 0.587, 0.114)


class _ConvSame(torch.autograd.Function):
    """Cross-correlation with constant filters; the backward in z is the
    cross-correlation of the gradient with the filters flipped and in / out
    swapped (a forward convolution)."""

    @staticmethod
    def forward(ctx, z, w):
        ctx.save_for_backward(w)
        return F.conv2d(z, w, padding=w.shape[-1] // 2)

    @staticmethod
    def backward(ctx, G):
        (w,) = ctx.saved_tensors
        wt = w.flip(-1, -2).transpose(0, 1)
        return F.conv2d(G, wt, padding=w.shape[-1] // 2), None


def _conv_same(z: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Cross-correlation with zero 'same' padding: z [B, Cin, H, W], w
    [O, Cin, k, k] (odd k, constant) -> [B, O, H, W]."""
    if w.requires_grad:
        raise ValueError("_conv_same takes constant filters")
    return _ConvSame.apply(z, w)


def _hwio_to_oihw(w) -> torch.Tensor:
    return torch.as_tensor(w, dtype=torch.float32).permute(3, 2, 0, 1)


def _sets(z: torch.Tensor) -> torch.Tensor:
    """[B, C, H, W] -> [B, H*W, C] (row-major pixels)."""
    return z.permute(0, 2, 3, 1).reshape(z.shape[0], -1, z.shape[1])


@dataclasses.dataclass
class VGGFeatures:
    """First-5-conv VGG19 extractor (the style layers only). Features are the
    conv outputs before the ReLU; the ReLU feeds the next conv."""

    weights: List[torch.Tensor]  # [cout, cin, 3, 3]
    biases: List[torch.Tensor]

    def __call__(self, img: torch.Tensor) -> List[torch.Tensor]:
        """img [B, H, W, 3] -> 5 feature sets [B, h*w, c]."""
        mean = img.new_tensor(IMAGENET_MEAN)
        std = img.new_tensor(IMAGENET_STD)
        z = ((img - mean) / std).permute(0, 3, 1, 2)
        feats = []
        for w, b, pool in zip(self.weights, self.biases, _VGG_POOL_BEFORE):
            if pool:
                z = F.max_pool2d(z, 2)
            z = _conv_same(z, w) + b[:, None, None]
            feats.append(_sets(z))
            z = torch.relu(z)
        return feats


def load_vgg19_features(path: str, device="cuda") -> VGGFeatures:
    """The 5-conv extractor from an ``.npz`` of HWIO filters."""
    device = resolve_device(device)
    data = np.load(path)
    ws, bs = [], []
    for i in range(1, 6):
        w = np.asarray(data[f"conv{i}_w"], np.float32)
        if w.shape[-1] != _VGG_CHANNELS[i - 1]:
            raise ValueError(f"conv{i} has {w.shape[-1]} filters, expected "
                             f"{_VGG_CHANNELS[i - 1]}")
        ws.append(_hwio_to_oihw(w).contiguous().to(device))
        bs.append(torch.tensor(np.asarray(data[f"conv{i}_b"], np.float32),
                               device=device))
    return VGGFeatures(ws, bs)


def convert_torchvision_vgg19(state_dict, out_path: str) -> None:
    """Write a torchvision VGG19 ``features`` state dict ([cout, cin, kh, kw]
    under ``features.{0,2,5,7,10}.weight``) as the HWIO ``.npz``."""
    arrays = {}
    for i, li in enumerate((0, 2, 5, 7, 10), start=1):
        w = np.asarray(torch.as_tensor(state_dict[f"features.{li}.weight"]))
        arrays[f"conv{i}_w"] = np.transpose(w, (2, 3, 1, 0))
        arrays[f"conv{i}_b"] = np.asarray(
            torch.as_tensor(state_dict[f"features.{li}.bias"]))
    np.savez(out_path, **arrays)


def random_vgg19_features(seed: int = 0, device="cuda") -> VGGFeatures:
    """VGG19-shaped extractor with He-normal random filters
    N(0, 2 / (9 cin)) and zero biases, drawn from a CPU generator seeded
    with ``seed`` (the JAX package's law; not its stream)."""
    device = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    ws, bs = [], []
    cin = 3
    for cout in _VGG_CHANNELS:
        scale = np.sqrt(2.0 / (3 * 3 * cin))
        w = torch.randn((3, 3, cin, cout), generator=gen) * scale
        ws.append(w.permute(3, 2, 0, 1).contiguous().to(device))
        bs.append(torch.zeros(cout, device=device))
        cin = cout
    return VGGFeatures(ws, bs)


def _gabor_bank_np(ksize: int, wavelength: float, n_orient: int) -> tuple:
    """Quadrature Gabor bank, numpy [K, K, 1, O] (even, odd): even filters
    DC-free, every filter L2-normalized (the JAX package's function)."""
    r = ksize // 2
    y, x = np.mgrid[-r:r + 1, -r:r + 1].astype(np.float64)
    sigma = 0.56 * wavelength  # ~1 octave bandwidth
    env = np.exp(-(x * x + y * y) / (2.0 * sigma * sigma))
    evens, odds = [], []
    for i in range(n_orient):
        th = np.pi * i / n_orient
        u = x * np.cos(th) + y * np.sin(th)
        carrier = 2.0 * np.pi * u / wavelength
        e = env * np.cos(carrier)
        o = env * np.sin(carrier)
        e -= e.mean()
        e /= np.sqrt((e * e).sum())
        o /= np.sqrt((o * o).sum())
        evens.append(e)
        odds.append(o)
    ev = np.stack(evens, axis=-1)[:, :, None, :]  # [K, K, 1, O]
    od = np.stack(odds, axis=-1)[:, :, None, :]
    return ev.astype(np.float32), od.astype(np.float32)


@dataclasses.dataclass
class GaborTextureFeatures:
    """Fixed texture extractor. Per pyramid scale s (2x smaller each level)
    the per-pixel feature concatenates the low-passed rgb [3], the even and
    odd Gabor responses of the luminance [2 O], their magnitude [O] and the
    cross-scale product of that magnitude with the next scale's, enlarged
    bilinearly [O] (zeros at the coarsest scale): [B, h_s * w_s, 3 + 4 O]
    a scale."""

    even: torch.Tensor  # [O, 1, K, K]
    odd: torch.Tensor
    n_scales: int = 3

    def __call__(self, img: torch.Tensor) -> List[torch.Tensor]:
        """img [B, H, W, 3] -> ``n_scales`` feature sets."""
        z = (img @ img.new_tensor(LUMA))[:, None]  # [B, 1, H, W]
        rgb = img.permute(0, 3, 1, 2)  # [B, 3, H, W]
        per_scale = []
        for s in range(self.n_scales):
            e = _conv_same(z, self.even)
            od = _conv_same(z, self.odd)
            mag = torch.sqrt(e * e + od * od + 1e-12)
            per_scale.append((rgb, e, od, mag))
            if s + 1 < self.n_scales:
                z = F.avg_pool2d(z, 2)
                rgb = F.avg_pool2d(rgb, 2)
        feats = []
        for s, (rgb_s, e, od, mag) in enumerate(per_scale):
            if s + 1 < self.n_scales:
                up = resize_bilinear(per_scale[s + 1][3], mag.shape[-2:])
                cross = mag * up
            else:
                cross = torch.zeros_like(mag)
            feats.append(_sets(torch.cat([rgb_s, e, od, mag, cross], 1)))
        return feats


def gabor_texture_features(n_orient: int = 6, n_scales: int = 3,
                           ksize: int = 9, wavelength: float = 4.0,
                           device="cuda") -> GaborTextureFeatures:
    """The default Gabor extractor (deterministic: no weights, no draws)."""
    device = resolve_device(device)
    ev, od = _gabor_bank_np(ksize, wavelength, n_orient)
    return GaborTextureFeatures(even=_hwio_to_oihw(ev).contiguous().to(device),
                                odd=_hwio_to_oihw(od).contiguous().to(device),
                                n_scales=n_scales)


def get_texture_features(kind: str = "gabor", weights_path: str | None = None,
                         seed: int = 0, device="cuda"):
    """The OT loss's extractor: 'gabor', 'vgg' (needs ``weights_path``) or
    'vgg_random'."""
    device = resolve_device(device)
    if kind == "gabor":
        return gabor_texture_features(device=device)
    if kind == "vgg":
        if not weights_path:
            raise ValueError("kind='vgg' requires weights_path")
        return load_vgg19_features(weights_path, device=device)
    if kind == "vgg_random":
        return random_vgg19_features(seed, device=device)
    raise ValueError(f"unknown texture feature kind {kind!r}")


def _resize_weights_np(n_in: int, n_out: int) -> np.ndarray:
    """The [n_in, n_out] float32 interpolation matrix of
    ``jax.image.resize(..., 'bilinear')`` along one axis (its
    ``compute_weight_mat``, in float32 as it computes): half-pixel centres,
    the triangle kernel widened by the scale factor when it shrinks, columns
    normalized, samples outside the input zeroed."""
    f32 = np.float32
    inv_scale = f32(1.0 / (n_out / n_in))
    kernel_scale = max(inv_scale, f32(1.0))
    sample = (np.arange(n_out, dtype=f32) + f32(0.5)) * inv_scale - f32(0.5)
    x = np.abs(sample[None, :] - np.arange(n_in, dtype=f32)[:, None]) \
        / kernel_scale
    w = np.maximum(f32(0.0), f32(1.0) - np.abs(x))
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, f32(1.0)), f32(0.0))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[None, :], w, f32(0.0)).astype(f32)


@functools.lru_cache(maxsize=64)
def _resize_weights(n_in: int, n_out: int, device: torch.device,
                    dtype: torch.dtype) -> torch.Tensor:
    """``_resize_weights_np`` on a device, built once per (sizes, device,
    dtype)."""
    return torch.from_numpy(_resize_weights_np(n_in, n_out)).to(
        device=device, dtype=dtype)


def resize_bilinear(z: torch.Tensor, size) -> torch.Tensor:
    """Bilinear resize of [B, C, H, W] to ``size`` (h, w), half-pixel
    centres, antialiased when shrinking: ``jax.image.resize(...,
    'bilinear')``, which widens its triangle kernel by the scale factor when
    it shrinks and is plain bilinear interpolation when it enlarges. One
    product with a fixed matrix for each axis that changes size, so the
    backward is products too."""
    size = tuple(int(s) for s in size)
    H, W = z.shape[-2:]
    if size[0] != H:
        z = torch.matmul(_resize_weights(H, size[0], z.device, z.dtype).T, z)
    if size[1] != W:
        z = torch.matmul(z, _resize_weights(W, size[1], z.device, z.dtype))
    return z


def resize_image(img: torch.Tensor, size) -> torch.Tensor:
    """``resize_bilinear`` of an image [H, W, C] -> [h, w, C]."""
    return resize_bilinear(img.permute(2, 0, 1)[None], size)[0].permute(
        1, 2, 0)


# ---- the CLIP loss's multi-scale views ----------------------------------------


def _resize(img: torch.Tensor, size: int) -> torch.Tensor:
    """Images [..., H, W, C] -> [..., size, size, C] (``resize_bilinear``)."""
    lead = img.shape[:-3]
    z = img.reshape(-1, *img.shape[-3:]).permute(0, 3, 1, 2)
    z = resize_bilinear(z, (size, size)).permute(0, 2, 3, 1)
    return z.reshape(*lead, size, size, img.shape[-1])


def _random_crop(img: torch.Tensor, size: int,
                 generator: torch.Generator) -> torch.Tensor:
    """A size x size window of each image [B, H, W, C] at offsets drawn
    uniformly per image from ``generator`` (on its device; no host sync)."""
    b, h, w = img.shape[:3]
    dev = generator.device
    y0 = torch.randint(0, h - size + 1, (b,), generator=generator,
                       device=dev).to(img.device)
    x0 = torch.randint(0, w - size + 1, (b,), generator=generator,
                       device=dev).to(img.device)
    span = torch.arange(size, device=img.device)
    rows = (y0[:, None] + span)[:, :, None]  # [B, size, 1]
    cols = (x0[:, None] + span)[:, None, :]  # [B, 1, size]
    return img[torch.arange(b, device=img.device)[:, None, None], rows, cols]


def scale_pyramid(img: torch.Tensor, scales: Sequence[float],
                  generator: Optional[torch.Generator]) -> List[torch.Tensor]:
    """One view of the images [B, H, W, C] per scale s: resized to H / s
    when s > 1, the images themselves at s = 1, a random H * s crop of each
    when s < 1 (only then is ``generator`` drawn from)."""
    h = img.shape[-3]
    views = []
    for s in scales:
        if s > 1.0:
            views.append(_resize(img, int(h / s)))
        elif s == 1.0:
            views.append(img)
        else:
            if generator is None:
                raise ValueError("a crop scale (< 1) needs a generator")
            views.append(_random_crop(img, int(h * s), generator))
    return views
