"""Training losses: image mode (MSE), exemplar mode (OT style) and text mode
(CLIP), with the Gram style loss (counterpart of
``sph_nca_tpu/training/losses.py``).

mse:  mean((rgba - img(x))^2) + w_overflow * sum(max(|A| - 1, 0))
ot:   w_style * OT(features(rgb), features(exemplar))
      + w_color * mean|rgb - exemplar| + w_overflow * sum(max(|A| - 1, 0))
clip: w_clip * mean over scales of the spherical distance between the
      views' image features and the text features
      + w_overflow * sum(max(|A - 0.5| - 0.5, 0))

Every function takes states with any leading batch axes, A [..., N, C], and
reduces over the last two axes (one value per sample). The OT parts are
batched over the samples: feature sets [B, n, c], products by
``torch.matmul`` (``torch.bmm`` on the card; the entry points keep TF32
off, so they run in full fp32 as the JAX package's ``Precision.HIGHEST``).
They are library calls, as the JAX package computes them outside any Pallas
kernel. The CLIP loss encodes the views of all B samples in one call of the
image tower per scale.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Sequence

import torch

from ..models.nca import to_rgba
from ..utils.geometry import bilinear_sample


def overflow_penalty(A: torch.Tensor) -> torch.Tensor:
    """sum(max(|A| - 1, 0)) over all particles and channels."""
    return torch.sum(torch.clamp(A.abs() - 1.0, min=0.0), dim=(-2, -1))


def clip_overflow_penalty(A: torch.Tensor) -> torch.Tensor:
    """sum(max(|A - 0.5| - 0.5, 0)): the CLIP mode's overflow penalty."""
    return torch.sum(torch.clamp(torch.abs(A - 0.5) - 0.5, min=0.0),
                     dim=(-2, -1))


def rgba_with_margin(A: torch.Tensor, use_alpha: bool,
                     margin: Optional[float]) -> torch.Tensor:
    """to_rgba with a straight-through clamp: the forward clamps to
    [-margin, 1 + margin], the backward is the identity."""
    rgba = to_rgba(A, use_alpha)
    if margin is None:
        return rgba
    clamped = torch.clamp(rgba, 0.0 - margin, 1.0 + margin)
    return rgba + (clamped - rgba).detach()


class MSELossConfig(NamedTuple):
    """Image-mode loss config."""

    gmin: tuple  # domain min, e.g. (-1, -1)
    gsize: tuple  # domain size, e.g. (2, 2)
    image_scale: float  # target_size / image_size
    overflow_weight: float = 0.05
    use_alpha: bool = True


def target_at(x: torch.Tensor, img: torch.Tensor,
              cfg: MSELossConfig) -> torch.Tensor:
    """The target image bilinearly sampled at positions x [N, 2] -> [N, 4].

    The image spans [gmin*s, gmin*s + gsize*s] (s = image_scale), so with
    s < 1 it occupies the domain's centre and positions outside sample the
    clamped edge pixels."""
    img_gmin = torch.tensor(cfg.gmin, dtype=torch.float32,
                            device=x.device) * cfg.image_scale
    img_gsize = torch.tensor(cfg.gsize, dtype=torch.float32,
                             device=x.device) * cfg.image_scale
    return bilinear_sample(x, img, img_gmin, img_gsize)


def mse_loss(x: torch.Tensor, A: torch.Tensor, img: torch.Tensor,
             cfg: MSELossConfig) -> torch.Tensor:
    """MSE against the target image sampled at the particle positions, plus
    the overflow penalty: A [..., N, C] -> [...]."""
    rgba = rgba_with_margin(A, cfg.use_alpha, margin=None)
    loss = torch.mean((rgba - target_at(x, img, cfg)) ** 2, dim=(-2, -1))
    if cfg.overflow_weight > 0:
        loss = loss + cfg.overflow_weight * overflow_penalty(A)
    return loss


# ---- optimal-transport style loss ----------------------------------------

OT_MAX_SAMPLES = 1024


def pairwise_cos_distance(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """1 - cosine similarity of the rows of x [..., n, c] and y [..., m, c]
    -> [..., n, m]."""
    xn = torch.linalg.vector_norm(x, dim=-1, keepdim=True)  # [..., n, 1]
    yn = torch.linalg.vector_norm(y, dim=-1, keepdim=True)  # [..., m, 1]
    dot = torch.matmul(x, y.transpose(-1, -2))
    return 1.0 - dot / (xn * yn.transpose(-1, -2) + 1e-10)


def relaxed_emd(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Relaxed earth mover's distance: max(mean_n min_m d, mean_m min_n d)
    -> [...]."""
    pd = pairwise_cos_distance(x, y)
    m1 = torch.mean(torch.amin(pd, dim=-2), dim=-1)
    m2 = torch.mean(torch.amin(pd, dim=-1), dim=-1)
    return torch.maximum(m1, m2)


def moment_loss(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Mean absolute gap of the first and second moments (means and
    covariances) of two feature sets [..., n, c] -> [...]."""
    mu_x = torch.mean(x, dim=-2, keepdim=True)
    mu_y = torch.mean(y, dim=-2, keepdim=True)
    mu_diff = torch.mean(torch.abs(mu_x - mu_y), dim=(-2, -1))
    xc, yc = x - mu_x, y - mu_y
    x_cov = torch.matmul(xc.transpose(-1, -2), xc) / (x.shape[-2] - 1)
    y_cov = torch.matmul(yc.transpose(-1, -2), yc) / (y.shape[-2] - 1)
    return mu_diff + torch.mean(torch.abs(x_cov - y_cov), dim=(-2, -1))


def _subsample(f: torch.Tensor, b: int, n: int,
               generator: Optional[torch.Generator]) -> torch.Tensor:
    """n rows of a feature set [B | none, rows, c] for each of b samples:
    a random permutation's first n rows per sample, or every row in order
    when n covers them all (the relaxed EMD and the moments do not depend
    on the order of the rows, so a full permutation would change nothing)."""
    if f.dim() == 2:
        f = f.expand(b, *f.shape)
    rows = f.shape[1]
    if n >= rows:
        return f
    if generator is None:
        raise ValueError("subsampling a feature set needs a generator")
    keys = torch.rand((b, rows), generator=generator,
                      device=generator.device).to(f.device)
    idx = torch.argsort(keys, dim=1)[:, :n]
    return torch.gather(f, 1, idx[..., None].expand(b, n, f.shape[-1]))


def ot_feature_loss(feats_x: Sequence[torch.Tensor],
                    feats_y: Sequence[torch.Tensor],
                    generator: Optional[torch.Generator], *,
                    max_samples: int = OT_MAX_SAMPLES) -> torch.Tensor:
    """OT style score over per-layer feature sets, mean over layers.

    feats_x: [B, n_i, c_i] per layer; feats_y: [n_i', c_i] (one exemplar for
    every sample) or [B, n_i', c_i]. Each layer keeps min(n_i, n_i',
    max_samples) rows of each side, drawn per sample and side by one
    permutation from ``generator`` (the JAX package draws one per sample,
    layer and side from its key) -> [B]."""
    total = 0.0
    for fx, fy in zip(feats_x, feats_y):
        b = fx.shape[0]
        n = min(fx.shape[-2], fy.shape[-2], max_samples)
        sx = _subsample(fx, b, n, generator)
        sy = _subsample(fy, b, n, generator)
        total = total + relaxed_emd(sx, sy) + moment_loss(sx, sy)
    return total / len(feats_x)


class OTLossConfig(NamedTuple):
    """Exemplar-mode loss config."""

    image_size: int  # particles per image side
    style_weight: float = 1.0
    color_weight: float = 0.05
    overflow_weight: float = 0.05
    use_alpha: bool = True


def particles_to_image(A: torch.Tensor, image_size: int) -> torch.Tensor:
    """Grid-ordered particles [..., H*W, F] -> images [..., H, W, F] (the
    grid's ij order is row-major)."""
    return A.reshape(*A.shape[:-2], image_size, image_size, A.shape[-1])


def ot_loss(x: torch.Tensor, A: torch.Tensor,
            target_feats: Sequence[torch.Tensor], target_rgb: torch.Tensor,
            feature_fn: Callable, generator: Optional[torch.Generator],
            cfg: OTLossConfig) -> torch.Tensor:
    """The exemplar loss of states A [B, N, C] (or one state [N, C]) -> [B]
    (or a scalar). ``feature_fn`` maps images [B, H, W, 3] to feature sets
    [B, n_i, c_i]; ``target_feats`` are the exemplar's [n_i, c_i] and
    ``target_rgb`` its image [H, W, 3]."""
    single = A.dim() == 2
    if single:
        A = A[None]
    rgba = rgba_with_margin(A, cfg.use_alpha, margin=None)
    rgb = particles_to_image(rgba[..., :3], cfg.image_size)
    style = ot_feature_loss(feature_fn(rgb), target_feats, generator)
    color = torch.mean(torch.abs(rgb - target_rgb), dim=(-3, -2, -1))
    loss = cfg.style_weight * style + cfg.color_weight * color
    if cfg.overflow_weight > 0:
        loss = loss + cfg.overflow_weight * overflow_penalty(A)
    return loss[0] if single else loss


def gram_matrix(feats: torch.Tensor) -> torch.Tensor:
    """Gram matrix of feature sets [..., n, c] -> [..., c, c] / (c n)."""
    n, c = feats.shape[-2:]
    return torch.matmul(feats.transpose(-1, -2), feats) / (c * n)


def gram_style_loss(feats_x: Sequence[torch.Tensor],
                    feats_y: Sequence[torch.Tensor]) -> torch.Tensor:
    """Gatys-style Gram loss, summed over layers -> [...]."""
    total = 0.0
    for fx, fy in zip(feats_x, feats_y):
        total = total + torch.mean((gram_matrix(fx) - gram_matrix(fy)) ** 2,
                                   dim=(-2, -1))
    return total


# ---- CLIP text-guidance loss -----------------------------------------------


def spherical_distance(image_features: torch.Tensor,
                       text_features: torch.Tensor) -> torch.Tensor:
    """2 arcsin(|u - v| / 2)^2 of feature rows [..., n, E], mean over the n
    rows -> [...] (a scalar for the JAX package's [n, E] inputs)."""
    d = torch.linalg.vector_norm(image_features - text_features, dim=-1)
    return torch.mean(2.0 * torch.arcsin(d / 2.0) ** 2, dim=-1)


class CLIPLossConfig(NamedTuple):
    """Text-mode loss config."""

    image_size: int
    scales: tuple = (1.0,)
    clip_weight: float = 1.0
    overflow_weight: float = 0.05
    use_alpha: bool = True


def clip_loss(x: torch.Tensor, A: torch.Tensor,
              text_features: torch.Tensor, encode_image: Callable,
              generator: Optional[torch.Generator],
              cfg: CLIPLossConfig) -> torch.Tensor:
    """The multi-scale CLIP guidance loss of states A [B, N, C] (or one
    state [N, C]) -> [B] (or a scalar). ``encode_image`` maps images
    [B, H, W, 3] to unit features [B, E] (resizing to its own resolution);
    ``text_features`` [E] are the prompt's, computed once. The crops of
    scales below 1 are drawn from ``generator``."""
    from .features import scale_pyramid

    single = A.dim() == 2
    if single:
        A = A[None]
    rgba = rgba_with_margin(A, cfg.use_alpha, margin=0.0)
    rgb = particles_to_image(rgba[..., :3], cfg.image_size)
    views = scale_pyramid(rgb, cfg.scales, generator)
    dists = [spherical_distance(encode_image(v)[:, None],
                                text_features[None]) for v in views]
    loss = cfg.clip_weight * (sum(dists) / len(dists))
    if cfg.overflow_weight > 0:
        loss = loss + cfg.overflow_weight * clip_overflow_penalty(A)
    return loss[0] if single else loss
