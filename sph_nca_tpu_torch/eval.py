"""Evaluation: PSNR / SSIM, the particle-density sweep and texture statistics
(counterpart of ``sph_nca_tpu/eval.py``).

  * psnr / ssim          image metrics (SSIM per Wang et al., Gaussian
                         windows), numpy in float64
  * render_points        average-splat particles into an image
  * rollout_on_points    one model on any 2D point set: a float32 band
                         engine and the batched rollout at B = 1 (the update
                         MLP is kernel 2.8 on the card)
  * density_sweep        train once, generate anywhere: PSNR / SSIM of
                         rollouts at several particle densities against the
                         target, over the training geometry's image window
  * texture_eval         stationary texture statistics (radial power
                         spectrum and colour histogram L1) of wrapped
                         random-state rollouts against an exemplar, beside
                         four calibration baselines

The rollouts' draws (the random seed state, the fire masks) come from a
``torch.Generator`` seeded with ``seed`` (the JAX package's
``jax.random.key(seed)``: the same laws, other streams); the numpy draws
(jitter, the noise baseline) are the JAX package's own. Resizes are
``features.resize_image``, which equals ``jax.image.resize(...,
'bilinear')`` (antialiased when it shrinks).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from . import resolve_device
from .training.features import resize_image


def psnr(a: np.ndarray, b: np.ndarray, peak: float = 1.0) -> float:
    """Peak signal-to-noise ratio in dB."""
    mse = float(np.mean((np.asarray(a, np.float64)
                         - np.asarray(b, np.float64)) ** 2))
    if mse == 0:
        return float("inf")
    return 10.0 * np.log10(peak * peak / mse)


def _gaussian_kernel1d(sigma: float = 1.5, radius: int = 5) -> np.ndarray:
    x = np.arange(-radius, radius + 1)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return k / k.sum()


def _filter2d(img: np.ndarray, k1d: np.ndarray) -> np.ndarray:
    """Separable 'valid' Gaussian filter over the first two axes."""
    from numpy.lib.stride_tricks import sliding_window_view

    r = len(k1d)
    win = sliding_window_view(img, r, axis=0)
    img = np.tensordot(win, k1d, axes=([-1], [0]))
    win = sliding_window_view(img, r, axis=1)
    return np.tensordot(win, k1d, axes=([-1], [0]))


def ssim(a: np.ndarray, b: np.ndarray, peak: float = 1.0,
         sigma: float = 1.5) -> float:
    """Structural similarity (mean over channels and windows), Wang et al.
    2004."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    if a.ndim == 2:
        a, b = a[..., None], b[..., None]
    c1 = (0.01 * peak) ** 2
    c2 = (0.03 * peak) ** 2
    k = _gaussian_kernel1d(sigma)
    vals = []
    for c in range(a.shape[-1]):
        x, y = a[..., c], b[..., c]
        mu_x = _filter2d(x, k)
        mu_y = _filter2d(y, k)
        xx = _filter2d(x * x, k) - mu_x**2
        yy = _filter2d(y * y, k) - mu_y**2
        xy = _filter2d(x * y, k) - mu_x * mu_y
        s = ((2 * mu_x * mu_y + c1) * (2 * xy + c2)) / (
            (mu_x**2 + mu_y**2 + c1) * (xx + yy + c2))
        vals.append(s.mean())
    return float(np.mean(vals))


def render_points(x: np.ndarray, rgba: np.ndarray, out_size: int,
                  gmin=(-1.0, -1.0), gsize=(2.0, 2.0)) -> np.ndarray:
    """Average-splat particles x [N, 2] with values [N, C] into an
    [out_size, out_size, C] image (a regular grid of that resolution is an
    exact reshape)."""
    x = np.asarray(x)
    rgba = np.asarray(rgba)
    gmin = np.asarray(gmin, np.float64)
    gsize = np.asarray(gsize, np.float64)
    ij = np.floor((x - gmin) / gsize * out_size).astype(np.int64)
    ij = np.clip(ij, 0, out_size - 1)
    flat = ij[:, 0] * out_size + ij[:, 1]
    acc = np.zeros((out_size * out_size, rgba.shape[-1]), np.float64)
    cnt = np.zeros(out_size * out_size, np.float64)
    np.add.at(acc, flat, rgba)
    np.add.at(cnt, flat, 1.0)
    cnt = np.maximum(cnt, 1.0)
    return (acc / cnt[:, None]).reshape(out_size, out_size, -1).astype(
        np.float32)


def _resize_np(img: np.ndarray, size) -> np.ndarray:
    return resize_image(torch.from_numpy(np.asarray(img, np.float32)),
                        size).numpy()


def rollout_on_points(params, cfg, x2, h: float, steps: int,
                      generator: torch.Generator, *, use_3d: bool = True,
                      seed_radius: Optional[float] = None, period=None,
                      randomized: bool = False) -> np.ndarray:
    """Roll one model out on a 2D point set x2 [N, 2] (numpy or tensor):
    a float32 band engine on the generator's device, the plane seed (radial
    of ``seed_radius``, default h, or uniform features with
    ``randomized``), ``steps`` batched steps at B = 1. Returns the final
    rgba [N, 4] as numpy."""
    from .models.cell_step import rollout_cells_batched
    from .models.nca import to_rgba
    from .ops.bands import build_band_engine
    from .ops.batched import batched_gather_back, batched_scatter
    from .utils.seeds import plane_seed

    device = generator.device
    x2 = torch.as_tensor(np.asarray(x2, np.float32))
    x = torch.nn.functional.pad(x2, (0, 1)) if use_3d else x2
    eng = build_band_engine(x.numpy(), h, period=period,
                            table_dtype="float32", smoothing=cfg.smoothing,
                            device=device)
    A0 = plane_seed(x2, cfg.channels, gmin=(-1.0, -1.0), gsize=(2.0, 2.0),
                    radius=seed_radius if seed_radius else h,
                    randomized=randomized, generator=generator).to(device)
    with torch.no_grad():
        final = rollout_cells_batched(params, cfg, eng,
                                      batched_scatter(eng, A0[None]), 1,
                                      generator, steps, h)
        final = batched_gather_back(eng, final, 1)[0]
        return to_rgba(final, cfg.use_alpha).cpu().numpy()


def density_sweep(params, cfg, h: float, target_img: np.ndarray, *,
                  base_size: int = 64,
                  densities: Sequence[float] = (0.5, 1.0, 2.0, 4.0),
                  steps: int = 96, jitter: float = 0.0, seed: int = 0,
                  eval_size: Optional[int] = None, image_scale: float = 1.0,
                  seed_radius: Optional[float] = None,
                  device="cuda") -> List[Dict[str, float]]:
    """PSNR / SSIM against ``target_img`` [S, S, 4] at each density d: a
    regular grid of (base_size sqrt(d))^2 particles (optionally jittered),
    rolled out for ``steps`` from the radial seed, rendered over the image
    window [-image_scale, image_scale]^2 (the training geometry: the target
    fills the centre ``image_scale`` of the domain) at a resolution the
    particles fill, then resized to the target's. Each density's rollout
    draws from a generator seeded with ``seed``, as the JAX package uses
    one key for every density."""
    from .utils.geometry import grange

    device = resolve_device(device)
    eval_size = eval_size or int(target_img.shape[0])
    tgt = _resize_np(target_img, (eval_size, eval_size))
    s = float(image_scale)
    rng = np.random.default_rng(seed)
    results = []
    for d in densities:
        m = max(8, int(round(base_size * np.sqrt(d))))
        x2 = grange((m, m), (-1.0, -1.0), (2.0, 2.0)).reshape(-1, 2)
        if jitter > 0:
            x2 = x2 + torch.from_numpy(rng.uniform(
                -jitter, jitter, tuple(x2.shape)).astype(np.float32)) * (
                    2.0 / m)
        gen = torch.Generator(device=device).manual_seed(seed)
        rgba = rollout_on_points(params, cfg, x2, h, steps, gen,
                                 seed_radius=seed_radius)
        xn = x2.numpy()
        inside = np.all(np.abs(xn) <= s + 1e-6, axis=1)
        r = min(eval_size, max(8, int(np.floor(m * s))))
        img = render_points(xn[inside], np.clip(rgba[inside], 0, 1), r,
                            gmin=(-s, -s), gsize=(2 * s, 2 * s))
        if r != eval_size:
            img = _resize_np(img, (eval_size, eval_size))
        results.append({"density": float(d), "n_particles": int(m * m),
                        "psnr": psnr(img, tgt), "ssim": ssim(img, tgt)})
    return results


# ---- texture statistics ------------------------------------------------------


def radial_power_spectrum(img: np.ndarray, nbins: int = 24) -> np.ndarray:
    """Orientation-averaged log power spectrum of an [H, W, C] image in
    ``nbins`` radial bins, L1-normalized."""
    g = np.mean(np.asarray(img, np.float64), axis=-1)
    g = g - g.mean()
    p = np.abs(np.fft.fftshift(np.fft.fft2(g))) ** 2
    h, w = p.shape
    yy, xx = np.mgrid[:h, :w]
    r = np.hypot(yy - h / 2, xx - w / 2)
    rmax = r.max() + 1e-9
    bins = np.minimum((r / rmax * nbins).astype(int), nbins - 1)
    spec = np.bincount(bins.ravel(), weights=p.ravel(), minlength=nbins)
    cnt = np.bincount(bins.ravel(), minlength=nbins)
    spec = np.log1p(spec / np.maximum(cnt, 1))
    return spec / (np.sum(spec) + 1e-12)


def color_histogram(img: np.ndarray, nbins: int = 16) -> np.ndarray:
    """Per-channel histograms of an [H, W, C] image in [0, 1], concatenated
    and L1-normalized."""
    img = np.clip(np.asarray(img, np.float64), 0.0, 1.0)
    hs = [np.histogram(img[..., c].ravel(), bins=nbins, range=(0, 1))[0]
          for c in range(img.shape[-1])]
    h = np.concatenate(hs).astype(np.float64)
    return h / (h.sum() + 1e-12)


def texture_stats_distance(a: np.ndarray, b: np.ndarray) -> dict:
    """{'spectrum_l1', 'color_l1'}: L1 distances between two textures'
    radial power spectra and colour histograms (0: the same statistics)."""
    return {
        "spectrum_l1": float(np.abs(radial_power_spectrum(a)
                                    - radial_power_spectrum(b)).sum()),
        "color_l1": float(np.abs(color_histogram(a)
                                 - color_histogram(b)).sum()),
    }


def texture_baselines(ex: np.ndarray) -> dict:
    """The calibration of ``texture_eval``: the exemplar [H, W, 3] against a
    circular shift of itself (the floor: 0), a 4x blur of itself (a
    same-family anchor), flat gray and uniform noise (ceilings)."""
    blur = _resize_np(_resize_np(ex, (ex.shape[0] // 4, ex.shape[1] // 4)),
                      ex.shape[:2])
    noise = np.random.default_rng(1).uniform(size=ex.shape).astype(
        np.float32)
    return {
        "baseline_self": texture_stats_distance(
            ex, np.roll(ex, (ex.shape[0] // 3, ex.shape[1] // 3), (0, 1))),
        "baseline_blur4x": texture_stats_distance(ex, blur),
        "baseline_gray": texture_stats_distance(ex, np.full_like(ex, 0.5)),
        "baseline_noise": texture_stats_distance(ex, noise),
    }


def texture_eval(params, cfg, h: float, exemplar: np.ndarray, *,
                 base_size: int = 100, steps: int = 96,
                 densities=(1.0, 2.0), jitters=(0.0, 0.5), seed: int = 0,
                 use_3d: bool = True, device="cuda") -> dict:
    """Exemplar-texture quality without pixel alignment: roll the model out
    from random states on a periodic plane at each density and jitter,
    render, and score ``texture_stats_distance`` against the exemplar
    [H, W, >=3], beside ``texture_baselines``. The rollouts draw in turn
    from one generator seeded with ``seed``."""
    from .utils.geometry import grange

    device = resolve_device(device)
    ex = np.asarray(exemplar, np.float32)[..., :3]
    out_size = min(ex.shape[0], ex.shape[1])
    results = texture_baselines(ex)
    results["sweep"] = []
    gen = torch.Generator(device=device).manual_seed(seed)
    rng = np.random.default_rng(seed)
    # the wrapped training geometry: z wraps at 2 too when 3D-embedded
    period = (2.0, 2.0, 2.0) if use_3d else (2.0, 2.0)
    for dens in densities:
        side = int(round(base_size * float(dens) ** 0.5))
        x2 = grange((side, side), (-1.0, -1.0), (2.0, 2.0)).reshape(
            -1, 2).numpy()
        for jit in jitters:
            xj = x2
            if jit > 0:
                spacing = 2.0 / side
                xj = x2 + rng.uniform(-jit * spacing / 2, jit * spacing / 2,
                                      x2.shape).astype(np.float32)
            rgba = rollout_on_points(params, cfg, xj, h, steps, gen,
                                     use_3d=use_3d, period=period,
                                     randomized=True)
            img = render_points(np.mod(xj + 1.0, 2.0) - 1.0,
                                np.clip(rgba[:, :3], 0, 1), out_size)
            entry = {"density": float(dens), "jitter": float(jit)}
            entry.update(texture_stats_distance(img, ex))
            results["sweep"].append(entry)
    return results
