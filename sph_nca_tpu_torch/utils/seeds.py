"""Seeding: counterpart of ``sph_nca_tpu/utils/seeds.py`` (the radial seed and
``plane_seed``, radial or random), and the two surface seeds of the JAX test
CLI's surface mode (``sph_nca_tpu/cli/test.py:181-213``).

Random draws come from an explicit ``torch.Generator``: the laws of the JAX
package (uniform features, standard-normal tangent draws), other streams.
Numpy draws (the random surface seed's points) are the JAX CLI's own."""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch


def radial_seed_weights(x: torch.Tensor, center: torch.Tensor,
                        radius: float) -> torch.Tensor:
    """w = clamp(1 - d^2/R^2, 0, 1)^3 around ``center``."""
    d2 = torch.sum((x - center) ** 2, dim=-1)
    w = torch.clamp(1.0 - d2 / radius**2, 0.0, 1.0)
    return w * w * w


def add_radial_seed(x: torch.Tensor, A: torch.Tensor, center, radius: float,
                    texture: Optional[torch.Tensor] = None) -> torch.Tensor:
    """A + texture * w (texture defaults to ones); returns a new tensor."""
    center = torch.as_tensor(center, dtype=x.dtype, device=x.device)
    w = radial_seed_weights(x, center, radius)
    if texture is None:
        texture = torch.ones_like(A)
    return A + texture * w[..., None]


def plane_seed(x: torch.Tensor, channels: int, *, gmin, gsize,
               radius: float, randomized: bool = False,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """The train / test CLI seed: zeros plus a radial seed at the domain
    centre, or with ``randomized`` uniform features in [0, 1) drawn from
    ``generator`` on its own device (the JAX package's
    ``jax.random.uniform``: the same law, another stream)."""
    if randomized:
        if generator is None:
            raise ValueError("plane_seed(randomized=True) needs a generator")
        return torch.rand((x.shape[0], channels), generator=generator,
                          device=generator.device).to(x.device)
    A = torch.zeros((x.shape[0], channels), dtype=x.dtype, device=x.device)
    center = (torch.as_tensor(gmin, dtype=x.dtype)
              + torch.as_tensor(gsize, dtype=x.dtype) / 2.0)
    return add_radial_seed(x, A, center, radius)


def surface_radial_seed(x: torch.Tensor, normals: torch.Tensor, channels: int,
                        n_seeds: int, radius: float,
                        generator: torch.Generator
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The radial seed of a surface rollout, as the JAX test CLI's surface
    mode makes it (``--initial_feature radial``): ``n_seeds`` seed points by
    farthest-point sampling from point 0, a radial seed of ``radius`` around
    each, and at each seed point a tangent orthogonal to its normal, drawn
    from a standard normal (``generator``); zero tangents elsewhere.
    x, normals [N, 3] -> (A0 [N, channels], t0 [N, 3])."""
    from ..models.surface import orthogonalize
    from .meshes import farthest_point_sampling

    A = torch.zeros((x.shape[0], channels), dtype=x.dtype, device=x.device)
    t = torch.zeros_like(normals)
    for i in farthest_point_sampling(x, n_seeds).tolist():
        A = add_radial_seed(x, A, x[i], radius)
        draw = torch.randn(3, generator=generator,
                           device=generator.device).to(x.device)
        t[i] = orthogonalize(normals[i], draw)
    return A, t


def surface_random_seed(x: torch.Tensor, normals: torch.Tensor,
                        channels: int, rng: np.random.Generator,
                        generator: torch.Generator, blur_engine,
                        passes: int, *, n_seeds: int = 10,
                        use_kernels: bool = True
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The random surface seed, as the JAX test CLI's surface mode makes it
    (``--initial_feature random``, ``sph_nca_tpu/cli/test.py:181-203``):
    at ``n_seeds`` points drawn by ``rng.integers`` (the JAX CLI's numpy
    draws) a tangent orthogonal to the normal, drawn from a standard normal
    (``generator``); ``passes`` pre-diffusion passes of that tangent field
    at lerp 0 on unit activity; uniform features from ``generator``.

    ``blur_engine`` is an engine on x at the seeding radius 0.2: a band
    engine, as the JAX CLI's, or a cell engine with the poly6 table. The JAX
    CLI also adds radial seeds of radius 0.2 at the drawn points before it
    overwrites the state with the uniform draw; they change nothing and
    are left out. x, normals [N, 3] -> (A0 [N, channels], t0 [N, 3])."""
    from ..models.surface import orthogonalize

    t = torch.zeros_like(normals)
    for _ in range(n_seeds):
        i = int(rng.integers(x.shape[0]))
        draw = torch.randn(3, generator=generator,
                           device=generator.device).to(x.device)
        t[i] = orthogonalize(normals[i], draw)
    t = prediffuse_tangents(blur_engine, normals, t, passes,
                            use_kernels=use_kernels)
    A = torch.rand((x.shape[0], channels), generator=generator,
                   device=generator.device).to(x.device)
    return A, t


def prediffuse_tangents(eng, normals: torch.Tensor, t: torch.Tensor,
                        passes: int, *,
                        use_kernels: bool = True) -> torch.Tensor:
    """``passes`` tangent diffusions at lerp 0 on unit activity: the random
    surface seed's consistent tangent field. On a band engine the JAX CLI's
    ``diffuse_band`` loop, in particle order; on a cell engine the blur over
    its poly6 table (kernel 2.7). normals, t [N, 3] in particle order ->
    [N, 3]."""
    from ..models.surface import diffuse_band, diffuse_cells
    from ..ops.bands import BandEngine

    if isinstance(eng, BandEngine):
        ones = torch.ones(t.shape[0], 4, dtype=t.dtype, device=t.device)
        for _ in range(passes):
            t = diffuse_band(eng, normals, t, ones, lerp_multiplier=0.0)
        return t
    nc, tc = eng.scatter(normals), eng.scatter(t)
    ones = eng.scatter(torch.ones(t.shape[0], 4, dtype=t.dtype,
                                  device=t.device))
    for _ in range(passes):
        tc = diffuse_cells(eng, nc, tc, ones, lerp_multiplier=0.0,
                           use_kernels=use_kernels)
    return eng.gather_back(tc)
