"""sph_nca_tpu_torch.utils — grids, seeds, ragged batches, meshes, images
and step timing.

Counterpart of ``sph_nca_tpu.utils`` (the same public names, in its order):

  geometry.py   grids and bilinear / trilinear sampling
  seeds.py      plane, radial and surface seeds
  batching.py   pack / unpack and padding of ragged point clouds
  meshes.py     OBJ / PLY reading, surface sampling
  image.py      targets (PNG / ``.npy``), PNG writing, emoji
  profiling.py  ``StepTimer``, ``device_sync``, ``trace``, ``MetricsLogger``;
                the port's spans and counters (``span``, ``count``,
                ``recording``), outside ``__all__``

The JAX package's ``cache.py`` and its profiling module's
``select_platform`` / ``enable_compilation_cache`` set XLA's runtime state
and have no counterpart here.
"""

from . import batching, profiling  # noqa: F401  (the helpers' modules)
from .geometry import bilinear_sample, grange, trilinear_sample
from .seeds import add_radial_seed, plane_seed, radial_seed_weights

__all__ = [
    "add_radial_seed",
    "bilinear_sample",
    "grange",
    "plane_seed",
    "radial_seed_weights",
    "trilinear_sample",
]
