"""sph_nca_tpu_torch.ops — SPH operators, the three neighbour engines and
the pair-pass kernels.

Counterpart of ``sph_nca_tpu.ops`` (the same public names, in its order):

  kernels.py       the smoothing and gradient kernel functions
  hashgrid.py      the graph engine: fixed-K neighbour lists built on the
                   positions' device, ``SPHGraph``
  neighbor_ops.py  the graph SPH operators (volume, gradient, divergence,
                   count, blur)
  dense.py         the all-pairs oracle of the same operators
  cells.py         the cell engine (``build_cell_engine``)
  bands.py         the band engine (``build_band_engine``, host-built over
                   ``native/``)
  batched.py       the batched-lane layout and its pair passes
  pair_kernel.py   the wrappers of the pair kernels 2.1-2.7
  mlp_kernel.py    the wrapper of the update-MLP kernel 2.8
  gather.py        gathers over static index maps with a fixed-order
                   backward
  _build.py        the nvcc build of ``csrc/`` into one library

Importing this package builds nothing: ``_build`` compiles the CUDA library
and ``native`` the host library at their first use.
"""

from . import dense
from .bands import BandEngine, build_band_engine
from .batched import (
    batched_gather_back,
    batched_scatter,
    blur_batched,
    mask_blur_batched,
    perceive_cells_batched,
)
from .cells import CellEngine, build_cell_engine
from .kernels import (
    DEFAULT_GRADIENT,
    DEFAULT_SMOOTHING,
    get_gradient_kernel,
    get_smoothing_kernel,
)
from .hashgrid import (
    NeighborList,
    SPHGraph,
    build_graph,
    build_neighbor_list,
    cell_index,
    default_dims,
    graph_from_neighbor_list,
    minimum_image,
    suggest_capacity,
)
from .neighbor_ops import (
    blur,
    count,
    divergence,
    gradient,
    graph_blur,
    graph_divergence,
    graph_gradient,
    volume,
)

__all__ = [
    "BandEngine",
    "CellEngine",
    "build_band_engine",
    "DEFAULT_GRADIENT",
    "DEFAULT_SMOOTHING",
    "NeighborList",
    "SPHGraph",
    "blur",
    "build_cell_engine",
    "build_graph",
    "build_neighbor_list",
    "cell_index",
    "count",
    "default_dims",
    "dense",
    "divergence",
    "get_gradient_kernel",
    "get_smoothing_kernel",
    "gradient",
    "graph_blur",
    "graph_divergence",
    "graph_from_neighbor_list",
    "graph_gradient",
    "minimum_image",
    "suggest_capacity",
    "volume",
]
