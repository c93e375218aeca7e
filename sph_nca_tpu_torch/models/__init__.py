"""sph_nca_tpu_torch.models — the NCA model, its steps and rollouts on the
three engines, and the surface mode.

Counterpart of ``sph_nca_tpu.models`` (the same public names, in its order):

  nca.py        the model (``SPHNCAConfig``, ``MLPParams``), perception, the
                update MLP and the graph engine's step
  cell_step.py  the cell and band engines' steps and rollouts, unbatched and
                batched (the update MLP is kernel 2.8)
  rollout.py    the graph engine's rollouts (``rollout_states`` and the
                rebuild rollout)
  surface.py    tangent frames, diffusion and the surface rollouts
"""

from .nca import (
    ALIVE_THRESHOLD,
    MLPParams,
    SPHNCAConfig,
    apply_mlp,
    cell_activity,
    init_params,
    life_mask,
    nca_step,
    num_params,
    perceive,
    to_rgba,
)
from .cell_step import nca_step_cells, rollout_cells
from .rollout import RolloutOut, rollout, rollout_batch, rollout_states
from .surface import (
    DIFFUSE_DIMS,
    DIFFUSE_H,
    diffuse,
    normalize,
    orthogonalize,
    project_tangent_space,
    rollout_mesh,
    tangent_perception,
)

__all__ = [
    "ALIVE_THRESHOLD",
    "DIFFUSE_DIMS",
    "DIFFUSE_H",
    "MLPParams",
    "RolloutOut",
    "SPHNCAConfig",
    "apply_mlp",
    "cell_activity",
    "diffuse",
    "init_params",
    "life_mask",
    "nca_step",
    "nca_step_cells",
    "normalize",
    "num_params",
    "orthogonalize",
    "perceive",
    "project_tangent_space",
    "rollout",
    "rollout_cells",
    "rollout_batch",
    "rollout_mesh",
    "rollout_states",
    "tangent_perception",
    "to_rgba",
]
