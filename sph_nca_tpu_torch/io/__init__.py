"""sph_nca_tpu_torch.io — checkpoints, JSON weights and weights carried
across from the JAX package.

Counterpart of ``sph_nca_tpu.io`` (its public names, in its order), apart
from ``restore_opt_state``, which lays a raw state dict onto a fresh optax
state tree with flax; the port restores an optimizer from that tree with
``checkpoint.load_optax_state``, which is not the same call and is not
exported under that name.

  checkpoint.py    checkpoints in the JAX package's layout and the resume
                   state
  msgpack.py       the flax-free msgpack codec of those checkpoints
  weights_json.py  the reference demo's JSON weights
  convert.py       JAX parameters, graphs and neighbour lists as tensors
"""

from .checkpoint import (
    find_latest_resumable,
    has_resume_state,
    load_checkpoint,
    load_resume_state,
    save_checkpoint,
    save_resume_state,
)
from .weights_json import ImportedModel, load_weights_json, save_weights_json

__all__ = [
    "ImportedModel",
    "find_latest_resumable",
    "has_resume_state",
    "load_checkpoint",
    "load_resume_state",
    "load_weights_json",
    "save_checkpoint",
    "save_resume_state",
    "save_weights_json",
]
