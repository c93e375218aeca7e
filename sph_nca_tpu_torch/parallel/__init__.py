"""sph_nca_tpu_torch.parallel — the (data, particle) mesh, the sharded paths
and the sharded training step, on ``torch.distributed``, one process a rank.

Counterpart of ``sph_nca_tpu.parallel`` (the same public names):

  mesh.py        the mesh (a ``DeviceMesh``) and what each rank holds
  comm.py        the collectives (autograd ``all_gather`` / ``ppermute``,
                 host staging for gloo on CUDA) and ``run_ranks``
  band_shard.py  the halo-sharded band engine and its rollouts
  cell_shard.py  the cell engine's pair kernels on each rank's blocks
  shard.py       the graph engine's data x particle training step
  dryrun.py      ``python -m sph_nca_tpu_torch.parallel.dryrun``: the JAX
                 package's five sharded dry-run paths
"""

from .mesh import (
    DATA_AXIS,
    PARTICLE_AXIS,
    batch_state_spec,
    factorize,
    graph_spec,
    make_mesh,
    replicate,
    replicated_spec,
    shard_batch,
    shard_cell_engine,
    shard_graph,
)
from .band_shard import (
    BandShards,
    comm_bytes_per_pass,
    perceive_band_sharded,
    rollout_band_sharded,
    shard_band_engine,
)
from .cell_shard import mask_blur_sharded, perceive_cells_dmajor_sharded
from .shard import ShardedTrainStep, dryrun_train_step, make_sharded_train_step

__all__ = [
    "DATA_AXIS",
    "PARTICLE_AXIS",
    "BandShards",
    "ShardedTrainStep",
    "comm_bytes_per_pass",
    "perceive_band_sharded",
    "rollout_band_sharded",
    "shard_band_engine",
    "mask_blur_sharded",
    "perceive_cells_dmajor_sharded",
    "batch_state_spec",
    "dryrun_train_step",
    "factorize",
    "graph_spec",
    "make_mesh",
    "make_sharded_train_step",
    "replicate",
    "replicated_spec",
    "shard_batch",
    "shard_cell_engine",
    "shard_graph",
]
