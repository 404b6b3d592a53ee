"""Multi-device runs: particle-axis sharding (sharding.py) and the
domain-decomposed engine with particle migration (decompose.py,
migrate.py), mirrors of mops_tpu.parallel.

In one process a shard's tensors live on its entry of a device list, in
which entries may repeat (eight shards on one card, or ``["cpu"] * 8`` on
the CPU): the counterpart of mops_tpu's device mesh.  The multi-process
form (distributed.py, the counterpart of ``jax.distributed``) gives each
rank of a torch.distributed group a part of that list: both engines take
``group=``, and ``gather_trajectories`` / ``gather_migrating`` put the
whole on one rank (``python -m mops_tpu_torch.parallel.dist_smoke``).
"""

from .decompose import DecomposedMesh, decompose, partition_cells
from .distributed import (exchange_blocks, gather_trajectories,
                          init_distributed, rank_bounds)
from .migrate import (MigratingTrajectories, gather_migrating, reassemble,
                      run_advection_migrating)
from .sharding import device_list, run_advection_sharded, shard_particles

__all__ = ["DecomposedMesh", "MigratingTrajectories", "decompose",
           "device_list", "exchange_blocks", "gather_migrating",
           "gather_trajectories", "init_distributed", "partition_cells",
           "rank_bounds", "reassemble", "run_advection_migrating",
           "run_advection_sharded", "shard_particles"]
