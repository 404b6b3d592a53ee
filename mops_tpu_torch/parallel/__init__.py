"""Multi-device runs: particle-axis sharding (sharding.py) and the
domain-decomposed engine with particle migration (decompose.py,
migrate.py), mirrors of mops_tpu.parallel.

One process owns every shard.  A shard's tensors live on its entry of a
device list, in which entries may repeat (eight shards on one card, or
``["cpu"] * 8`` on the CPU): the counterpart of mops_tpu's device mesh.
"""

from .decompose import DecomposedMesh, decompose, partition_cells
from .migrate import (MigratingTrajectories, reassemble,
                      run_advection_migrating)
from .sharding import device_list, run_advection_sharded, shard_particles

__all__ = ["DecomposedMesh", "MigratingTrajectories", "decompose",
           "device_list", "partition_cells", "reassemble",
           "run_advection_migrating", "run_advection_sharded",
           "shard_particles"]
