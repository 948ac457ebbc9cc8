"""Multi-device training over torch.distributed process groups
(counterpart of kpgnn_tpu/parallel): data-parallel steps (dp.py),
node-sharded steps with a halo exchange (partition.py), multi-host input
sharding (multihost.py) and the process group itself (mesh.py).  The JAX
package's ``stack_batches`` and ``batch_pspecs`` build ``shard_map``'s
stacked inputs and specs; with one process per rank each rank holds its
own batch, so they have no counterpart."""
from .dp import make_parallel_eval_step, make_parallel_train_step, shard_loader
from .mesh import Mesh, make_mesh, spawn
from .partition import (make_sharded_eval_step, make_sharded_train_step,
                        partition_adj, partition_batch, partition_loader)

__all__ = ["Mesh", "make_mesh", "spawn", "make_parallel_train_step",
           "make_parallel_eval_step", "shard_loader", "partition_adj",
           "partition_batch", "partition_loader", "make_sharded_train_step",
           "make_sharded_eval_step"]
