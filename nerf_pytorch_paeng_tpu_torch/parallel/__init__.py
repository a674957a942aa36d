"""Data parallelism over ``torch.distributed`` (counterpart of the JAX
package's ``parallel/``, its data axis only).

``mesh``: the launch contract (torchrun's variables), the process group
and the rank's device.  ``sharding``: each rank's slice of a batch, the
weighted gradient and metric reductions of the train step, the gather of
a frame block's parts, the broadcasts that keep the ranks' host
decisions alike, and rank 0 going first where a loader writes.  No DDP
wrapper: the train step reaches the kernels' autograd pair outside
``model.forward``, so it all-reduces one flat gradient buffer itself
after ``backward``.
"""
from .mesh import (LAUNCH_ENV, check_data_shards, destroy, free_port,
                   is_distributed, is_main, maybe_initialize_distributed,
                   print0, rank, world_size)
from .sharding import (all_reduce_grads, all_reduce_sum, broadcast0,
                       check_replicas, gather_rows, rank0_first, rank_bounds)

__all__ = ["LAUNCH_ENV", "all_reduce_grads", "all_reduce_sum", "broadcast0",
           "check_data_shards", "check_replicas", "destroy", "free_port",
           "gather_rows", "is_distributed", "is_main",
           "maybe_initialize_distributed", "print0", "rank", "rank0_first",
           "rank_bounds", "world_size"]
