"""The device mesh over ``torch.distributed`` (counterpart of the JAX
package's ``parallel/``): data parallelism, the width-sharded MLP and the
sample-sharded frame.

``mesh``: the launch contract (torchrun's variables), the process group,
the rank's device and the ``n_data`` x ``n_model`` rank layout with its
data and model groups.  ``sharding``: each rank's slice of a batch, the
weighted gradient and metric reductions of the train step, the gather of
a frame block's parts, the broadcasts that keep the ranks' host
decisions alike, and rank 0 going first where a loader writes.  No DDP
wrapper: the train step reaches the kernels' autograd pair outside
``model.forward``, so it all-reduces one flat gradient buffer itself
after ``backward``.  ``tensor``: the width-sharded (tensor-parallel)
MLP, its partition rule and the shard/gather of weights and Adam's
moments.  ``sp``: the sample-sharded compositing and render.
"""
from .mesh import (LAUNCH_ENV, Group, Layout, check_data_shards,
                   data_group, destroy, free_port, init_layout,
                   is_distributed, is_main, layout,
                   maybe_initialize_distributed, model_group, print0, rank,
                   world_group, world_size)
from .sharding import (all_gather_cat, all_reduce_grads, all_reduce_sum,
                       broadcast0, check_replicas, gather_rows, rank0_first,
                       rank_bounds)

__all__ = ["LAUNCH_ENV", "Group", "Layout", "all_gather_cat",
           "all_reduce_grads", "all_reduce_sum", "broadcast0",
           "check_data_shards", "check_replicas", "data_group", "destroy",
           "free_port", "gather_rows", "init_layout", "is_distributed",
           "is_main", "layout", "maybe_initialize_distributed",
           "model_group", "print0", "rank", "rank0_first", "rank_bounds",
           "world_group", "world_size"]
