"""Data parallelism over ranks, one process a GPU (counterpart of
floodseg_tpu/parallel/): the rendezvous (dist.py) and the world, the
batch's shards, the collectives of the global-batch step and the
data-parallel predict (mesh.py)."""

from floodseg_tpu_torch.parallel.dist import maybe_initialize_multihost
from floodseg_tpu_torch.parallel.mesh import (
    World,
    all_reduce_,
    all_reduce_array,
    all_reduce_sum,
    barrier,
    current_world,
    gather,
    make_dp_predict_fn,
    resolve_num_devices,
    shard,
    shard_batch,
    sum_gradients,
)

__all__ = ["World", "all_reduce_", "all_reduce_array", "all_reduce_sum", "barrier",
           "current_world", "gather", "make_dp_predict_fn",
           "maybe_initialize_multihost", "resolve_num_devices", "shard", "shard_batch",
           "sum_gradients"]
