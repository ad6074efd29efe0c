from floodseg_tpu_torch.ops.grid_sample import grid_sample
from floodseg_tpu_torch.ops.pool import adaptive_avg_pool, max_pool
from floodseg_tpu_torch.ops.resize import resize_argmax, resize_bilinear
from floodseg_tpu_torch.ops.warp_kernels import (
    grid_sample_cuda,
    launch_counts,
    reset_launch_counts,
    warp_chain_cuda,
    warp_chain_plain,
)

__all__ = [
    "adaptive_avg_pool",
    "grid_sample",
    "grid_sample_cuda",
    "launch_counts",
    "max_pool",
    "reset_launch_counts",
    "resize_argmax",
    "resize_bilinear",
    "warp_chain_cuda",
    "warp_chain_plain",
]
