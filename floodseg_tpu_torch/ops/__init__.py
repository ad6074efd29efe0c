from floodseg_tpu_torch.ops import resize_kernels, warp_kernels
from floodseg_tpu_torch.ops.grid_sample import (
    grid_sample,
    grid_sample_backward,
    grid_sample_matmul,
)
from floodseg_tpu_torch.ops.pool import adaptive_avg_pool, global_avg_pool, max_pool
from floodseg_tpu_torch.ops.quant import (
    conv_int8,
    fold_bn,
    int8_deeplab_decode,
    int8_resnet_trunk,
    int8_seghead_decode,
    ppm_folded,
    quantize_activation_dynamic,
    quantize_weight_per_channel,
    quantize_with_scale,
    scale_from_absmax,
    seghead_decode_folded_f32,
)
from floodseg_tpu_torch.ops.resize import resize_argmax, resize_bilinear
from floodseg_tpu_torch.ops.resize_kernels import (
    resize_quantize_int8_cuda,
    resize_quantize_int8_plain,
)
from floodseg_tpu_torch.ops.warp_kernels import (
    grid_sample_autograd,
    grid_sample_backward_cuda,
    grid_sample_cuda,
    warp_chain_cuda,
    warp_chain_plain,
)


def launch_counts() -> dict:
    """Launches of every hand-written kernel since the last reset."""
    return {**warp_kernels.launch_counts(), **resize_kernels.launch_counts()}


def reset_launch_counts() -> None:
    warp_kernels.reset_launch_counts()
    resize_kernels.reset_launch_counts()


__all__ = [
    "adaptive_avg_pool",
    "conv_int8",
    "fold_bn",
    "global_avg_pool",
    "grid_sample",
    "grid_sample_autograd",
    "grid_sample_backward",
    "grid_sample_backward_cuda",
    "grid_sample_cuda",
    "grid_sample_matmul",
    "int8_deeplab_decode",
    "int8_resnet_trunk",
    "int8_seghead_decode",
    "launch_counts",
    "max_pool",
    "ppm_folded",
    "quantize_activation_dynamic",
    "quantize_weight_per_channel",
    "quantize_with_scale",
    "reset_launch_counts",
    "resize_argmax",
    "resize_bilinear",
    "resize_quantize_int8_cuda",
    "resize_quantize_int8_plain",
    "scale_from_absmax",
    "seghead_decode_folded_f32",
    "warp_chain_cuda",
    "warp_chain_plain",
]
