"""floodseg_tpu_torch — the PyTorch / CUDA port of floodseg_tpu for NVIDIA Hopper.

A second package beside the JAX one. It imports ``torch`` and never ``jax``
nor anything of ``floodseg_tpu``; what it needs of the JAX package's
numpy-only modules it keeps as its own copies. Module names mirror the JAX
package, so ``floodseg_tpu/ops/grid_sample.py`` has its counterpart in
``floodseg_tpu_torch/ops/grid_sample.py``.

Public functions keep the JAX package's NHWC layout. Entry points run on
``cuda`` unless the caller passes ``device="cpu"`` (core/device.py).

Layout:
  core/    device resolution and the float policy
  csrc/    hand-written CUDA kernels for sm_90a (built with nvcc on first use)
  ops/     resize, pooling, the plain warp, int8 quantization of the decoders,
           the kernels' wrappers (warp_kernels: K1, K2; resize_kernels: K3)
  models/  PSPNet, DeepLabV3 and the Segmenter ViT (eval) with the
           reference's torch key names, and the weight bridge
  video/   block-MV grid algebra and the keyframe-warp interpolator
  train/   flow-predict program builders
  data/    normalisation constants, frame resize, in-memory synthetic clips
"""

__version__ = "0.1.0"
