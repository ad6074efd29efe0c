"""floodseg_tpu_torch — the PyTorch / CUDA port of floodseg_tpu for NVIDIA Hopper.

A second package beside the JAX one. It imports ``torch`` and never ``jax``
nor anything of ``floodseg_tpu``; what it needs of the JAX package's
numpy-only modules it keeps as its own copies. Module names mirror the JAX
package, so ``floodseg_tpu/ops/grid_sample.py`` has its counterpart in
``floodseg_tpu_torch/ops/grid_sample.py``.

Public functions keep the JAX package's NHWC layout. Entry points run on
``cuda`` unless the caller passes ``device="cpu"`` (core/device.py).

Layout:
  cli/     the command line (main.py: fit, validate, test, predict) and the
           Runner over the train entry points (runner.py)
  core/    device resolution, the float policy, the phase profiler; the
           layered YAML config and its YAML reader, checkpoints, run logging
  csrc/    hand-written CUDA kernels for sm_90a (built with nvcc on first use)
           and the host image codec (jpeg.cpp, built with the host compiler)
  ops/     resize, pooling, the plain warp and its backward, int8
           quantization of the decoders, the losses, segmentation metrics,
           the kernels' wrappers (warp_kernels: K1, K1-bwd and the
           differentiable warp, K2; resize_kernels: K3)
  models/  PSPNet, DeepLabV3 and the Segmenter ViT, each in eval and
           training mode, with the reference's torch key names, the
           weight bridge, and the reference checkpoints' import
  video/   block-MV grid algebra (with the crop renormalisation) and the
           keyframe-warp interpolator, predict and training
  train/   flow-predict program builders (whole windows, cached, crops), the
           sliding-window predict, run_predict and run_flow_predict; the
           optimizers, the train state, the supervised and flow train and
           eval steps, run_fit and run_flow_fit
  data/    JPEG/PNG codec and MJPG AVI, the predict and train transforms
           (cv2's arithmetic without cv2), SemDataset, FlowDataset, collate, the
           prefetching DataLoader and device_put, synthetic clips in memory
           and as a dataset tree
"""

__version__ = "0.1.0"
