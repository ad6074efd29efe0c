"""The fused resize + int8 quantize kernel K3: wrapper, plain version, launch count.

Counterpart of floodseg_tpu/ops/pallas_resize.py. The kernel is CUDA C++
for sm_90a in ``csrc/resize.cu`` (its note there gives the Pallas kernel it
replaces, its bound on the card and what the design does about it).

- K3 ``resize_quantize_int8_cuda(x, scale, out_hw, align_corners)`` replaces
  ``resize_quantize_int8``; its plain version is
  ``resize_quantize_int8_plain``, the composition
  ``quantize_with_scale(resize_bilinear(x, out_hw, align, fast_lowp=True), scale)``.

The wrapper checks device, dtype (float32 or bfloat16; the scale a float32
tensor of one element), shape and contiguity and raises on anything its
kernel does not take. For tensors on the CPU it then computes the plain
version; for CUDA tensors it launches the kernel on the current stream, or
raises. The scale stays on the device: the kernel reads it through a
pointer, so nothing synchronises. The wrapper counts its launches in
``resize_quantize_int8_cuda.launches``, which ``reset_launch_counts`` sets
back to 0. While a profiler records, a launch is a host op named after the
wrapper (core/profiler.py::kernel_launch).
"""

import ctypes

import torch

from floodseg_tpu_torch.core.profiler import kernel_launch
from floodseg_tpu_torch.ops import build
from floodseg_tpu_torch.ops.quant import quantize_with_scale
from floodseg_tpu_torch.ops.resize import resize_bilinear, tap_tensors

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_VEC_CHANNELS = 16     # channels a thread in csrc/resize.cu's vector path
_VEC_BYTES = 16


def _library():
    lib = build.load("resize")
    if not getattr(lib, "_floodseg_bound", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.floodseg_resize_quantize.argtypes = [p, p, p, p, p, p, p,
                                                 i, i, i, i, i, i, i, i, p]
        lib.floodseg_resize_quantize.restype = i
        lib._floodseg_bound = True
    return lib


def vector_path(x: torch.Tensor) -> bool:
    """Whether K3 takes x 16 channels a thread (C a multiple of 16, the data
    16-byte aligned) or one channel a thread."""
    return x.shape[-1] % _VEC_CHANNELS == 0 and x.data_ptr() % _VEC_BYTES == 0


def resize_quantize_int8_plain(x: torch.Tensor, scale: torch.Tensor, out_hw,
                               align_corners: bool = True) -> torch.Tensor:
    """Plain version of K3: the composition it fuses, as written."""
    y = resize_bilinear(x, out_hw, align_corners, fast_lowp=True)
    return quantize_with_scale(y, scale)


def resize_quantize_int8_cuda(x: torch.Tensor, scale: torch.Tensor, out_hw,
                              align_corners: bool = True) -> torch.Tensor:
    """K3: x (B, h, w, C) float32 or bfloat16, scale a float32 tensor of one
    element -> int8 (B, H, W, C) = clip(rint(resize(x) / scale), +-127)."""
    if x.dim() != 4:
        raise ValueError(f"resize_quantize_int8_cuda: x must be (B, h, w, C), "
                         f"got {tuple(x.shape)}")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"resize_quantize_int8_cuda: x must be float32 or "
                        f"bfloat16, got {x.dtype}")
    if not torch.is_tensor(scale) or scale.dtype != torch.float32 or scale.numel() != 1:
        raise TypeError("resize_quantize_int8_cuda: scale must be a float32 "
                        "tensor of one element")
    hh, ww = int(out_hw[0]), int(out_hw[1])
    if hh <= 0 or ww <= 0:
        raise ValueError(f"resize_quantize_int8_cuda: bad output size {out_hw}")
    if not x.is_contiguous():
        raise ValueError("resize_quantize_int8_cuda: x must be contiguous")
    if x.device.type == "cpu" and scale.device.type == "cpu":
        return resize_quantize_int8_plain(x, scale, (hh, ww), align_corners)
    if x.device != scale.device or x.device.type != "cuda":
        raise ValueError(f"resize_quantize_int8_cuda: x on {x.device} and scale "
                         f"on {scale.device}; both must be on one CUDA device "
                         "or both on the CPU")
    b, h, w, c = x.shape
    out = torch.empty((b, hh, ww, c), dtype=torch.int8, device=x.device)
    if out.numel() == 0:
        return out
    h_idx, h_w = tap_tensors(h, hh, bool(align_corners), x.dtype, x.device)
    w_idx, w_w = tap_tensors(w, ww, bool(align_corners), x.dtype, x.device)
    with torch.cuda.device(x.device), kernel_launch("resize_quantize_int8_cuda"):
        err = _library().floodseg_resize_quantize(
            x.data_ptr(), scale.data_ptr(), h_idx.data_ptr(), h_w.data_ptr(),
            w_idx.data_ptr(), w_w.data_ptr(), out.data_ptr(), b, h, w, c, hh, ww,
            _DTYPE_CODES[x.dtype], int(vector_path(x)),
            torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"resize_quantize_int8_cuda: CUDA launch failed with "
                           f"error {err}")
    resize_quantize_int8_cuda.launches += 1
    return out


resize_quantize_int8_cuda.launches = 0


def reset_launch_counts() -> None:
    resize_quantize_int8_cuda.launches = 0


def launch_counts() -> dict:
    return {"resize_quantize_int8_cuda": resize_quantize_int8_cuda.launches}
