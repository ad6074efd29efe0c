"""Bilinear resize as separable matrix products (NHWC).

Counterpart of floodseg_tpu/ops/resize.py. The row and column interpolation
matrices are built once per (in, out, align) in float64 and cast to the
compute dtype; the two contractions are plain ``torch.einsum`` products,
as the JAX package leaves them to XLA. Matches
``torch.nn.functional.interpolate(mode="bilinear", align_corners=...)`` up
to float associativity.
"""

from functools import lru_cache

import numpy as np
import torch


@lru_cache(maxsize=256)
def _interp_matrix(in_size: int, out_size: int, align_corners: bool) -> np.ndarray:
    """(out_size, in_size) row-stochastic bilinear interpolation matrix."""
    m = np.zeros((out_size, in_size), dtype=np.float64)
    if in_size == 1:
        m[:, 0] = 1.0
        return m
    i = np.arange(out_size, dtype=np.float64)
    if align_corners:
        if out_size == 1:
            src = np.zeros(1, dtype=np.float64)
        else:
            src = i * (in_size - 1) / (out_size - 1)
    else:
        # half-pixel centers; edge values replicate (torch/cv2 semantics)
        src = (i + 0.5) * in_size / out_size - 0.5
    i0 = np.floor(src).astype(np.int64)
    w1 = (src - i0).astype(np.float64)
    i1 = np.clip(i0 + 1, 0, in_size - 1)
    i0 = np.clip(i0, 0, in_size - 1)
    np.add.at(m, (np.arange(out_size), i0), 1.0 - w1)
    np.add.at(m, (np.arange(out_size), i1), w1)
    return m


def _compute_dtype(dtype: torch.dtype) -> torch.dtype:
    """float32 for bf16/f16/f32 inputs, float64 for float64 (the JAX
    package's ``promote_types(dtype, float32)``)."""
    return torch.promote_types(dtype, torch.float32)


@lru_cache(maxsize=256)
def _interp_tensor(in_size, out_size, align_corners, dtype, device):
    # cached on the device: a fresh host-to-device copy of pageable memory
    # on every call would wait for the stream and stall the launch queue
    return torch.as_tensor(_interp_matrix(in_size, out_size, align_corners),
                           dtype=dtype, device=device)


def _matrices(h_in, w_in, h_out, w_out, align_corners, dtype, device):
    return (_interp_tensor(h_in, h_out, align_corners, dtype, device),
            _interp_tensor(w_in, w_out, align_corners, dtype, device))


def resize_bilinear(x: torch.Tensor, size, align_corners: bool = True) -> torch.Tensor:
    """Bilinearly resize NHWC (or HWC) ``x`` to spatial ``size=(H, W)``.

    Computes in float32 for bf16 and float32 inputs and casts the result back
    to the input dtype.
    """
    h_out, w_out = int(size[0]), int(size[1])
    squeeze = x.dim() == 3
    if squeeze:
        x = x[None]
    _, h_in, w_in, _ = x.shape
    if (h_in, w_in) == (h_out, w_out):
        return x[0] if squeeze else x
    cdt = _compute_dtype(x.dtype)
    mh, mw = _matrices(h_in, w_in, h_out, w_out, align_corners, cdt, x.device)
    y = x.to(cdt)
    y = torch.einsum("oh,bhwc->bowc", mh, y)
    y = torch.einsum("pw,bhwc->bhpc", mw, y)
    y = y.to(x.dtype)
    return y[0] if squeeze else y


def resize_argmax(x: torch.Tensor, size, align_corners: bool = True) -> torch.Tensor:
    """``argmax(resize_bilinear(x, size), -1)`` laid out channels-first.

    Class-logit maps have few channels, so the resize runs on the (B, C, H, W)
    transpose of the small input. The resized values are rounded back to the
    input dtype before the argmax, as ``resize_bilinear`` returns them, so the
    result equals the unfused composition for every input dtype up to exact
    ties. Returns int32 class maps of shape (..., H, W).
    """
    h_out, w_out = int(size[0]), int(size[1])
    squeeze = x.dim() == 3
    if squeeze:
        x = x[None]
    _, h_in, w_in, _ = x.shape
    if (h_in, w_in) == (h_out, w_out):
        y = torch.argmax(x, dim=-1).to(torch.int32)
        return y[0] if squeeze else y
    cdt = _compute_dtype(x.dtype)
    mh, mw = _matrices(h_in, w_in, h_out, w_out, align_corners, cdt, x.device)
    y = x.to(cdt).permute(0, 3, 1, 2)
    y = torch.einsum("oh,bchw->bcow", mh, y)
    y = torch.einsum("pw,bchw->bchp", mw, y)
    y = torch.argmax(y.to(x.dtype), dim=1).to(torch.int32)
    return y[0] if squeeze else y
