"""Bilinear resize as separable matrix products (NHWC).

Counterpart of floodseg_tpu/ops/resize.py. The row and column interpolation
matrices are built once per (in, out, align) in float64 and cast to the
compute dtype; the two contractions are plain ``torch.einsum`` products,
as the JAX package leaves them to XLA. Matches
``torch.nn.functional.interpolate(mode="bilinear", align_corners=...)`` up
to float associativity.

``resize_bilinear(..., fast_lowp=True)`` (the int8 decoder's resize) keeps
the matrices and the between-axes intermediate in the input dtype. Each
row of a matrix has at most two nonzeros, so each contraction is written
as two taps: ``x[i0] * m0 + x[i1] * m1`` in float32 (for bf16 and float32
inputs), one rounded multiply each and one rounded add, then rounded to
the input dtype. For bf16 the products are exact in float32, so this is
bit-equal to the JAX package's matrix product in any summation order; the
same fixed order lets a CUDA kernel (``csrc/resize.cu``) reproduce it to
the bit in float32 too.
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
    # on every call would wait for the stream and stall the launch queue.
    # Made outside inference mode, so that a cache first filled by a
    # predict call also serves a training step, which saves it for backward
    with torch.inference_mode(False):
        return torch.as_tensor(_interp_matrix(in_size, out_size, align_corners),
                               dtype=dtype, device=device)


def _matrices(h_in, w_in, h_out, w_out, align_corners, dtype, device):
    return (_interp_tensor(h_in, h_out, align_corners, dtype, device),
            _interp_tensor(w_in, w_out, align_corners, dtype, device))


@lru_cache(maxsize=256)
def interp_taps(in_size: int, out_size: int, align_corners: bool,
                dtype: torch.dtype):
    """The two taps of each row of ``_interp_matrix`` cast to ``dtype``.

    Returns (idx, w) numpy arrays of shape (out_size, 2): the ascending
    column indices of the row's nonzeros and those entries, rounded to
    ``dtype`` and held exactly in float64. A row with one nonzero (the
    clipped edges, whose two weights ``np.add.at`` summed before the cast,
    and exact source pixels) repeats its column with weight 0.
    """
    m = torch.from_numpy(_interp_matrix(in_size, out_size, align_corners))
    m = m.to(dtype).double().numpy()
    nz = m != 0
    if int(nz.sum(axis=1).max()) > 2 or not nz.any(axis=1).all():
        raise ValueError("an interpolation row must have one or two nonzeros")
    rows = np.arange(out_size)
    first = np.argmax(nz, axis=1)
    last = in_size - 1 - np.argmax(nz[:, ::-1], axis=1)
    idx = np.stack([first, last], axis=1)
    w = np.stack([m[rows, first], np.where(last != first, m[rows, last], 0.0)], axis=1)
    return idx, w


@lru_cache(maxsize=256)
def tap_tensors(in_size, out_size, align_corners, dtype, device):
    """``interp_taps`` on ``device``: int32 indices and weights in the
    compute dtype (float32 for bf16 and float32; what csrc/resize.cu reads)."""
    idx, w = interp_taps(in_size, out_size, align_corners, dtype)
    with torch.inference_mode(False):  # see _interp_tensor
        return (torch.as_tensor(idx, dtype=torch.int32, device=device).contiguous(),
                torch.as_tensor(w, dtype=_compute_dtype(dtype), device=device).contiguous())


def _taps_axis(y: torch.Tensor, axis: int, idx: torch.Tensor,
               w: torch.Tensor) -> torch.Tensor:
    """Contract ``axis`` of ``y`` with a two-tap matrix: y[i0] * w0 + y[i1] * w1."""
    shape = [1] * y.dim()
    shape[axis] = -1
    a = y.index_select(axis, idx[:, 0]) * w[:, 0].view(shape)
    b = y.index_select(axis, idx[:, 1]) * w[:, 1].view(shape)
    return a + b


def _resize_lowp(x: torch.Tensor, h_out: int, w_out: int,
                 align_corners: bool) -> torch.Tensor:
    """fast_lowp: H taps then W taps, each in the compute dtype on
    dtype-valued operands and rounded to the input dtype."""
    _, h_in, w_in, _ = x.shape
    cdt = _compute_dtype(x.dtype)
    ih, wh = tap_tensors(h_in, h_out, align_corners, x.dtype, x.device)
    iw, ww = tap_tensors(w_in, w_out, align_corners, x.dtype, x.device)
    y = _taps_axis(x.to(cdt), 1, ih, wh).to(x.dtype)
    return _taps_axis(y.to(cdt), 2, iw, ww).to(x.dtype)


def resize_bilinear(x: torch.Tensor, size, align_corners: bool = True,
                    fast_lowp: bool = False) -> torch.Tensor:
    """Bilinearly resize NHWC (or HWC) ``x`` to spatial ``size=(H, W)``.

    Computes in float32 for bf16 and float32 inputs and casts the result back
    to the input dtype. ``fast_lowp``: the matrices and the between-axes
    intermediate are rounded to the input dtype (the module note says how);
    only the int8 decoder's path, where coarser quantization follows, uses it.
    """
    h_out, w_out = int(size[0]), int(size[1])
    squeeze = x.dim() == 3
    if squeeze:
        x = x[None]
    _, h_in, w_in, _ = x.shape
    if (h_in, w_in) == (h_out, w_out):
        return x[0] if squeeze else x
    if fast_lowp:
        y = _resize_lowp(x, h_out, w_out, align_corners)
        return y[0] if squeeze else y
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
