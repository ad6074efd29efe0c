"""cv2's arithmetic without cv2, for the host transforms.

The JAX package resizes and blurs frames, labels and grids with cv2; the
machine with the card has no cv2. These reproduce cv2's results to the bit
(tests/test_torch_train_data.py holds them to cv2):

- ``cv2_resize_linear``: INTER_LINEAR on uint8 (11-bit fixed-point
  weights, the rounding of cv2's vectorised vertical pass) and float32
  arrays, with cv2's coordinate map, either from the sizes or from the
  scale factors of ``cv2.resize(None, fx, fy)``;
- ``cv2_resize_nearest``: INTER_NEAREST's floor(x / fx) source index;
- ``cv2_gaussian_blur_5``: GaussianBlur((5, 5), 0), the fixed
  [1, 4, 6, 4, 1] / 16 kernel with reflect-101 borders.
"""

from typing import Optional, Tuple

import numpy as np

_COEF_SCALE = 2048  # cv2's INTER_RESIZE_COEF_SCALE: 11-bit resize weights
_BLUR_TAPS = np.array([16, 64, 96, 64, 16], np.int64)  # [1, 4, 6, 4, 1] / 16, 8 bits


def _cv2_axis(n_in: int, n_out: int, scale: float):
    """cv2's source index and float32 fraction of each output index:
    fx = float((dx + 0.5) * scale - 0.5), sx = floor(fx), fx -= sx."""
    f = ((np.arange(n_out, dtype=np.float64) + 0.5) * scale - 0.5).astype(np.float32)
    s = np.floor(f)
    return s.astype(np.int64), (f - s).astype(np.float32)


def cv2_resize_linear(im: np.ndarray, out_hw: Tuple[int, int],
                      inv_scale: Optional[Tuple[float, float]] = None,
                      rows: Optional[np.ndarray] = None,
                      cols: Optional[np.ndarray] = None) -> np.ndarray:
    """``cv2.resize(im, (w, h), INTER_LINEAR)`` of an (H, W) or (H, W, C)
    uint8 or float32 array, to the bit. ``inv_scale=(fy, fx)``: cv2's
    scale factors when the output size came from them (the source position
    of an output index is then (dx + 0.5) / fx - 0.5); else out / in.

    The columns clamp to the border (weights 1, 0), the rows read the
    clamped neighbours. uint8: weights rounded to 11 bits, a horizontal
    pass in int32, then the vertical pass as cv2's SIMD path rounds it,
    ((((d0 >> 4) * b0) >> 16) + (((d1 >> 4) * b1) >> 16) + 2) >> 2;
    float32: the same two passes in float32. ``rows``/``cols``: compute only
    those output rows and columns (each output pixel depends on its own
    indices alone, so a window of the output costs a window's work)."""
    h, w = im.shape[:2]
    oh, ow = int(out_hw[0]), int(out_hw[1])
    if (oh, ow) == (h, w):
        out = im if rows is None else im[rows]
        return (out if cols is None else out[:, cols]).copy()
    sy_scale = 1.0 / (inv_scale[0] if inv_scale else oh / h)
    sx_scale = 1.0 / (inv_scale[1] if inv_scale else ow / w)
    x = im if im.ndim == 3 else im[..., None]
    sx, fx = _cv2_axis(w, ow, sx_scale)
    edge = (sx < 0) | (sx >= w - 1)
    fx[edge] = 0.0
    sx = np.clip(sx, 0, w - 1)
    sy, fy = _cv2_axis(h, oh, sy_scale)
    if cols is not None:
        sx, fx = sx[cols], fx[cols]
    if rows is not None:
        sy, fy = sy[rows], fy[rows]
    sx1 = np.minimum(sx + 1, w - 1)
    # only the source rows the output rows read go through the first pass
    r0, r1 = np.clip(sy, 0, h - 1), np.clip(sy + 1, 0, h - 1)
    used, inv = np.unique(np.concatenate([r0, r1]), return_inverse=True)
    x = x[used]
    r0, r1 = inv[:len(r0)], inv[len(r0):]
    one = np.float32(1.0)
    if x.dtype == np.uint8:
        a0 = np.rint((one - fx) * _COEF_SCALE).astype(np.int32)[:, None]
        a1 = np.rint(fx * _COEF_SCALE).astype(np.int32)[:, None]
        b0 = np.rint((one - fy) * _COEF_SCALE).astype(np.int32)[:, None, None]
        b1 = np.rint(fy * _COEF_SCALE).astype(np.int32)[:, None, None]
        xi = x.astype(np.int32)
        d = (xi[:, sx] * a0 + xi[:, sx1] * a1) >> 4
        out = ((((d[r0] * b0) >> 16) + ((d[r1] * b1) >> 16) + 2) >> 2)
        out = np.clip(out, 0, 255).astype(np.uint8)
    elif x.dtype == np.float32:
        a0, a1 = (one - fx)[:, None], fx[:, None]
        d = x[:, sx] * a0 + x[:, sx1] * a1
        out = d[r0] * (one - fy)[:, None, None] + d[r1] * fy[:, None, None]
    else:
        raise TypeError(f"cv2_resize_linear takes uint8 or float32, got {x.dtype}")
    return out if im.ndim == 3 else out[..., 0]


def cv2_resize_nearest(im: np.ndarray, out_hw: Tuple[int, int],
                       inv_scale: Optional[Tuple[float, float]] = None,
                       rows: Optional[np.ndarray] = None,
                       cols: Optional[np.ndarray] = None) -> np.ndarray:
    """``cv2.resize(im, (w, h), INTER_NEAREST)``: source index
    floor(dx * (1 / fx)), clipped; ``inv_scale``, ``rows`` and ``cols`` as
    in cv2_resize_linear."""
    h, w = im.shape[:2]
    oh, ow = int(out_hw[0]), int(out_hw[1])
    ify = 1.0 / (inv_scale[0] if inv_scale else oh / h)
    ifx = 1.0 / (inv_scale[1] if inv_scale else ow / w)
    ry = np.arange(oh) if rows is None else np.asarray(rows)
    rx = np.arange(ow) if cols is None else np.asarray(cols)
    src_r = np.minimum(np.floor(ry * ify).astype(np.int64), h - 1)
    src_c = np.minimum(np.floor(rx * ifx).astype(np.int64), w - 1)
    return im[src_r][:, src_c]


def cv2_gaussian_blur_5(im: np.ndarray) -> np.ndarray:
    """``cv2.GaussianBlur(im, (5, 5), 0)`` of an (H, W, C) uint8 frame (the
    decoder's): the fixed [1, 4, 6, 4, 1] / 16 kernel both ways, borders
    reflected without the edge pixel (BORDER_REFLECT_101), the horizontal
    sums with 8 fractional bits, the vertical with 16, rounded half up."""
    h, w = im.shape[:2]
    return blur_5_valid(im[reflect101(np.arange(-2, h + 2), h)][:, reflect101(
        np.arange(-2, w + 2), w)])


def reflect101(i: np.ndarray, n: int) -> np.ndarray:
    """BORDER_REFLECT_101 indices: -1 -> 1, n -> n - 2 (for a halo of 2 < n)."""
    i = np.abs(i)
    return np.where(i > n - 1, 2 * (n - 1) - i, i)


def blur_5_valid(p: np.ndarray) -> np.ndarray:
    """The 5x5 fixed-kernel blur of a patch already extended by 2 on each
    side: (h + 4, w + 4, C) uint8 -> (h, w, C), cv2's fixed-point
    rounding."""
    h, w = p.shape[0] - 4, p.shape[1] - 4
    if p.dtype != np.uint8:
        raise TypeError(f"the 5x5 blur takes uint8 frames, got {p.dtype}")
    q = p.astype(np.int64)
    rows = sum(int(c) * q[:, k:k + w] for k, c in enumerate(_BLUR_TAPS))
    v = sum(int(c) * rows[k:k + h] for k, c in enumerate(_BLUR_TAPS))
    return np.clip((v + (1 << 15)) >> 16, 0, 255).astype(np.uint8)
