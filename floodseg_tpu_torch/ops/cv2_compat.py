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
  [1, 4, 6, 4, 1] / 16 kernel with reflect-101 borders;
- ``rotation_matrix_2d`` and ``warp_affine``: getRotationMatrix2D and
  warpAffine with INTER_LINEAR on uint8 frames or INTER_NEAREST, and
  BORDER_CONSTANT, as OpenCV 5.0 computes them (float32 source
  coordinates and float32 interpolation, not the fixed-point tables of
  OpenCV 4.10 and older).
"""

import math
from typing import Callable, Optional, Sequence, Tuple, Union

import numpy as np

_COEF_SCALE = 2048  # cv2's INTER_RESIZE_COEF_SCALE: 11-bit resize weights
_BLUR_TAPS = np.array([16, 64, 96, 64, 16], np.int64)  # [1, 4, 6, 4, 1] / 16, 8 bits


def _cv2_axis(n_in: int, n_out: int, scale: float, exact_fraction: bool = False):
    """cv2's source index and float32 fraction of each output index:
    fx = float((dx + 0.5) * scale - 0.5), sx = floor(fx), fx -= sx; with
    ``exact_fraction`` the fraction is taken in float64 and then rounded
    (the 1-, 3- and 4-channel float32 path)."""
    f = (np.arange(n_out, dtype=np.float64) + 0.5) * scale - 0.5
    if not exact_fraction:
        f = f.astype(np.float32)
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
    float32 with 2 or more than 4 channels: the same two passes in float32;
    float32 with 1, 3 or 4 channels (OpenCV 5.0 interpolates these as its
    warps do): the fractions from float64 positions, then fma(a, p01 - p00,
    p00) along each row and fma(b, v1 - v0, v0) between the two rows, in
    float32 (to the bit from the sizes; from ``inv_scale``, which no caller
    passes with such an array, a column past the source's last one can
    differ by an ulp). ``rows``/``cols``: compute only
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
    lerp = x.dtype == np.float32 and x.shape[2] in (1, 3, 4)
    sx, fx = _cv2_axis(w, ow, sx_scale, lerp)
    edge = (sx < 0) | (sx >= w - 1)
    fx[edge] = 0.0
    sx = np.clip(sx, 0, w - 1)
    sy, fy = _cv2_axis(h, oh, sy_scale, lerp)
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
    elif lerp:
        a = fx[:, None]
        p0, p1 = x[:, sx], x[:, sx1]
        v = _fma(a, p1 - p0, p0)
        b = fy[:, None, None]
        out = _fma(b, v[r1] - v[r0], v[r0])
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
    floor(dx * (1 / fx)), clipped; an output of the input's size is a copy,
    as cv2 copies it whatever the factors; ``inv_scale``, ``rows`` and
    ``cols`` as in cv2_resize_linear."""
    h, w = im.shape[:2]
    oh, ow = int(out_hw[0]), int(out_hw[1])
    if (oh, ow) == (h, w):
        out = im if rows is None else im[rows]
        return (out if cols is None else out[:, cols]).copy()
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


# ------------------------------------------------------------- warpAffine

# warpAffine's vector body computes 16 output columns at a time; the last
# (width % 16) columns of a row go through its scalar loop, which forms the
# source x coordinate in another order
_WARP_VECTOR_COLUMNS = 16


def rotation_matrix_2d(center: Tuple[float, float], angle: float,
                       scale: float) -> np.ndarray:
    """``cv2.getRotationMatrix2D``: the (2, 3) float64 matrix, the centre
    taken as float32 (cv2's Point2f), the angle in degrees."""
    cx, cy = (float(np.float32(c)) for c in center)
    a = angle * (math.pi / 180)
    alpha, beta = math.cos(a) * scale, math.sin(a) * scale
    return np.array([[alpha, beta, (1 - alpha) * cx - beta * cy],
                     [-beta, alpha, beta * cx + (1 - alpha) * cy]], np.float64)


def _inverse_affine(m: np.ndarray) -> Tuple[np.float32, ...]:
    """warpAffine's inverse of the forward map, in float64 and in its order,
    then rounded to float32 (the kernels' coefficients)."""
    m0, m1, m2, m3, m4, m5 = (float(v) for v in np.asarray(m, np.float64).reshape(6))
    d = m0 * m4 - m1 * m3
    d = 1.0 / d if d != 0 else 0.0
    a0, a4 = m4 * d, m0 * d
    a1, a3 = m1 * -d, m3 * -d
    a2 = -a0 * m2 - a1 * m5
    a5 = -a3 * m2 - a4 * m5
    return tuple(np.float32(v) for v in (a0, a1, a2, a3, a4, a5))


def _fma(a, b, c) -> np.ndarray:
    """float32 fused multiply-add: the exact a * b + c, rounded once (the
    float64 sum is exact for the operands these kernels give it)."""
    return (np.asarray(a, np.float64) * np.asarray(b, np.float64)
            + np.asarray(c, np.float64)).astype(np.float32)


def _source_coords(m: np.ndarray, width: int, rows: np.ndarray,
                   cols: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Each output pixel's float32 source (x, y), (len(rows), len(cols))
    each. The row term y * a1 + a2 is rounded on its own; the vector body
    adds x * a0 to it in one fused step. The scalar tail fuses x * a0 with
    y * a1 and rounds again when it adds a2."""
    a0, a1, a2, a3, a4, a5 = _inverse_affine(m)
    y = np.asarray(rows).astype(np.float32)[:, None]
    x = np.asarray(cols).astype(np.float32)[None, :]
    y1, y4 = y * a1, y * a4
    sx, sy = _fma(x, a0, y1 + a2), _fma(x, a3, y4 + a5)
    tail = np.asarray(cols)[None, :] >= width - width % _WARP_VECTOR_COLUMNS
    if tail.any():
        sx = np.where(tail, _fma(x, a0, y1) + a2, sx)
        sy = np.where(tail, _fma(x, a3, y4) + a5, sy)
    return sx, sy


Source = Union[np.ndarray, Tuple[Tuple[int, int], Callable[[np.ndarray, np.ndarray],
                                                           np.ndarray]]]


def warp_affine(src: Source, m: np.ndarray, dsize: Tuple[int, int], nearest: bool = False,
                border_value: Union[float, Sequence[float]] = 0.0,
                rows: Optional[np.ndarray] = None,
                cols: Optional[np.ndarray] = None) -> np.ndarray:
    """``cv2.warpAffine(src, m, dsize, flags, BORDER_CONSTANT, border_value)``
    with flags INTER_LINEAR (uint8 frames) or INTER_NEAREST (``nearest``;
    labels of any dtype), to the bit of OpenCV 5.0. ``dsize`` is (w, h).

    Source coordinates as ``_source_coords``; nearest takes each one's
    rounded (half to even) pixel; linear takes the four taps around it,
    the fractions a = sx - floor(sx) and b likewise, and computes
    fma(b, v1 - v0, v0) with v0 = fma(a, p01 - p00, p00) and v1 likewise
    in float32, rounded half to even and saturated. Taps outside the source
    read ``border_value`` saturated to the dtype (a scalar is cv2's
    Scalar(v): v in the first channel, 0 in the others).

    ``rows``/``cols``: compute only those output rows and columns (each
    output pixel depends on its own indices alone). ``src`` may instead be
    ``((H, W), fetch)``, where ``fetch(r, c)`` returns the source's pixels
    at the row indices r and column indices c (two aranges): then only the
    block of source pixels the computed outputs read is made.
    """
    if isinstance(src, np.ndarray):
        arr = src
        hw = arr.shape[:2]

        def fetch(r, c):
            return arr[r[0]:r[-1] + 1, c[0]:c[-1] + 1]
    else:
        hw, fetch = src
    sh, sw = int(hw[0]), int(hw[1])
    w, h = int(dsize[0]), int(dsize[1])
    rows = np.arange(h) if rows is None else np.asarray(rows)
    cols = np.arange(w) if cols is None else np.asarray(cols)
    sx, sy = _source_coords(m, w, rows, cols)
    if nearest:
        taps = [(np.rint(sy).astype(np.int64), np.rint(sx).astype(np.int64))]
    else:
        fx, fy = np.floor(sx), np.floor(sy)
        ix, iy = fx.astype(np.int64), fy.astype(np.int64)
        a, b = sx - fx, sy - fy
        taps = [(iy, ix), (iy, ix + 1), (iy + 1, ix), (iy + 1, ix + 1)]
    # the block of source rows and columns the taps inside the source read
    lo = np.array([min(int(t.min()) for t, _ in taps), min(int(t.min()) for _, t in taps)])
    hi = np.array([max(int(t.max()) for t, _ in taps), max(int(t.max()) for _, t in taps)])
    lo, hi = np.maximum(lo, 0), np.minimum(hi, [sh - 1, sw - 1])
    block = (fetch(np.arange(lo[0], hi[0] + 1), np.arange(lo[1], hi[1] + 1))
             if (lo <= hi).all() else None)
    probe = block if block is not None else fetch(np.arange(1), np.arange(1))
    dtype, channels = probe.dtype, probe.shape[2:]
    bv = np.zeros(channels or (1,), np.float64)
    bval = np.asarray(border_value, np.float64).reshape(-1)
    bv[:min(bv.size, bval.size)] = bval[:bv.size]
    if np.issubdtype(dtype, np.integer):
        info = np.iinfo(dtype)
        bv = np.clip(np.rint(bv), info.min, info.max)
    bv = bv.astype(dtype if nearest else np.float32)
    if not channels:
        bv = bv[0]

    def tap_values(ty, tx):
        ok = (ty >= 0) & (ty < sh) & (tx >= 0) & (tx < sw)
        if block is None:
            return np.broadcast_to(bv, ty.shape + channels)
        v = block[np.clip(ty - lo[0], 0, block.shape[0] - 1),
                  np.clip(tx - lo[1], 0, block.shape[1] - 1)]
        if not nearest:
            v = v.astype(np.float32)
        return np.where(ok[..., None] if channels else ok, v, bv)

    if nearest:
        return tap_values(*taps[0]).astype(dtype)
    if dtype != np.uint8:
        raise TypeError(f"warp_affine INTER_LINEAR takes uint8 frames, got {dtype}")
    p00, p01, p10, p11 = (tap_values(ty, tx) for ty, tx in taps)
    if channels:
        a, b = a[..., None], b[..., None]
    v0 = _fma(a, p01 - p00, p00)
    v1 = _fma(a, p11 - p10, p10)
    v = _fma(b, v1 - v0, v0)
    return np.clip(np.rint(v), 0, 255).astype(np.uint8)
