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
  OpenCV 4.10 and older);
- ``cv2_resize_cubic``: INTER_CUBIC on uint8 frames, as OpenCV 5.0 with
  its IPP back end computes it (see the function for how close);
- ``cv2_rgb2hsv_u8`` and ``cv2_hsv2rgb_u8``: cvtColor COLOR_RGB2HSV and
  COLOR_HSV2RGB on uint8 (H in 0..179), to the bit on every input;
- ``pil_resize_bicubic``: PIL's ``Image.resize(size)`` (BICUBIC, its
  default) on uint8 RGB or L images, to the bit.
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
    (the 1-, 3- and 4-channel float32 path). On that path a position within
    about 1e-15 of an integer can still land up to ~50 ulps from cv2's
    value (tests/test_torch_segm_cv2.py bounds it on random sizes)."""
    f = (np.arange(n_out, dtype=np.float64) + 0.5) * scale - 0.5
    if not exact_fraction:
        f = f.astype(np.float32)
    # the source index of a float64 position is taken from its float32
    # rounding: a position just below an integer (14.999999999999998)
    # reads that integer's pixel with a fraction of -2e-15, as cv2 does
    s = np.floor(f.astype(np.float32)).astype(f.dtype)
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


# ------------------------------------------------------------ INTER_CUBIC

def _cubic_weights(f: np.ndarray) -> np.ndarray:
    """Keys' cubic (a = -0.75) weights of the 4 taps around each fraction
    ``f`` (float64), the last one 1 minus the others; (n, 4) float64."""
    a = -0.75
    x1 = f + 1
    c0 = ((a * x1 - 5 * a) * x1 + 8 * a) * x1 - 4 * a
    c1 = ((a + 2) * f - (a + 3)) * f * f + 1
    y = 1 - f
    c2 = ((a + 2) * y - (a + 3)) * y * y + 1
    return np.stack([c0, c1, c2, 1 - c0 - c1 - c2], -1)


def _cubic_axis(n_in: int, n_out: int) -> Tuple[np.ndarray, np.ndarray]:
    """Each output index's 4 source indices, clamped to the border
    (BORDER_REPLICATE), and their float32 weights, from the float64 source
    position (dx + 0.5) * n_in / n_out - 0.5."""
    f = (np.arange(n_out, dtype=np.float64) + 0.5) * (n_in / n_out) - 0.5
    s = np.floor(f)
    idx = np.clip(s.astype(np.int64)[:, None] + np.arange(-1, 3)[None], 0, n_in - 1)
    return idx, _cubic_weights(f - s).astype(np.float32)


def cv2_resize_cubic(im: np.ndarray, out_hw: Tuple[int, int]) -> np.ndarray:
    """``cv2.resize(im, (w, h), interpolation=cv2.INTER_CUBIC)`` of an
    (H, W) or (H, W, C) uint8 image.

    OpenCV 5.0 hands this call to IPP, which does not take OpenCV's own
    11-bit fixed-point path: the weights are float32 (computed from float64
    positions), the horizontal pass sums taps (0, 1) and (2, 3) in float32
    and adds the pairs, the vertical pass sums taps (0, 2) and (1, 3) and
    adds those, and the result is rounded half to even and saturated. That
    order is the closest found, not IPP's documented one: a value within
    about one float32 ulp of a half can round the other way (9 of 1.57
    million values in tests/test_torch_segm_cv2.py, each off by 1)."""
    h, w = im.shape[:2]
    oh, ow = int(out_hw[0]), int(out_hw[1])
    if im.dtype != np.uint8:
        raise TypeError(f"cv2_resize_cubic takes uint8, got {im.dtype}")
    x = (im if im.ndim == 3 else im[..., None]).astype(np.float32)
    xi, cx = _cubic_axis(w, ow)
    yi, cy = _cubic_axis(h, oh)
    t = [x[:, xi[:, k]] * cx[None, :, k, None] for k in range(4)]
    t = (t[0] + t[1]) + (t[2] + t[3])
    v = [t[yi[:, k]] * cy[:, k, None, None] for k in range(4)]
    v = (v[0] + v[2]) + (v[1] + v[3])
    out = np.clip(np.rint(v), 0, 255).astype(np.uint8)
    return out if im.ndim == 3 else out[..., 0]


# ------------------------------------------------------------ HSV

_HSV_SHIFT = 12
_SDIV = np.concatenate([[0], np.rint((255 << _HSV_SHIFT) / np.arange(1, 256))]).astype(np.int64)
_HDIV180 = np.concatenate([[0], np.rint((180 << _HSV_SHIFT) / (6.0 * np.arange(1, 256)))]
                          ).astype(np.int64)
# (b, g, r) taken from (v, p, q, t) in each of the six sectors of the hue
_HSV_SECTORS = np.array([[1, 3, 0], [1, 0, 2], [3, 0, 1], [0, 2, 1], [0, 1, 3], [2, 1, 0]])


def cv2_rgb2hsv_u8(rgb: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(rgb, cv2.COLOR_RGB2HSV)`` of uint8 (..., 3): cv2's
    12-bit fixed-point tables, H in 0..179, to the bit."""
    r, g, b = (rgb[..., i].astype(np.int64) for i in range(3))
    v = np.maximum(np.maximum(b, g), r)
    diff = v - np.minimum(np.minimum(b, g), r)
    half = 1 << (_HSV_SHIFT - 1)
    s = (diff * _SDIV[v] + half) >> _HSV_SHIFT
    h = np.where(v == r, g - b, np.where(v == g, b - r + 2 * diff, r - g + 4 * diff))
    h = (h * _HDIV180[diff] + half) >> _HSV_SHIFT
    h = np.where(h < 0, h + 180, h)
    return np.stack([h, s, v], -1).astype(np.uint8)


def _fnma(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """float32 1 - a * b, rounded once (a fused negative multiply-add)."""
    return (1.0 - a.astype(np.float64) * b.astype(np.float64)).astype(np.float32)


# cvtColor's HSV2RGB converts 32 pixels of a row at a time; the last
# (width % 32) pixels of each row go through its scalar loop
_HSV_VECTOR_PIXELS = 32


def cv2_hsv2rgb_u8(hsv: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(hsv, cv2.COLOR_HSV2RGB)`` of uint8 (..., W, 3), H in
    0..179, as OpenCV 5.0 computes it, to the bit: float32 h * (6 / 180), s
    and v times 1 / 255, the sector and fraction of h, the tabulated
    v * (1 - s), v * fma(-s, f, 1) and v * fma(-s, 1 - f, 1), times 255;
    truncated in the vector body of each row, rounded half to even in its
    scalar tail (the last W % 32 pixels)."""
    f32 = np.float32
    hh = hsv[..., 0].astype(f32) * f32(6.0 / 180)
    sector = np.trunc(hh)
    hh = hh - sector
    s = hsv[..., 1].astype(f32) * f32(1 / 255)
    v = hsv[..., 2].astype(f32) * f32(1 / 255)
    one = f32(1)
    tab = np.stack([v, v * (one - s), v * _fnma(s, hh), v * _fnma(s, one - hh)], -1)
    bgr = np.take_along_axis(tab, _HSV_SECTORS[sector.astype(np.int64) % 6], -1)
    rgb = bgr[..., ::-1] * f32(255)
    w = hsv.shape[-2]
    tail = np.arange(w) >= w - w % _HSV_VECTOR_PIXELS
    out = np.where(tail[:, None], np.rint(rgb), np.trunc(rgb))
    return np.clip(out, 0, 255).astype(np.uint8)


# ------------------------------------------------------------ PIL's resize

_PIL_PRECISION_BITS = 32 - 8 - 2


def _pil_bicubic(x: np.ndarray) -> np.ndarray:
    """PIL's bicubic filter (a = -0.5) at float64 x."""
    a = -0.5
    x = np.abs(x)
    return np.where(x < 1.0, ((a + 2.0) * x - (a + 3.0)) * x * x + 1,
                    np.where(x < 2.0, (((x - 5) * x + 8) * x - 4) * a, 0.0))


def _pil_coeffs(n_in: int, n_out: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """PIL's ``precompute_coeffs`` and ``normalize_coeffs_8bpc`` for one
    axis: each output's first source index, tap count and integer weights
    (22 fractional bits), (n_out,), (n_out,), (n_out, ksize)."""
    scale = n_in / n_out
    filterscale = max(scale, 1.0)
    support = 2.0 * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    lo = np.empty(n_out, np.int64)
    cnt = np.empty(n_out, np.int64)
    kk = np.zeros((n_out, ksize), np.float64)
    for xx in range(n_out):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), n_in) - xmin
        w = _pil_bicubic((np.arange(xmax) + xmin - center + 0.5) * (1.0 / filterscale))
        ww = float(w.sum()) if xmax else 0.0
        kk[xx, :xmax] = w / ww if ww != 0.0 else w
        lo[xx], cnt[xx] = xmin, xmax
    one = float(1 << _PIL_PRECISION_BITS)
    ik = np.where(kk < 0, np.trunc(-0.5 + kk * one), np.trunc(0.5 + kk * one)).astype(np.int64)
    return lo, cnt, ik


def _pil_pass(x: np.ndarray, n_out: int, axis: int) -> np.ndarray:
    """One of PIL's 8-bit resampling passes along ``axis`` (0 rows, 1
    columns) of an int64 (H, W, C) image: the integer sum from 2**21, shifted
    by 22 and clipped to 0..255."""
    lo, cnt, ik = _pil_coeffs(x.shape[axis], n_out)
    x = np.moveaxis(x, axis, 0)
    acc = np.full((n_out,) + x.shape[1:], 1 << (_PIL_PRECISION_BITS - 1), np.int64)
    for k in range(ik.shape[1]):
        valid = k < cnt
        src = np.minimum(lo + k, x.shape[0] - 1)
        wk = np.where(valid, ik[:, k], 0).reshape((n_out,) + (1,) * (x.ndim - 1))
        acc += x[src] * wk
    out = np.clip(acc >> _PIL_PRECISION_BITS, 0, 255)
    return np.moveaxis(out, 0, axis)


def pil_resize_bicubic(im: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """PIL's ``Image.fromarray(im).resize(size)`` (``size`` = (w, h),
    BICUBIC, PIL's default) of an (H, W) or (H, W, 3) uint8 image, to the
    bit: the horizontal pass first (only when the width changes), each
    clipped to uint8."""
    w_out, h_out = int(size[0]), int(size[1])
    x = (im if im.ndim == 3 else im[..., None]).astype(np.int64)
    if w_out != x.shape[1]:
        x = _pil_pass(x, w_out, 1)
    if h_out != x.shape[0]:
        x = _pil_pass(x, h_out, 0)
    out = x.astype(np.uint8)
    return out if im.ndim == 3 else out[..., 0]
