"""Bilinear grid sampling with border padding: the plain PyTorch warp.

Counterpart of floodseg_tpu/ops/grid_sample.py, and the plain version of
the warp kernel K1 (csrc/warp.cu, wrapped by ops/warp_kernels.py);
``grid_sample_backward`` is the plain version of its backward, K1-bwd. It
computes what floodseg_tpu/ops/pallas_warp.py::grid_sample_pallas computes:
four bilinear taps per output point with float32 weights, float32
accumulation, and one rounding to the input dtype at the end. Equivalent to
``torch.nn.functional.grid_sample(mode="bilinear", padding_mode="border")``
on NHWC tensors, which the port never calls.

``grid_sample_matmul`` is the JAX package's other formulation of the same
warp (its ``grid_sample(..., impl="matmul")``): the bilinear weights as a
one-hot (B, P, H*W) matrix contracted with the flattened source. The JAX
package leaves that product to XLA, outside any Pallas kernel, so here it
stays a torch product; it is not on the flow paths.

The arithmetic is written one rounded operation at a time, in the order
the CUDA kernel performs it, so that the kernel and this version agree to
the last bit in float32.
"""

import torch

from floodseg_tpu_torch.core.device import full_precision_f32


def tap_coords(h: int, w: int, grid: torch.Tensor, align_corners: bool):
    """Bilinear tap coordinates with border clamping, torch convention.

    Returns (x0, x1, y0, y1) int64 and the fractional (wx, wy). The float
    math runs at >= float32; the floor comes before the integer cast, and
    the clamp to [0, W-1] / [0, H-1] after it.
    """
    gxy = grid.to(torch.promote_types(grid.dtype, torch.float32))
    gx, gy = gxy[..., 0], gxy[..., 1]
    if align_corners:
        fx = (gx + 1.0) * 0.5 * (w - 1)
        fy = (gy + 1.0) * 0.5 * (h - 1)
    else:
        fx = ((gx + 1.0) * w - 1.0) * 0.5
        fy = ((gy + 1.0) * h - 1.0) * 0.5
    x0f, y0f = torch.floor(fx), torch.floor(fy)
    wx, wy = fx - x0f, fy - y0f
    xi, yi = x0f.to(torch.int64), y0f.to(torch.int64)
    x0 = xi.clamp(0, w - 1)
    x1 = (xi + 1).clamp(0, w - 1)
    y0 = yi.clamp(0, h - 1)
    y1 = (yi + 1).clamp(0, h - 1)
    return x0, x1, y0, y1, wx, wy


def tap_indices_weights(h: int, w: int, grid: torch.Tensor, align_corners: bool,
                        dtype: torch.dtype = torch.float32):
    """Flat tap indices (..., 4) into the (H*W) plane and their weights
    (..., 4), in the order (y0,x0), (y0,x1), (y1,x0), (y1,x1). The weights
    are formed at ``promote_types(dtype, coordinate dtype)``: float32 for
    float32 and bf16 data (K1's arithmetic), float64 for float64 data (the
    JAX package's float64 warp weighs with wx and wy cast to float64)."""
    x0, x1, y0, y1, wx, wy = tap_coords(h, w, grid, align_corners)
    wdt = torch.promote_types(dtype, wx.dtype)
    wx, wy = wx.to(wdt), wy.to(wdt)
    idx = torch.stack([y0 * w + x0, y0 * w + x1, y1 * w + x0, y1 * w + x1], dim=-1)
    wgt = torch.stack([(1 - wx) * (1 - wy), wx * (1 - wy),
                       (1 - wx) * wy, wx * wy], dim=-1)
    return idx, wgt


def blend_taps(vals: torch.Tensor, wgt: torch.Tensor) -> torch.Tensor:
    """((v0*w0 + v1*w1) + v2*w2) + v3*w3 for vals (..., 4, C) already in the
    compute dtype and weights (..., 4)."""
    acc = vals[..., 0, :] * wgt[..., 0, None]
    for k in range(1, 4):
        acc = acc + vals[..., k, :] * wgt[..., k, None]
    return acc


def grid_sample_matmul(x: torch.Tensor, grid: torch.Tensor,
                       align_corners: bool = False) -> torch.Tensor:
    """The warp as a one-hot product: the (B, P, H*W) matrix of the four
    float32 tap weights of each output point (taps that clamp onto one
    pixel add up, tap 0 to 3 in order), cast to x's dtype, contracted with
    the flattened x in ``promote_types(x.dtype, float32)`` with full-
    precision float32 products, and the result cast to x's dtype."""
    b, h, w, c = x.shape
    gb, gh, gw, _ = grid.shape
    if gb != b:
        raise ValueError(f"batch mismatch: x has {b}, grid has {gb}")
    idx, wgt = tap_indices_weights(h, w, grid.reshape(b, gh * gw, 2), align_corners)
    q = torch.arange(h * w, device=x.device)
    mat = (q == idx[..., 0, None]) * wgt[..., 0, None]
    for k in range(1, 4):
        mat = mat + (q == idx[..., k, None]) * wgt[..., k, None]
    cdt = torch.promote_types(x.dtype, torch.float32)
    with full_precision_f32():
        out = torch.einsum("bph,bhc->bpc", mat.to(x.dtype).to(cdt),
                           x.reshape(b, h * w, c).to(cdt))
    return out.to(x.dtype).reshape(b, gh, gw, c)


def grid_sample(x: torch.Tensor, grid: torch.Tensor,
                align_corners: bool = False) -> torch.Tensor:
    """Sample NHWC ``x`` (B, H, W, C) at normalized coordinates ``grid``
    (B, gh, gw, 2) -> (B, gh, gw, C).

    ``grid[..., 0]`` is x in [-1, 1] over the width, ``grid[..., 1]`` is y
    over the height. Out-of-range coordinates clamp to the edge.
    """
    b, h, w, c = x.shape
    gb, gh, gw, _ = grid.shape
    if gb != b:
        raise ValueError(f"batch mismatch: x has {b}, grid has {gb}")
    cdt = torch.promote_types(x.dtype, torch.float32)
    idx, wgt = tap_indices_weights(h, w, grid.reshape(b, gh * gw, 2), align_corners, cdt)
    flat = x.reshape(b, h * w, c)
    bi = torch.arange(b, device=x.device)[:, None, None]
    vals = flat[bi, idx].to(cdt)                     # (B, P, 4, C)
    out = blend_taps(vals, wgt.to(cdt))
    return out.to(x.dtype).reshape(b, gh, gw, c)


def grid_sample_backward(grad_out: torch.Tensor, grid: torch.Tensor, x_shape,
                         align_corners: bool = False) -> torch.Tensor:
    """The gradient of ``grid_sample`` with respect to x: ``grad_out``
    (B, gh, gw, C) scattered back to x's shape ``x_shape`` = (B, H, W, C).

    Each output point adds w_k * grad_out to the source pixel of its tap k,
    the transpose of the four-tap gather; the grid gets no gradient (the
    JAX package never differentiates grids, which are batch data). The
    taps are ``tap_indices_weights``'s; the sums run in
    ``promote_types(dtype, float32)``, tap 0, 1, 2 and 3 in that order, each
    over the points in order, and the result is cast to grad_out's dtype.
    """
    b, h, w, c = (int(s) for s in x_shape)
    gb, gh, gw, _ = grid.shape
    if gb != b or tuple(grad_out.shape) != (b, gh, gw, c):
        raise ValueError(f"grid_sample_backward: grad_out {tuple(grad_out.shape)} and "
                         f"grid {tuple(grid.shape)} do not match x {(b, h, w, c)}")
    cdt = torch.promote_types(grad_out.dtype, torch.float32)
    idx, wgt = tap_indices_weights(h, w, grid.reshape(b, gh * gw, 2), align_corners, cdt)
    g = grad_out.reshape(b, gh * gw, c).to(cdt)
    wgt = wgt.to(cdt)
    rows = idx + (torch.arange(b, device=idx.device) * (h * w))[:, None, None]
    acc = torch.zeros((b * h * w, c), dtype=cdt, device=grad_out.device)
    for k in range(4):
        acc.index_add_(0, rows[..., k].reshape(-1),
                       (g * wgt[..., k, None]).reshape(-1, c))
    return acc.reshape(b, h, w, c).to(grad_out.dtype)
