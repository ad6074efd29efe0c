"""Counts the yardstick computes from shapes and inputs alone: the bytes a
warp must move, and a model's operations (``reference/ops.py``'s
``FlopCounter`` over the reference run on the meta device).

Bytes count each input byte read once and each output byte written once,
whatever a kernel reads again:

- a single warp (K1): every pixel of the source that one of the bilinear
  taps of the grid touches, the grid, and the output;
- a warp chain (K2): its first map, its grids, and every step's map.
"""

import torch


def tap_indices(h: int, w: int, grid: torch.Tensor, align_corners: bool) -> torch.Tensor:
    """The flat source indices (..., 4) of the bilinear taps of ``grid``
    (..., 2), border padding: coordinates clamped to the image."""
    g = grid.to(torch.float32)
    gx, gy = g[..., 0], g[..., 1]
    if align_corners:
        fx, fy = (gx + 1) * 0.5 * (w - 1), (gy + 1) * 0.5 * (h - 1)
    else:
        fx, fy = ((gx + 1) * w - 1) * 0.5, ((gy + 1) * h - 1) * 0.5
    x0, y0 = torch.floor(fx).long(), torch.floor(fy).long()
    xs = (x0.clamp(0, w - 1), (x0 + 1).clamp(0, w - 1))
    ys = (y0.clamp(0, h - 1), (y0 + 1).clamp(0, h - 1))
    return torch.stack([y * w + x for y in ys for x in xs], dim=-1)


def warp_bytes(x_shape, itemsize: int, grid: torch.Tensor, align_corners: bool) -> int:
    """Bytes one warp of a (B, H, W, C) map onto ``grid`` (B, gh, gw, 2)
    float32 must move."""
    b, h, w, c = x_shape
    idx = tap_indices(h, w, grid, align_corners).reshape(b, -1)
    touched = sum(int(idx[i].unique().numel()) for i in range(b))
    out = b * grid.shape[1] * grid.shape[2] * c * itemsize
    return touched * c * itemsize + grid.numel() * 4 + out


def chain_bytes(gh: int, gw: int, c: int, itemsize: int, steps: int) -> int:
    """Bytes a chain of ``steps`` warps at grid resolution must move: its
    first map and its grids read, and the first map and every step's map
    written (the chain's output holds them all)."""
    plane = gh * gw * c * itemsize
    return plane + steps * gh * gw * 2 * 4 + (steps + 1) * plane


def meta_params(spec, counter, requires_grad: bool = False):
    """A ``Params`` of meta tensors for ``spec`` with ``counter``."""
    from benchmark.core.weights import parameter_names
    from benchmark.reference.ops import Params
    trainable = set(parameter_names(spec))
    tensors = {}
    for name, shape, kind in spec:
        keys = ([f"{name}.{k}" for k in ("weight", "bias", "running_mean", "running_var")]
                if kind.startswith("bn") else [name])
        for k in keys:
            t = torch.empty(shape, device="meta")
            tensors[k] = t.requires_grad_(requires_grad and k in trainable)
    return Params(tensors, counter)
