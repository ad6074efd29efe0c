"""Keyframe-warp segmentation of one window, in plain PyTorch.

The published method (the repository's ``FlowInterpolator``): encode the
two key frames, warp the previous key's map forward along the window's
block-motion grids and the next key's backward along the inverse grids
(each step a bilinear warp with border padding, align_corners=False, of the
previous step's result; the first warp takes the feature map to the grid's
resolution), resize each warped map back to the feature size
(align_corners=True), blend frame p as (n - p) / n forward + p / n
backward, take the key map itself through the identity grid
(align_corners=True) and back, decode all n maps, resize the logits to the
output size (align_corners=True) and take the argmax.

``window_logits`` returns the n decoded logit maps at feature resolution
and the raw encoding of the next key; the output-size resize is left to
the comparison, which does it in blocks.
"""

from typing import Callable, Tuple

import torch
import torch.nn.functional as F

from benchmark.reference.ops import resize


def warp(x: torch.Tensor, grid: torch.Tensor, align_corners: bool) -> torch.Tensor:
    """NCHW x (1, C, H, W) sampled at grid (1, gh, gw, 2) -> (1, C, gh, gw)."""
    return F.grid_sample(x, grid, mode="bilinear", padding_mode="border",
                         align_corners=align_corners)


def chain(f: torch.Tensor, grids: torch.Tensor) -> torch.Tensor:
    """f (1, C, H, W), grids (T, 1, gh, gw, 2) -> (T, C, H, W): step k is f
    warped through grids[0..k], resized back to (H, W)."""
    h, w = f.shape[-2:]
    out = []
    y = f
    for k in range(grids.shape[0]):
        y = warp(y, grids[k], align_corners=False)
        out.append(resize(y, (h, w), align_corners=True))
    return torch.cat(out, dim=0)


def window_logits(encode: Callable, decode: Callable, frame_prev: torch.Tensor,
                  frame_next: torch.Tensor, mvs_left: torch.Tensor, mvs_right: torch.Tensor,
                  identity: torch.Tensor, n: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """encode: (1, 3, H, W) -> (1, C, h, w); decode: (k, C, h, w) ->
    (k, classes, h, w). frame_*: normalised NCHW key frames; mvs_left,
    mvs_right: (n-1, 1, gh, gw, 2); identity: (gh, gw, 2). Returns
    ((n, classes, h, w) logits, the next key's (1, C, h, w) encoding)."""
    f_prev, f_next = encode(frame_prev), encode(frame_next)
    fh, fw = f_prev.shape[-2:]
    key = resize(warp(f_prev, identity[None], align_corners=True), (fh, fw), True)
    logits = [decode(key)]
    fwd = chain(f_prev, mvs_left)
    bwd = chain(f_next, mvs_right)
    for p in range(1, n):
        inter = (n - p) / n * fwd[p - 1:p] + p / n * bwd[n - 1 - p:n - p]
        logits.append(decode(inter))
    return torch.cat(logits, dim=0), f_next
