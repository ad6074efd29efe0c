"""Sliding-window crop predict (counterpart of the predict part of
floodseg_tpu/train/evaluate.py; the multi-scale flip test comes later).

The crop probabilities come back from the device once a window and are
averaged on the overlaps in a float64 canvas on the host, as in the JAX
package; the final float32 resize (align_corners=True) and the argmax run
on the device.
"""

import contextlib
import math
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from floodseg_tpu_torch.core.profiler import PhaseProfiler
from floodseg_tpu_torch.ops.resize import resize_bilinear
from floodseg_tpu_torch.video.grid import crop_motion_vectors_stack_np


def crop_offsets(new_h: int, new_w: int, crop_h: int, crop_w: int,
                 stride_rate: float = 2 / 3) -> List[tuple]:
    """Sliding-window start offsets (the reference's grid walk)."""
    stride_h = int(math.ceil(crop_h * stride_rate))
    stride_w = int(math.ceil(crop_w * stride_rate))
    grid_h = int(math.ceil(float(new_h - crop_h) / stride_h) + 1)
    grid_w = int(math.ceil(float(new_w - crop_w) / stride_w) + 1)
    offs = []
    for ih in range(grid_h):
        for iw in range(grid_w):
            e_h = min(ih * stride_h + crop_h, new_h)
            e_w = min(iw * stride_w + crop_w, new_w)
            offs.append((e_h - crop_h, e_w - crop_w))
    return offs


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def flow_sliding_window_predict(crop_fn: Callable, variables, batch: Dict, num_classes: int,
                                crop_h: int, crop_w: int, out_size,
                                stride_rate: float = 2 / 3,
                                profiler: Optional[PhaseProfiler] = None) -> torch.Tensor:
    """Crop-based clip prediction, the reference's default predict path.

    Every sliding-window crop runs the full n-frame interpolation with
    crop-renormalized grids (``crop_fn`` from make_flow_predict_crop_fn);
    the softmax probabilities are averaged on the overlaps, resized to
    ``out_size`` (align_corners=True) and argmaxed. ``batch``: one clip's
    frame_prev/frame_next (1, H, W, 3) and mvs_left/mvs_right
    (T, 1, bh, bw, 2). Returns (n, out_h, out_w) int32 maps on the device
    of the probabilities. A ``profiler`` records three regions a call:
    "crop_forward" (the crops through ``crop_fn``, ended by the profiler's
    sync), "crop_probs_to_host" and "crop_canvas" (the average; the resize
    and argmax are only enqueued).
    """
    def region(name):
        return profiler.profile(name) if profiler is not None else contextlib.nullcontext()

    fp = _host(batch["frame_prev"])[0]
    fn = _host(batch["frame_next"])[0]
    h, w = fp.shape[:2]
    ch, cw = min(crop_h, h), min(crop_w, w)
    offs = crop_offsets(h, w, ch, cw, stride_rate)
    ml_all = _host(batch["mvs_left"])[:, 0]    # (T, bh, bw, 2)
    mr_all = _host(batch["mvs_right"])[:, 0]

    fp_crops, fn_crops, ml_crops, mr_crops = [], [], [], []
    for sh, sw in offs:
        fp_crops.append(fp[sh:sh + ch, sw:sw + cw])
        fn_crops.append(fn[sh:sh + ch, sw:sw + cw])
        ml_crops.append(crop_motion_vectors_stack_np(ml_all, h, w, ch, cw, sh, sw))
        mr_crops.append(crop_motion_vectors_stack_np(mr_all, h, w, ch, cw, sh, sw))

    with region("crop_forward"):
        probs_dev = crop_fn(variables, np.stack(fp_crops), np.stack(fn_crops),
                            np.stack(ml_crops, axis=1), np.stack(mr_crops, axis=1))
    device = probs_dev.device
    with region("crop_probs_to_host"):
        probs = probs_dev.cpu().numpy()               # (N, n, ch, cw, C)
    del probs_dev  # the device buffer is free before the canvas is resized

    with region("crop_canvas"):
        n = probs.shape[1]
        canvas = np.zeros((n, h, w, num_classes), dtype=np.float64)
        count = np.zeros((1, h, w, 1), dtype=np.float64)
        for (sh, sw), p in zip(offs, probs):
            canvas[:, sh:sh + ch, sw:sw + cw] += p
            count[:, sh:sh + ch, sw:sw + cw] += 1
        canvas /= count
    out = resize_bilinear(torch.as_tensor(canvas.astype(np.float32), device=device),
                          tuple(out_size), align_corners=True)
    return torch.argmax(out, dim=-1).to(torch.int32)
