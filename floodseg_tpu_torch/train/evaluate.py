"""Test-time and sliding-window inference (counterpart of
floodseg_tpu/train/evaluate.py).

The single-frame test (``make_crop_forward``, ``sliding_window_predict``,
``multi_scale_test``): every crop of a scale is normalised, flip-augmented
and run on the device as one batch (up to ``max_batch`` crops); the
probabilities are averaged on the overlaps in a float64 canvas on the
host and resized with cv2's bilinear arithmetic (ops/cv2_compat.py, no
cv2 on the card's machine). The flow test (``flow_sliding_window_test``)
runs all crops of a frame as one device call and averages them the same
way. The crop predict (``flow_sliding_window_predict``) averages on the
host too, then resizes (float32, align_corners=True) and argmaxes on the
device.
"""

import contextlib
import math
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn as nn

from floodseg_tpu_torch.core.device import DeviceLike, resolve_device
from floodseg_tpu_torch.core.profiler import PhaseProfiler
from floodseg_tpu_torch.data.transforms import MEAN, _pad_constant
from floodseg_tpu_torch.ops.cv2_compat import cv2_resize_linear
from floodseg_tpu_torch.ops.resize import resize_bilinear
from floodseg_tpu_torch.parallel.mesh import World, gather, shard
from floodseg_tpu_torch.train.flow import _bind, _normalizer, _prepare
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


def _regions(profiler: Optional[PhaseProfiler]):
    def region(name):
        return profiler.profile(name) if profiler is not None else contextlib.nullcontext()
    return region


def _average(offs, probs, shape, num_classes: int, crop_h: int, crop_w: int) -> np.ndarray:
    """The crops' probabilities (N, ..., crop_h, crop_w, C) summed into a
    float64 canvas of ``shape`` (..., H, W) + (C,) at their offsets and
    divided by each pixel's count of crops."""
    canvas = np.zeros(tuple(shape) + (num_classes,), dtype=np.float64)
    count = np.zeros(tuple(shape[-2:]) + (1,), dtype=np.float64)
    for (sh, sw), p in zip(offs, probs):
        canvas[..., sh:sh + crop_h, sw:sw + crop_w, :] += p
        count[sh:sh + crop_h, sw:sw + crop_w] += 1
    canvas /= count
    return canvas


def make_crop_forward(model: nn.Module, num_classes: int, flip: bool = True,
                      device: DeviceLike = None, world: Optional[World] = None) -> Callable:
    """Batched crop forward of the single-frame test: raw [0, 255] crops ->
    softmax probabilities.

    Returns fn(variables, crops (N, ch, cw, 3)) -> (N, ch, cw, num_classes)
    float32 on the device: the crops normalised with MEAN/STD in float32
    on the device, with ``flip`` their horizontal flips appended, the
    model's ``pred`` in eval mode sliced to ``num_classes`` and resized to
    the crop (align_corners=True) where it is not at crop size, the
    float32 softmax, and with ``flip`` the mean of each crop's and its
    flip's (flipped back) probabilities. ``variables`` is bound to the
    model for the call (train/flow.py says how).

    Over the ranks of ``world`` (parallel/mesh.py) the crops, padded to a
    multiple of the ranks by repeating the last one, are shared out in
    contiguous parts; the probabilities are gathered to every rank and the
    padding dropped (the JAX ``make_crop_forward(mesh=...)``).
    """
    dev = resolve_device(device)
    _prepare(model, dev)
    norm = _normalizer(dev)

    def run(crops):
        x = norm(crops)
        n, hw = x.shape[0], tuple(x.shape[1:3])
        if flip:
            x = torch.cat([x, torch.flip(x, dims=(2,))], dim=0)
        out = model(x)["pred"][..., :num_classes]
        if tuple(out.shape[1:3]) != hw:
            out = resize_bilinear(out, hw, align_corners=True)
        prob = torch.softmax(out.to(torch.float32), dim=-1)
        if flip:
            prob = (prob[:n] + torch.flip(prob[n:], dims=(2,))) / 2
        return prob

    call = _bind(model, run)
    if world is None or not world.parallel:
        return call

    def dp_call(variables, crops):
        n = crops.shape[0]
        pad = (-n) % world.size
        if pad:
            crops = np.concatenate([crops, np.repeat(crops[-1:], pad, axis=0)])
        return gather(call(variables, shard(crops, world)), world)[:n]

    return dp_call


def sliding_window_predict(crop_forward: Callable, variables, image: np.ndarray,
                           num_classes: int, crop_h: int, crop_w: int, out_h: int, out_w: int,
                           stride_rate: float = 2 / 3, max_batch: int = 8,
                           profiler: Optional[PhaseProfiler] = None) -> np.ndarray:
    """Probability map (out_h, out_w, num_classes) float32 of one scaled
    float32 image (H, W, 3): padded with MEAN to at least the crop
    (centred, as cv2.copyMakeBorder), cut into sliding-window crops, run
    through ``crop_forward`` ``max_batch`` crops a call, averaged in a
    float64 canvas, the padding cut off, and resized to (out_h, out_w) as
    cv2.resize(INTER_LINEAR) resizes float32. A ``profiler`` records
    "crop_forward" (the calls, ended by its sync), "crop_probs_to_host"
    and "crop_canvas" (the average and the resize)."""
    region = _regions(profiler)
    ori_h, ori_w = image.shape[:2]
    pad_h, pad_w = max(crop_h - ori_h, 0), max(crop_w - ori_w, 0)
    ph, pw = pad_h // 2, pad_w // 2
    if pad_h or pad_w:
        image = _pad_constant(image, ph, pad_h - ph, pw, pad_w - pw, MEAN)
    new_h, new_w = image.shape[:2]
    offs = crop_offsets(new_h, new_w, crop_h, crop_w, stride_rate)
    crops = np.stack([image[sh:sh + crop_h, sw:sw + crop_w] for sh, sw in offs]
                     ).astype(np.float32)
    with region("crop_forward"):
        probs_dev = [crop_forward(variables, crops[s:s + max_batch])
                     for s in range(0, len(crops), max_batch)]
    with region("crop_probs_to_host"):
        probs = np.concatenate([p.cpu().numpy() for p in probs_dev], axis=0)
    del probs_dev
    with region("crop_canvas"):
        canvas = _average(offs, probs, (new_h, new_w), num_classes, crop_h, crop_w)
        canvas = canvas[ph:ph + ori_h, pw:pw + ori_w]
        return cv2_resize_linear(canvas.astype(np.float32), (out_h, out_w))


def multi_scale_test(crop_forward: Callable, variables, image: np.ndarray, num_classes: int,
                     crop_h: int, crop_w: int, scales: Sequence[float] = (1.0,),
                     base_size: int = 2048, stride_rate: float = 2 / 3,
                     profiler: Optional[PhaseProfiler] = None) -> np.ndarray:
    """The single-frame test of one image: (H, W, 3) float32 in [0, 255]
    (the test transform only resizes) -> (H, W) int64 class map.

    For each scale the long side is round(scale * base_size) and the other
    side keeps the aspect (Python's round, half to even); the image is
    resized there as cv2.resize(INTER_LINEAR) resizes float32, and
    ``sliding_window_predict`` gives its probabilities at (H, W). The
    scales' maps are summed in float64, divided by their count, argmaxed.
    """
    h, w = image.shape[:2]
    acc = np.zeros((h, w, num_classes), dtype=np.float64)
    for scale in scales:
        long_size = round(scale * base_size)
        if h > w:
            new_h, new_w = long_size, round(long_size / float(h) * w)
        else:
            new_h, new_w = round(long_size / float(w) * h), long_size
        scaled = cv2_resize_linear(np.asarray(image, np.float32), (new_h, new_w))
        acc += sliding_window_predict(crop_forward, variables, scaled, num_classes, crop_h,
                                      crop_w, h, w, stride_rate, profiler=profiler)
    acc /= len(scales)
    return np.argmax(acc, axis=2)


def _crop_stack(batch: Dict, offs, crop_h: int, crop_w: int):
    """A one-sample batch's frame crops and crop-renormalized grid chains
    at ``offs``: (fp (N, ch, cw, 3), fn, mvs_left (T, N, bh, bw, 2),
    mvs_right)."""
    fp = _host(batch["frame_prev"])[0]
    fn = _host(batch["frame_next"])[0]
    h, w = fp.shape[:2]
    ml_all = _host(batch["mvs_left"])[:, 0]    # (T, bh, bw, 2)
    mr_all = _host(batch["mvs_right"])[:, 0]
    fp_crops, fn_crops, ml_crops, mr_crops = [], [], [], []
    for sh, sw in offs:
        fp_crops.append(fp[sh:sh + crop_h, sw:sw + crop_w])
        fn_crops.append(fn[sh:sh + crop_h, sw:sw + crop_w])
        ml_crops.append(crop_motion_vectors_stack_np(ml_all, h, w, crop_h, crop_w, sh, sw))
        mr_crops.append(crop_motion_vectors_stack_np(mr_all, h, w, crop_h, crop_w, sh, sw))
    return (np.stack(fp_crops), np.stack(fn_crops), np.stack(ml_crops, axis=1),
            np.stack(mr_crops, axis=1))


def flow_sliding_window_test(crop_fn: Callable, variables, batch: Dict, num_classes: int,
                             crop_h: int, crop_w: int, stride_rate: float = 2 / 3,
                             profiler: Optional[PhaseProfiler] = None) -> np.ndarray:
    """The flow test of one sample with crop-wise grid renormalization.

    ``batch``: frame_prev/frame_next (1, H, W, 3), normalised (the flow
    test transform normalises), time-major grids (T, 1, gh, gw, 2) and
    left/right_index (1,). Every crop runs in one call of ``crop_fn``
    (make_flow_test_crop_fn) with the indices repeated for each crop; the
    probabilities are averaged in a float64 canvas on the host. Returns
    the (H, W) int64 argmax. The crop is not clamped to the frame (as in
    the JAX package; the crop predict clamps it). ``profiler``: the regions
    of ``sliding_window_predict``.
    """
    region = _regions(profiler)
    h, w = batch["frame_prev"].shape[1:3]
    offs = crop_offsets(h, w, crop_h, crop_w, stride_rate)
    fp, fn, ml, mr = _crop_stack(batch, offs, crop_h, crop_w)
    li = np.repeat(np.asarray(batch["left_index"])[:1], len(offs))
    ri = np.repeat(np.asarray(batch["right_index"])[:1], len(offs))
    with region("crop_forward"):
        probs_dev = crop_fn(variables, fp, fn, ml, mr, li, ri)
    with region("crop_probs_to_host"):
        probs = probs_dev.cpu().numpy()
    del probs_dev
    with region("crop_canvas"):
        canvas = _average(offs, probs, (h, w), num_classes, crop_h, crop_w)
        return np.argmax(canvas, axis=-1)


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
    region = _regions(profiler)
    h, w = batch["frame_prev"].shape[1:3]
    ch, cw = min(crop_h, h), min(crop_w, w)
    offs = crop_offsets(h, w, ch, cw, stride_rate)
    fp, fn, ml, mr = _crop_stack(batch, offs, ch, cw)
    with region("crop_forward"):
        probs_dev = crop_fn(variables, fp, fn, ml, mr)
    device = probs_dev.device
    with region("crop_probs_to_host"):
        probs = probs_dev.cpu().numpy()               # (N, n, ch, cw, C)
    del probs_dev  # the device buffer is free before the canvas is resized

    with region("crop_canvas"):
        canvas = _average(offs, probs, (probs.shape[1], h, w), num_classes, ch, cw)
    out = resize_bilinear(torch.as_tensor(canvas.astype(np.float32), device=device),
                          tuple(out_size), align_corners=True)
    return torch.argmax(out, dim=-1).to(torch.int32)
