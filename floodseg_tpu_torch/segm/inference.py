"""Sliding-window inference and evaluation of the standalone Segmenter
(counterpart of floodseg_tpu/segm/inference.py).

The mmseg protocol: windows anchored on a stride with a final flush window;
the windows' logits merged by averaging where they overlap; per variant
(the image, and its mirror with ``flip``) the merged logits resized to the
original shape (align_corners=False), the mirror undone, a softmax; then
the variants' probabilities averaged. The stride is clamped to the window
so that no pixel is left uncovered.

Everything runs on the model's device: the windows of an image go through
the model in batches of up to MAX_WINDOWS (the JAX package pads the
count to a power of two to keep one compiled program; the probabilities are
the same), the merge adds the windows in their order in float32, as the
JAX package's host loop does. ``evaluate_dataset`` scores the argmax at
the label's resolution (``MetricMeter.summary_mmseg``); over the ranks of
a ``world`` each rank takes every size-th image and the counts are summed.
"""

from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from floodseg_tpu_torch.core.device import full_precision_f32
from floodseg_tpu_torch.ops.metrics import MetricMeter, intersection_and_union
from floodseg_tpu_torch.ops.resize import resize_bilinear
from floodseg_tpu_torch.parallel.mesh import World, all_reduce_array

MAX_WINDOWS = 16  # windows a forward


def window_anchors(length: int, window: int, stride: int) -> List[int]:
    """Anchor offsets covering [0, length) with a final flush window."""
    if length <= window:
        return [0]
    anchors = [a for a in range(0, length, stride) if a < length - window]
    return anchors + [length - window]


def _device(model: nn.Module) -> torch.device:
    return next(model.parameters()).device


@torch.no_grad()
def _window_logits(model: nn.Module, crops: torch.Tensor) -> torch.Tensor:
    with full_precision_f32():
        model.eval()
        return torch.cat([model(crops[i:i + MAX_WINDOWS])["pred"].float()
                          for i in range(0, crops.shape[0], MAX_WINDOWS)])


@torch.no_grad()
def sliding_inference(model: nn.Module, image, num_classes: int, window_size: int,
                      window_stride: int, ori_shape: Optional[Tuple[int, int]] = None,
                      flip: bool = False) -> torch.Tensor:
    """Softmax probabilities (H_ori, W_ori, C), float32 on the model's
    device, of one normalized (H, W, 3) image (numpy or a tensor)."""
    dev = _device(model)
    image = torch.as_tensor(np.ascontiguousarray(image) if isinstance(image, np.ndarray)
                            else image).to(dev, torch.float32)
    h, w = image.shape[:2]
    ori_shape = tuple(ori_shape or (h, w))
    ws = min(window_size, h, w)
    window_stride = min(window_stride, ws)
    ha = window_anchors(h, ws, window_stride)
    wa = window_anchors(w, ws, window_stride)
    variants = [image, image.flip(1)] if flip else [image]
    prob_sum = None
    for vi, im in enumerate(variants):
        crops = torch.stack([im[a:a + ws, b:b + ws] for a in ha for b in wa])
        logits = _window_logits(model, crops)
        acc = torch.zeros((h, w, num_classes), dtype=torch.float32, device=dev)
        cnt = torch.zeros((h, w, 1), dtype=torch.float32, device=dev)
        i = 0
        for a in ha:
            for b in wa:
                acc[a:a + ws, b:b + ws] += logits[i]
                cnt[a:a + ws, b:b + ws] += 1.0
                i += 1
        logit = (acc / cnt)[None]
        if ori_shape != (h, w):
            with full_precision_f32():
                logit = resize_bilinear(logit, ori_shape, align_corners=False)
        prob = torch.softmax(logit[0], dim=-1)
        if vi:
            prob = prob.flip(1)
        prob_sum = prob if prob_sum is None else prob_sum + prob
    return prob_sum / len(variants)


def evaluate_dataset(model: nn.Module, dataset, num_classes: int, window_size: int,
                     window_stride: int, ignore_index: int = 255, flip: bool = False,
                     world: Optional[World] = None) -> dict:
    """mmseg-protocol evaluation of a dataset whose samples carry
    ``frame_current`` (resized, normalized) and ``label`` (at annotation
    resolution): ``MetricMeter.summary_mmseg()`` of every image's argmax
    scored at the label's shape."""
    dev = _device(model)
    meter = MetricMeter(num_classes)
    erng = np.random.default_rng(0)
    par = world is not None and world.parallel
    sums = np.zeros((3, num_classes), np.float64)
    for i in range(len(dataset)):
        if par and i % world.size != world.rank:
            continue
        s = dataset.get(i, erng)
        label = torch.from_numpy(np.asarray(s["label"])).to(dev)
        prob = sliding_inference(model, s["frame_current"], num_classes, window_size,
                                 window_stride, ori_shape=tuple(label.shape), flip=flip)
        counts = intersection_and_union(prob.argmax(-1), label, num_classes, ignore_index)
        sums += np.stack([c.cpu().numpy() for c in counts])
    sums = all_reduce_array(sums, world)
    meter.update(*sums)
    return meter.summary_mmseg()
