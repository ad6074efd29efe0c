"""Streaming segmentation metrics (counterpart of floodseg_tpu/ops/metrics.py).

``intersection_and_union`` runs in torch on the device of its inputs:
pixels whose target is ignore_index are excluded from all three histograms;
intersection counts pixels where pred == target per class. The meters
aggregate on the host in float64 (mIoU, mAcc, allAcc).
"""

import numpy as np
import torch


def intersection_and_union(pred: torch.Tensor, target: torch.Tensor, num_classes: int,
                           ignore_index: int = 255):
    """Per-class (intersection, union, target-area) counts of two int maps
    of one shape, three (num_classes,) float32 tensors on their device."""
    pred = torch.as_tensor(pred).reshape(-1).to(torch.int64)
    target = torch.as_tensor(target).reshape(-1).to(torch.int64)
    valid = target != ignore_index
    # ignored pixels go to an overflow bin that is dropped
    overflow = torch.full_like(pred, num_classes)
    pred_v = torch.where(valid, pred, overflow)
    target_v = torch.where(valid, target, overflow)
    inter_v = torch.where(valid & (pred == target), pred, overflow)
    # a fixed-size histogram by scatter_add_ (bincount on the card reads the
    # input's max back to size its output, which would stop the host);
    # values past the classes go to the dropped bin, as bincount's would
    n = num_classes + 1
    ones = torch.ones_like(pred)

    def hist(idx):
        return torch.zeros(n, dtype=torch.int64, device=idx.device).scatter_add_(
            0, idx.clamp_max(num_classes), ones)[:num_classes]

    area_inter, area_pred, area_target = hist(inter_v), hist(pred_v), hist(target_v)
    area_union = area_pred + area_target - area_inter
    return (area_inter.to(torch.float32), area_union.to(torch.float32),
            area_target.to(torch.float32))


def topk_accuracy(logits: torch.Tensor, targets: torch.Tensor, topk=(1,)):
    """Top-k classification accuracy percentages of logits (B, C) against
    targets (B,): one float32 tensor per k, each in [0, 100]."""
    _, pred = torch.topk(logits, max(topk), dim=-1)
    correct = pred == targets[:, None].to(pred.dtype)
    return [correct[:, :k].sum().to(torch.float32) * (100.0 / targets.shape[0])
            for k in topk]


class MetricMeter:
    """Host-side accumulator of intersection/union/target sums."""

    def __init__(self, num_classes: int):
        self.num_classes = num_classes
        self.reset()

    def reset(self):
        self.intersection = np.zeros(self.num_classes, dtype=np.float64)
        self.union = np.zeros(self.num_classes, dtype=np.float64)
        self.target = np.zeros(self.num_classes, dtype=np.float64)
        self.count = 0

    def update(self, intersection, union, target):
        self.intersection += np.asarray(intersection, dtype=np.float64)
        self.union += np.asarray(union, dtype=np.float64)
        self.target += np.asarray(target, dtype=np.float64)
        self.count += 1

    def iou_per_class(self):
        return self.intersection / np.maximum(self.union, 1e-10)

    def accuracy_per_class(self):
        return self.intersection / np.maximum(self.target, 1e-10)

    def summary(self):
        """The flood protocol: absent classes average in as 0."""
        return {
            "miou": float(np.mean(self.iou_per_class())),
            "macc": float(np.mean(self.accuracy_per_class())),
            "allacc": float(self.intersection.sum() / max(self.target.sum(), 1e-10)),
            "iou_class": self.iou_per_class().tolist(),
            "acc_class": self.accuracy_per_class().tolist(),
        }

    def summary_mmseg(self):
        """mmseg ``mean_iou`` semantics: per-class IoU and Acc are NaN where
        the denominator is zero, and the means exclude those classes."""
        with np.errstate(invalid="ignore", divide="ignore"):
            iou = np.where(self.union > 0,
                           self.intersection / np.where(self.union > 0, self.union, 1.0),
                           np.nan)
            acc = np.where(self.target > 0,
                           self.intersection / np.where(self.target > 0, self.target, 1.0),
                           np.nan)
        return {
            "miou": float(np.nanmean(iou)) if np.any(self.union > 0) else 0.0,
            "macc": float(np.nanmean(acc)) if np.any(self.target > 0) else 0.0,
            "allacc": float(self.intersection.sum() / max(self.target.sum(), 1e-10)),
            "iou_class": iou.tolist(),
            "acc_class": acc.tolist(),
        }


class AverageMeter:
    """Scalar running average."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val, n=1):
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / self.count
