"""Segmentation losses (counterpart of floodseg_tpu/ops/losses.py).

- ``cross_entropy_loss``: mean CE over the pixels that are not
  ``ignore_index`` (torch ``nn.CrossEntropyLoss(ignore_index=...)``).
- ``ohem_cross_entropy``: online hard example mining CE, in the JAX
  package's static form of the reference's OhemCrossEntropy2dTensor:
  invalid pixels get probability 1, the k-th smallest target probability
  (k = min(pixels, min_kept)) comes from a sort, the threshold is
  max(k-th, thresh), and mining is skipped (threshold 1) when
  ``min_kept`` exceeds the valid pixels. No value is read back to the
  host, so a step never waits for the card.
- ``ohem_with_aux``: the main OHEM CE plus ``aux_weight`` times the aux's.
- ``binary_cross_entropy``: mean BCE from logits in the stable form, the
  s4GAN discriminator's (``BCELoss`` of the sigmoid).
- ``feature_matching_loss``: s4GAN's mean |mean(real) - mean(fake)| of the
  discriminator's pooled features.

Logits are NHWC. Everything computes at >= float32 (float64 stays float64).
"""

from typing import Optional

import torch


def _log_softmax(logits: torch.Tensor) -> torch.Tensor:
    return torch.log_softmax(logits.to(torch.promote_types(logits.dtype, torch.float32)),
                             dim=-1)


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       ignore_index: int = 255,
                       weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean CE over non-ignored pixels. logits (..., C), labels (...) int.
    ``weights`` (shaped as ``labels``) weigh each pixel; the mean divides by
    max(sum(valid * weights), 1)."""
    valid = labels != ignore_index
    safe = torch.where(valid, labels, 0).to(torch.int64)
    nll = -torch.gather(_log_softmax(logits), -1, safe[..., None])[..., 0]
    w = valid.to(torch.float32)
    if weights is not None:
        w = w * weights.to(torch.float32)
    return torch.sum(nll * w) / torch.clamp_min(torch.sum(w), 1.0)


def ohem_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                       ignore_index: int = 255, thresh: float = 0.7,
                       min_kept: int = 100000) -> torch.Tensor:
    """OHEM CE. logits (B, H, W, C), labels (B, H, W) int."""
    c = logits.shape[-1]
    flat = logits.reshape(-1, c)
    flat_labels = labels.reshape(-1)
    n = flat.shape[0]
    valid = flat_labels != ignore_index
    safe = torch.where(valid, flat_labels, 0).to(torch.int64)[:, None]
    num_valid = valid.sum()

    prob = torch.softmax(flat.to(torch.promote_types(flat.dtype, torch.float32)), dim=-1)
    target_prob = torch.where(valid, torch.gather(prob, 1, safe)[:, 0], 1.0)
    k = min(n, int(min_kept))
    kth = torch.sort(target_prob).values[k - 1]
    threshold = torch.where(kth > thresh, kth, torch.full_like(kth, thresh))
    threshold = torch.where(min_kept > num_valid, torch.ones_like(kth), threshold)
    kept = valid & (target_prob <= threshold)

    nll = -torch.gather(_log_softmax(flat), 1, safe)[:, 0]
    w = kept.to(torch.float32)
    return torch.sum(nll * w) / torch.clamp_min(torch.sum(w), 1.0)


def ohem_with_aux(pred: torch.Tensor, aux: Optional[torch.Tensor], labels: torch.Tensor,
                  aux_weight: float = 0.4, ignore_index: int = 255, thresh: float = 0.7,
                  min_kept: int = 100000) -> torch.Tensor:
    """The reference's CriterionOhem: main OHEM CE + aux_weight * aux's."""
    loss = ohem_cross_entropy(pred, labels, ignore_index, thresh, min_kept)
    if aux is not None and aux_weight > 0:
        loss = loss + aux_weight * ohem_cross_entropy(aux, labels, ignore_index, thresh,
                                                      min_kept)
    return loss


def binary_cross_entropy(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean BCE from logits: max(z, 0) - z t + log1p(exp(-|z|))."""
    dt = torch.promote_types(logits.dtype, torch.float32)
    z, t = logits.to(dt), targets.to(dt)
    return torch.mean(torch.clamp_min(z, 0) - z * t + torch.log1p(torch.exp(-torch.abs(z))))


def feature_matching_loss(d_feat_fake: torch.Tensor, d_feat_real: torch.Tensor) -> torch.Tensor:
    """Mean over features of |mean over the batch of the real features -
    that of the fake ones|."""
    dt = torch.promote_types(d_feat_fake.dtype, torch.float32)
    mf = torch.mean(d_feat_fake.to(dt), dim=0)
    mr = torch.mean(d_feat_real.to(dt), dim=0)
    return torch.mean(torch.abs(mr - mf))
