"""The supervised training step, in plain PyTorch: the model's training
forward, OHEM cross-entropy on the prediction plus ``aux_weight`` times
that on the aux head, the gradients, and SGD with momentum and classic L2
weight decay (the decay added to the gradient before the momentum), the
trunk at the base learning rate and the heads at ``head_lr_scale`` times
it, under the poly schedule.

OHEM is the published ``OhemCrossEntropy2dTensor``: ignored pixels count
as probability 1; the threshold is the larger of ``thresh`` and the k-th
smallest target probability, k = min(pixels, min_kept); mining is off when
fewer than ``min_kept`` pixels are valid; the loss is the mean negative
log-likelihood over the valid pixels at or under the threshold.
"""

from typing import Dict, List, Sequence

import numpy as np
import torch


def ohem(logits: torch.Tensor, labels: torch.Tensor, ignore: int, thresh: float,
         min_kept: int) -> torch.Tensor:
    """logits (B, C, H, W) float32, labels (B, H, W) integers."""
    c = logits.shape[1]
    flat = logits.permute(0, 2, 3, 1).reshape(-1, c)
    lab = labels.reshape(-1).long()
    valid = lab != ignore
    safe = torch.where(valid, lab, torch.zeros_like(lab))
    logp = torch.log_softmax(flat, dim=1)
    target_p = torch.where(valid, logp.detach().gather(1, safe[:, None])[:, 0].exp(),
                           torch.ones_like(logp[:, 0]))
    k = min(flat.shape[0], min_kept)
    kth = torch.kthvalue(target_p, k).values
    threshold = torch.clamp_min(kth, thresh)
    if int(valid.sum()) < min_kept:
        threshold = torch.ones_like(threshold)
    kept = valid & (target_p <= threshold)
    nll = -logp.gather(1, safe[:, None])[:, 0]
    return (nll * kept).sum() / kept.sum().clamp_min(1)


def loss(out: Dict[str, torch.Tensor], labels: torch.Tensor, t: dict) -> torch.Tensor:
    value = ohem(out["pred"], labels, t["ignore_index"], t["ohem_thresh"], t["ohem_min_kept"])
    if "aux" in out and t["aux_weight"] > 0:
        value = value + t["aux_weight"] * ohem(out["aux"], labels, t["ignore_index"],
                                               t["ohem_thresh"], t["ohem_min_kept"])
    return value


def poly_lr(t: dict, step: int) -> float:
    """The poly schedule's learning rate at step ``step`` (0-based), in
    float32 arithmetic."""
    f32 = np.float32
    frac = f32(1.0) - f32(min(step, t["max_iter"])) / f32(t["max_iter"])
    return float(f32(t["lr"]) * frac ** f32(t["power"]))


def sgd_step(params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor],
             bufs: Dict[str, torch.Tensor], lr: float, t: dict,
             heads: Sequence[str]) -> None:
    """One SGD step in place: d = g + wd * p; buf = d (first step) or
    momentum * buf + d; p -= lr_group * buf."""
    for name, p in params.items():
        d = grads[name] + t["weight_decay"] * p
        if name in bufs:
            bufs[name].mul_(t["momentum"]).add_(d)
        else:
            bufs[name] = d.clone()
        scale = t["head_lr_scale"] if name.split(".", 1)[0] in heads else 1.0
        p.sub_(lr * scale * bufs[name])


def dropout_keeps(seed: int, shapes: List[tuple], device: torch.device) -> List[torch.Tensor]:
    """The keep masks a training forward draws from a generator on
    ``device`` seeded with ``seed``: for each (shape, rate) in order,
    uniform draws under 1 - rate."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return [torch.rand(shape, generator=gen, device=device) < 1.0 - rate
            for shape, rate in shapes]
