"""The s4GAN train step, single-frame and flow (counterpart of
floodseg_tpu/train/gan.py).

One step in the JAX package's order, with the generator forward of the
method (``single_frame_g_forward``: the whole model; ``flow_g_forward``:
the interpolated forward, K1 and K1-bwd):

  1. G on the labeled batch, then on the unlabeled one (BN running
     statistics updated in that order); CE of the labeled logits.
  2. D scores softmax(pred_u) + the min-max-normalised image; each sample
     whose sigmoid(logit) exceeds ``threshold_st`` contributes a CE
     against its own argmax pseudo-labels (a per-sample weight).
  3. D scores the one-hot labels of the gt batch + its normalised image;
     the feature-matching loss between the pooled D features of the two.
  4. The G update on CE + lambda_fm FM + gate lambda_st ST, where the gate
     (a sample passed, and this is not the first step) is computed on the
     card: no value is read back to the host.
  5. The D update on the mean of the BCEs of the detached fake and the
     real input.

D runs inside the G loss, so the G backward accumulates into G's
optimizer's parameters only (``backward(inputs=...)``): D's ``.grad`` sees
only the D loss. The step's generator splits into six seeds, as JAX's
``r_l, r_u, r_d1..r_d4``. A step is ``step(state_g, state_d, batch, rng)
-> (state_g, state_d, metrics)``, ``batch`` = {"l", "u", "gt"}; metrics
stay on the device (train/supervised.py).

Over the ranks of a ``world`` (train/supervised.py says how): G runs on
this rank's slices under ``data_parallel``; its logits, the labels and the
images are gathered, so D, its draws, the min-max normalisations, the
self-training selection and every loss see the global batch, replicated
on every rank. G's gradients are summed over the ranks; D's, computed on
the same gathered inputs everywhere, are already equal and are not.
"""

from typing import Callable, Dict, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from floodseg_tpu_torch.core.device import full_precision_f32
from floodseg_tpu_torch.ops.losses import (
    binary_cross_entropy,
    cross_entropy_loss,
    feature_matching_loss,
)
from floodseg_tpu_torch.models.layers import data_parallel
from floodseg_tpu_torch.parallel.mesh import World, gather, sum_gradients
from floodseg_tpu_torch.train.flow import flow_train_forward
from floodseg_tpu_torch.train.state import TrainState
from floodseg_tpu_torch.train.supervised import (
    dropout_seed,
    optimizer_params,
    split_seeds,
    step_metrics,
)


def one_hot_masks(labels: torch.Tensor, num_classes: int) -> torch.Tensor:
    """(B, H, W) -> (B, H, W, C) float32 one-hot; a label outside [0, C)
    (the ignore index 255) gives an all-zero row, as ``jax.nn.one_hot``."""
    valid = (labels >= 0) & (labels < num_classes)
    hot = F.one_hot(torch.where(valid, labels, 0).to(torch.int64), num_classes)
    return (hot * valid[..., None]).to(torch.float32)


def _minmax(x: torch.Tensor) -> torch.Tensor:
    """(x - min) / (max - min) over the whole batch tensor."""
    lo, hi = torch.min(x), torch.max(x)
    return (x - lo) / (hi - lo)


def _generator(seed: Optional[int]) -> Optional[torch.Generator]:
    return None if seed is None else torch.Generator().manual_seed(seed)


def single_frame_g_forward(model: nn.Module) -> Callable:
    """fwd(batch, seed) -> logits: the whole model in training mode on
    ``batch["frame_current"]``, ``pred`` only. The aux head still runs (its
    BN statistics update, its dropout draws), as in the JAX package."""
    def fwd(batch: Dict, seed: Optional[int]) -> torch.Tensor:
        images = batch["frame_current"]
        model.train()
        with dropout_seed(model, seed, images.device):
            return model(images)["pred"]

    return fwd


def flow_g_forward(model: nn.Module, feature_based: bool = True,
                   no_warp: bool = False) -> Callable:
    """fwd(batch, seed) -> logits: ``flow_train_forward`` in training mode,
    its dropout generator seeded with ``seed``."""
    def fwd(batch: Dict, seed: Optional[int]) -> torch.Tensor:
        return flow_train_forward(model, batch, _generator(seed), True, feature_based, no_warp)

    return fwd


def make_gan_train_step(g_forward: Callable, num_classes: int, ignore_index: int = 255,
                        threshold_st: float = 0.6, lambda_fm: float = 0.1,
                        lambda_st: float = 1.0,
                        gt_norm_by_labeled_max: bool = False,
                        world: Optional[World] = None) -> Callable:
    """train_step(state_g, state_d, batch, rng) -> (state_g, state_d,
    metrics), the generator's forward from ``single_frame_g_forward`` or
    ``flow_g_forward``, the discriminator ``state_d.model``.
    ``gt_norm_by_labeled_max``: the single-frame method's quirk of
    normalising the gt image by the labeled image's range (the flow method
    normalises it by its own). Metrics: loss (= loss_s + loss_d), loss_s,
    loss_ce, loss_fm, loss_st (gated), loss_d, st_count and the labeled
    batch's counts."""
    def train_step(state_g: TrainState, state_d: TrainState, batch: Dict,
                   rng: Optional[torch.Generator]):
        batch_l, batch_u, batch_gt = batch["l"], batch["u"], batch["gt"]
        label_l, label_gt = (gather(b["label"], world) for b in (batch_l, batch_gt))
        image_l, image_u, image_gt = (gather(b["frame_current"], world)
                                      for b in (batch_l, batch_u, batch_gt))
        r_l, r_u, r_d1, r_d2, r_d3, r_d4 = split_seeds(rng, 6)
        disc = state_d.model
        dev = image_l.device

        def g_apply(b, seed):
            with data_parallel(state_g.model, world):
                return gather(g_forward(b, seed), world)

        def d_apply(x, seed):
            disc.train()
            with dropout_seed(disc, seed, dev):
                return disc(x)

        with full_precision_f32():
            if gt_norm_by_labeled_max:
                gt_img = (image_gt - torch.min(image_gt)) / (torch.max(image_l)
                                                             - torch.min(image_l))
            else:
                gt_img = _minmax(image_gt)
            d_cat_gt = torch.cat([one_hot_masks(label_gt, num_classes), gt_img], dim=-1)

            pred_l = g_apply(batch_l, r_l)
            loss_ce = cross_entropy_loss(pred_l, label_l, ignore_index)
            pred_u = g_apply(batch_u, r_u)
            prob_u = torch.softmax(pred_u.to(torch.promote_types(pred_u.dtype, torch.float32)),
                                   dim=-1)
            pred_cat = torch.cat([prob_u, _minmax(image_u)], dim=-1)
            d_z, d_feat_pred = d_apply(pred_cat, r_d1)

            # find_good_maps as a per-sample weight
            sel = torch.sigmoid(d_z) > threshold_st
            count = torch.sum(sel)
            pseudo = torch.argmax(pred_u.detach(), dim=-1)
            st_weights = sel.to(torch.float32)[:, None, None].expand(pseudo.shape)
            loss_st = cross_entropy_loss(pred_u, pseudo, ignore_index=-1, weights=st_weights)

            _, d_feat_gt = d_apply(d_cat_gt, r_d2)
            loss_fm = feature_matching_loss(d_feat_pred, d_feat_gt)

            gate = ((count > 0) & (state_g.step > 0)).to(loss_st.dtype)
            loss_s = loss_ce + lambda_fm * loss_fm + gate * lambda_st * loss_st
            params_g = optimizer_params(state_g)
            state_g.optimizer.zero_grad(set_to_none=True)
            loss_s.backward(inputs=params_g)
            sum_gradients(params_g, world)
            state_g.apply_gradients()

            fake = pred_cat.detach()
            d_z_fake, _ = d_apply(fake, r_d3)
            d_z_real, _ = d_apply(d_cat_gt, r_d4)
            loss_d = (binary_cross_entropy(d_z_fake, torch.zeros_like(d_z_fake))
                      + binary_cross_entropy(d_z_real, torch.ones_like(d_z_real))) / 2.0
            state_d.optimizer.zero_grad(set_to_none=True)
            loss_d.backward()
            state_d.apply_gradients()

        loss_s, loss_d = loss_s.detach(), loss_d.detach()
        metrics = {"loss": loss_s + loss_d, "loss_s": loss_s, "loss_ce": loss_ce.detach(),
                   "loss_fm": loss_fm.detach(), "loss_st": (gate * loss_st).detach(),
                   "loss_d": loss_d, "st_count": count,
                   **step_metrics(pred_l, label_l, num_classes, ignore_index)}
        return state_g, state_d, metrics

    return train_step
