"""The U2PL contrastive semi-supervised trainer (counterpart of
floodseg_tpu/train/contrastive.py).

Teacher and student, entropy-ranked pseudo-label filtering, a class-wise
memory bank of high-entropy negatives (train/memory_bank.py) and InfoNCE
against class prototypes. One step, in the JAX package's order:

- ``sup_step`` (epochs before ``sup_only_epoch``): the student's
  supervised OHEM step, then a training-mode teacher forward on the
  labeled batch that only warms the teacher's BN statistics.
- ``sync_teacher`` at the boundary: the teacher takes the student's
  parameters. By default (``alias=True``) its parameters *are* the
  student's ``Parameter`` objects, as the reference's ``t.data = s.data``
  aliases the storage: the student's in-place update moves the teacher too
  and the reference's EMA is a no-op. ``alias=False`` copies them, for the
  real EMA (``true_ema``).
- ``semi_step``: pseudo-labels from the eval-mode teacher on the
  unlabeled batch, a coin-gated mixing augmentation (ops/u2pl.py), the
  teacher's training-mode forward on labeled + mixed unlabeled, the
  student's forward on the same, the OHEM supervised loss, the
  entropy-filtered unsupervised CE and the memory-bank InfoNCE; with
  ``true_ema`` the teacher's parameters become decay * t + (1 - decay) * s
  after the update.

The teacher is a second module: its own BN buffers, which its own
training-mode forwards update in place (models/layers.py::BatchNorm2d);
the eval-mode forward moves none. Its forwards run under
``torch.no_grad()`` (the JAX step's ``stop_gradient``). No value is read
back to the host in a step: the coin is a ``torch.where`` over the mixed
and the plain batch, and the contrastive terms' gates are ``torch.where``
on the device. Every random draw but dropout goes through a draws object
(ops/u2pl.py::U2PLDraws, or one a caller passes); dropout draws from
generators seeded from the step's generator, as the other steps'.

Over the ranks of a ``world`` (train/supervised.py says how): each rank
holds its slices of the labeled and unlabeled batches; the images and
labels are gathered, the pseudo-labels, the mixing and its draws are the
global batch's, the student and the teacher run on this rank's
contiguous share of the global labeled + mixed unlabeled batch under
``data_parallel`` (synchronised BN, global-shape dropout), and their
outputs are gathered, so the losses, the entropy percentiles, the
memory-bank draws and enqueue and the EMA are the same on every rank. The
contrastive loss stays divided by ``num_devices``, the world's size in a
run (the JAX package's quirk).

The schedules follow the JAX step's float32 rounding: ``epoch_frac``,
``drop_percent``, ``alpha_t``, ``100 - alpha_t`` and the true-EMA decay are
float32 values (numpy float32 on the host), promoted to the model's dtype
only where they meet it.
"""

import copy
from dataclasses import dataclass
from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.nn as nn

from floodseg_tpu_torch.core.device import full_precision_f32
from floodseg_tpu_torch.models.layers import data_parallel, init_flax_defaults_
from floodseg_tpu_torch.ops.losses import ohem_with_aux
from floodseg_tpu_torch.ops.u2pl import (
    U2PLDraws,
    compute_unsupervised_loss,
    generate_unsup_data,
    masked_percentile,
    masked_subset,
    nearest_resize_mask,
    softmax_entropy,
)
from floodseg_tpu_torch.parallel.mesh import World, gather, shard
from floodseg_tpu_torch.train.gan import one_hot_masks
from floodseg_tpu_torch.train.memory_bank import (
    MemoryBank,
    create_memory_bank,
    enqueue,
    sample_negatives,
)
from floodseg_tpu_torch.train.state import TrainState, create_train_state
from floodseg_tpu_torch.train.supervised import (
    backward_and_update,
    dropout_seed,
    gather_outputs,
    split_seeds,
    step_metrics,
)


@dataclass(frozen=True)
class ContrastiveConfig:
    """The reference's ContrastiveKWArgs and the step's own settings, with
    the JAX package's defaults."""
    enabled: bool = True
    negative_high_entropy: bool = True
    low_rank: int = 3
    high_rank: int = 20
    current_class_threshold: float = 0.3
    current_class_negative_threshold: float = 1.0
    low_entropy_threshold: float = 20.0
    num_negatives: int = 50
    num_queries: int = 256
    temperature: float = 0.5
    loss_weight: float = 1.0
    max_enqueue: int = 1024          # keys a class enqueues a step
    num_devices: int = 1             # the contrastive loss is divided by it


@dataclass
class U2PLState:
    """student: its TrainState (model, optimizer, schedule); teacher: a
    module of the same architecture (its parameters aliased to the
    student's after ``sync_teacher(alias=True)``); bank: the memory bank;
    teacher_synced: whether the boundary sync has happened (validation and
    testing serve the teacher only after it)."""
    student: TrainState
    teacher: nn.Module
    bank: MemoryBank
    teacher_synced: bool = False


def create_u2pl_state(model: nn.Module, optimizer: torch.optim.Optimizer,
                      schedule: Callable[[int], float], teacher: Optional[nn.Module] = None,
                      bank_capacity: int = 30000, bank_class0_capacity: int = 50000,
                      num_classes: int = 5, max_enqueue: int = 1024,
                      pretrained=None, seed: int = 0) -> U2PLState:
    """The state at step 0: the student ``model`` (``pretrained`` overlaid
    on it only), the ``teacher`` (None: a copy of the model's architecture
    with its own random weights and BN statistics from
    ``init_flax_defaults_`` seeded with ``seed``, made before the overlay),
    on the model's device, and an empty bank there."""
    if teacher is None:
        teacher = init_flax_defaults_(copy.deepcopy(model).cpu(),
                                      torch.Generator().manual_seed(seed))
    dev = next(model.parameters()).device
    teacher.to(dev)
    if dev.type == "cuda":
        teacher.to(memory_format=torch.channels_last)
    student = create_train_state(model, optimizer, schedule, pretrained)
    bank = create_memory_bank(num_classes, 256, bank_capacity, bank_class0_capacity,
                              max_enqueue, dev)
    return U2PLState(student=student, teacher=teacher, bank=bank)


@torch.no_grad()
def sync_teacher(state: U2PLState, alias: bool = True) -> U2PLState:
    """The boundary sync: the teacher's parameters become the student's
    ``Parameter`` objects (``alias``) or copies of them; its BN buffers
    stay its own."""
    for name, p in state.student.model.named_parameters():
        mod_name, _, leaf = name.rpartition(".")
        mod = state.teacher.get_submodule(mod_name)
        setattr(mod, leaf, p if alias else nn.Parameter(p.detach().clone(),
                                                        requires_grad=False))
    state.teacher_synced = True
    return state


def served_model(state: U2PLState) -> nn.Module:
    """The model validation and testing serve: the teacher once synced, the
    student before (the teacher is still its random init then)."""
    return state.teacher if state.teacher_synced else state.student.model


def class_ranks(prob: torch.Tensor) -> torch.Tensor:
    """Each class's rank in the stable descending sort of ``prob`` over the
    last axis (ties by class index)."""
    order = torch.argsort(-prob, dim=-1, stable=True)
    return torch.argsort(order, dim=-1)


def _rank_of_class(prob: torch.Tensor, c: int) -> torch.Tensor:
    """The stable descending-sort rank of class ``c`` at each pixel."""
    return class_ranks(prob)[..., c]


def _cos(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    def unit(x):
        return x / torch.clamp_min(torch.sqrt(torch.sum(x * x, dim=-1, keepdim=True)), 1e-8)
    return torch.sum(unit(a) * unit(b), dim=-1)


def contra_memobank_loss(draws, rep_all: torch.Tensor, rep_teacher: torch.Tensor,
                         label_l_oh: torch.Tensor, label_u_oh: torch.Tensor,
                         prob_l: torch.Tensor, prob_u: torch.Tensor,
                         low_mask: torch.Tensor, high_mask: torch.Tensor,
                         bank: MemoryBank, cfg: ContrastiveConfig,
                         prototype: Optional[torch.Tensor] = None, i_iter=None):
    """U2PL's memory-bank InfoNCE in fixed shapes (the reference's
    compute_contra_memobank_loss). For each class c:

    - anchors: ``num_queries`` student reps drawn with replacement from the
      low-entropy pixels of class c whose teacher probability exceeds
      ``current_class_threshold``;
    - negatives: up to ``max_enqueue`` teacher reps of the high-entropy
      pixels where c ranks in the top ``low_rank`` of a labeled pixel but is
      not its label, or in [low_rank, high_rank) of an unlabeled one, are
      enqueued first; then ``num_queries * num_negatives`` keys are drawn
      from the bank;
    - the positive: the teacher's mean rep over the class's low-entropy
      pixels (with ``prototype``, EMA-blended with the class's momentum
      prototype at min(1 - 1 / i_iter, 0.999) unless that is still all
      zeros);
    - the term: the mean CE of the positive among (positive, negatives) by
      cosine / temperature, in float32 as the JAX function computes it,
      gated to 0 without anchors or bank keys.

    The loss is the mean over classes with low-entropy pixels, 0 when at
    most one class has any. rep_all (B, H, W, D) with gradient, rep_teacher
    the same without, label_*_oh and prob_* (B*, H, W, C), low_mask and
    high_mask (B, H, W, 1). The bank changes in place. Returns the loss, or
    (the new prototypes, the loss) with ``prototype``; a prototype row is
    updated only for a class with anchors and keys, zeros elsewhere."""
    num_classes = prob_l.shape[-1]
    d = rep_all.shape[-1]
    f32 = torch.float32
    label_oh = torch.cat([label_l_oh, label_u_oh], dim=0)
    prob = torch.cat([prob_l, prob_u], dim=0)
    low_valid = label_oh * low_mask
    high_valid = label_oh * high_mask
    rep_flat = rep_all.reshape(-1, d)
    rep_t_flat = rep_teacher.detach().reshape(-1, d)
    ranks_l, ranks_u = class_ranks(prob_l), class_ranks(prob_u)
    q, n_neg = cfg.num_queries, cfg.num_negatives
    terms, class_valid, gates, new_protos = [], [], [], []
    for c in range(num_classes):
        prob_seg = prob[..., c]
        anchor_mask = (prob_seg > cfg.current_class_threshold) & (low_valid[..., c] > 0)
        neg_base = (prob_seg < cfg.current_class_negative_threshold) & (high_valid[..., c] > 0)
        cm_l = (ranks_l[..., c] < cfg.low_rank) & (label_l_oh[..., c] == 0)
        rank_u = ranks_u[..., c]
        cm_u = (rank_u >= cfg.low_rank) & (rank_u < cfg.high_rank)
        neg_mask = (neg_base & torch.cat([cm_l, cm_u], dim=0)).reshape(-1)

        lv_flat = (low_valid[..., c] > 0).reshape(-1)
        n_lv = lv_flat.sum()
        proto = (lv_flat.to(rep_t_flat.dtype) @ rep_t_flat) / torch.clamp_min(n_lv.to(f32), 1.0)

        neg_idx, neg_ok = masked_subset(draws.subset_scores(c, neg_mask.numel()), neg_mask,
                                        cfg.max_enqueue)
        enqueue(bank, c, rep_t_flat[neg_idx], neg_ok)

        anchors = rep_flat[draws.choice(c, anchor_mask.reshape(-1), q)]
        negs = sample_negatives(bank, c, draws.negatives(c, bank.counts[c], q * n_neg))
        pos = proto
        if prototype is not None:
            it = torch.as_tensor(i_iter, device=proto.device).to(f32)
            ema = torch.clamp_max(1.0 - 1.0 / torch.clamp_min(it, 1.0), 0.999)
            blended = (1.0 - ema) * proto + ema * prototype[c]
            pos = torch.where(torch.all(prototype == 0), proto, blended)
            new_protos.append(pos)
        allf = torch.cat([pos.to(f32).expand(q, 1, d), negs.reshape(q, n_neg, d).to(f32)], dim=1)
        logits = _cos(anchors[:, None, :].to(f32), allf) / cfg.temperature
        loss_c = torch.mean(-torch.log_softmax(logits, dim=-1)[:, 0])

        gate = (anchor_mask.sum() > 0) & (bank.counts[c] > 0)
        terms.append(torch.where(gate, loss_c, torch.zeros_like(loss_c)))
        class_valid.append((n_lv > 0).to(f32))
        gates.append(gate)
    valid = torch.stack(class_valid)
    valid_seg = valid.sum()
    loss = torch.sum(torch.stack(terms) * valid) / torch.clamp_min(valid_seg, 1.0)
    loss = torch.where(valid_seg <= 1, torch.zeros_like(loss), loss)
    if prototype is not None:
        return torch.stack(new_protos) * torch.stack(gates)[:, None].to(f32), loss
    return loss


def _f32(x) -> np.float32:
    return np.float32(x)


def make_u2pl_steps(num_classes: int, cfg: ContrastiveConfig = ContrastiveConfig(),
                    ignore_index: int = 255, aux_weight: float = 0.4,
                    ohem_thresh: float = 0.7, ohem_min_kept: int = 100000,
                    unsupervised_apply_aug: str = "cutmix",
                    unsupervised_drop_percent: float = 80.0,
                    unsupervised_loss_weight: float = 1.0, ema_decay: float = 0.99,
                    true_ema: bool = False, world: Optional[World] = None):
    """(sup_step, semi_step) on a ``U2PLState``:

    - ``sup_step(state, batch, rng)`` for the warm-up epochs;
    - ``semi_step(state, batch, rng, epoch_frac, rel_step, draws=None)``
      after them: ``epoch_frac`` = epoch / max_epochs (the drop-percent and
      alpha_t anneals), ``rel_step`` the steps since the boundary (the
      true-EMA warm-up), both host numbers; ``draws`` the step's random
      draws (None: ``U2PLDraws`` seeded from ``rng``).

    ``batch`` = {"l": {"frame_current", "label"}, "u": {"frame_current"}}
    on the models' device; ``rng`` a ``torch.Generator`` (or None), split
    into the step's seeds as the JAX step splits its key: (r_s, r_t) and
    (r_aug, r_coin, r_s, r_t, r_contra). Each returns (state, metrics):
    loss, sup_loss, unsup_loss and contra_loss, and the labeled batch's
    counts, on the device. ``true_ema`` needs a teacher synced with
    ``alias=False``. ``world``: the ranks the steps run over (module
    note)."""

    def forward(module, x, seed, dev):
        """``module`` in its mode on this rank's ``x``, outputs gathered."""
        with dropout_seed(module, seed, dev), data_parallel(module, world):
            return gather_outputs(module(x), world)

    def sup_step(state: U2PLState, batch: Dict, rng: Optional[torch.Generator]):
        student, teacher = state.student.model, state.teacher
        image_l, label_l = batch["l"]["frame_current"], gather(batch["l"]["label"], world)
        r_s, r_t = split_seeds(rng, 2)
        dev = image_l.device
        with full_precision_f32():
            student.train()
            out = forward(student, image_l, r_s, dev)
            loss = ohem_with_aux(out["pred"], out.get("aux"), label_l, aux_weight,
                                 ignore_index, ohem_thresh, ohem_min_kept)
            backward_and_update(state.student, loss, world)
            teacher.train()
            with torch.no_grad(), dropout_seed(teacher, r_t, dev), \
                    data_parallel(teacher, world):
                teacher(image_l)  # warms the teacher's BN statistics only
        loss = loss.detach()
        zero = torch.zeros_like(loss)
        return state, {"loss": loss, "sup_loss": loss, "unsup_loss": zero, "contra_loss": zero,
                       **step_metrics(out["pred"], label_l, num_classes, ignore_index)}

    def semi_step(state: U2PLState, batch: Dict, rng: Optional[torch.Generator],
                  epoch_frac: float, rel_step: int, draws=None):
        student, teacher = state.student.model, state.teacher
        image_l, label_l = (gather(batch["l"][k], world) for k in ("frame_current", "label"))
        image_u_rank = batch["u"]["frame_current"]
        image_u = gather(image_u_rank, world)
        n_l = image_l.shape[0]
        dev = image_l.device
        r_aug, r_coin, r_s, r_t, r_contra = split_seeds(rng, 5)
        if draws is None:
            draws = U2PLDraws(dev, r_aug, r_coin, r_contra)
        ef = _f32(epoch_frac)
        drop_percent = _f32(100.0) - _f32(100.0 - unsupervised_drop_percent) * (_f32(1.0) - ef)
        alpha_t = _f32(cfg.low_entropy_threshold) * (_f32(1.0) - ef)

        def f32_tensor(v):
            return torch.tensor(v, dtype=torch.float32, device=dev)

        with full_precision_f32():
            with torch.no_grad():
                teacher.eval()
                pred_t_u = gather(teacher(image_u_rank)["pred"], world)
                prob_t_u = torch.softmax(pred_t_u.to(torch.promote_types(pred_t_u.dtype,
                                                                         torch.float32)), -1)
                logits_u_aug, label_u_aug = torch.max(prob_t_u, dim=-1)
                label_u_aug = label_u_aug.to(torch.int32)
                image_u_aug = image_u
                if unsupervised_apply_aug:
                    mixed = generate_unsup_data(draws, image_u, label_u_aug, logits_u_aug,
                                                unsupervised_apply_aug, num_classes)
                    take = draws.coin() < 0.5
                    image_u_aug, label_u_aug, logits_u_aug = (
                        torch.where(take, m, o) for m, o in
                        zip(mixed, (image_u, label_u_aug, logits_u_aug)))
                image_all = torch.cat([image_l, image_u_aug], dim=0)
                image_rank = shard(image_all, world)

                teacher.train()
                out_t = forward(teacher, image_rank, r_t, dev)
                pred_t, rep_t = out_t["pred"], out_t["rep"]
                prob_t = torch.softmax(pred_t.to(torch.promote_types(pred_t.dtype,
                                                                     torch.float32)), -1)
                pred_t_u_large = pred_t[n_l:]

            student.train()
            out = forward(student, image_rank, r_s, dev)
            pred_all, rep_all = out["pred"], out["rep"]
            aux_l = out["aux"][:n_l] if out.get("aux") is not None else None
            sup_loss = ohem_with_aux(pred_all[:n_l], aux_l, label_l, aux_weight, ignore_index,
                                     ohem_thresh, ohem_min_kept)
            unsup_loss = compute_unsupervised_loss(
                pred_all[n_l:], label_u_aug, f32_tensor(drop_percent), pred_t_u_large,
                ignore_index) * unsupervised_loss_weight
            contra_loss = torch.zeros((), dtype=torch.float32, device=dev)
            if cfg.enabled:
                with torch.no_grad():
                    entropy = softmax_entropy(pred_t_u_large)
                    u_valid = label_u_aug != ignore_index
                    low_thresh = masked_percentile(entropy, u_valid, f32_tensor(alpha_t))
                    high_thresh = masked_percentile(entropy, u_valid,
                                                    f32_tensor(_f32(100.0) - alpha_t))
                    low_entropy = (entropy <= low_thresh) & u_valid
                    high_entropy = ((entropy >= high_thresh) & u_valid
                                    if cfg.negative_high_entropy else torch.ones_like(u_valid))
                    l_valid = (label_l != ignore_index).to(torch.float32)
                    size = pred_all.shape[1:3]
                    low_mask = nearest_resize_mask(
                        torch.cat([l_valid, low_entropy.to(torch.float32)])[..., None], size)
                    high_mask = nearest_resize_mask(
                        torch.cat([l_valid, high_entropy.to(torch.float32)])[..., None], size)
                    label_l_oh = nearest_resize_mask(one_hot_masks(label_l, num_classes), size)
                    label_u_oh = nearest_resize_mask(one_hot_masks(label_u_aug, num_classes),
                                                     size)
                contra_loss = contra_memobank_loss(
                    draws, rep_all, rep_t, label_l_oh, label_u_oh, prob_t[:n_l], prob_t[n_l:],
                    low_mask, high_mask, state.bank, cfg) / cfg.num_devices * cfg.loss_weight
            loss = sup_loss + unsup_loss + contra_loss
            backward_and_update(state.student, loss, world)

            if true_ema:
                decay = min(_f32(1.0) - _f32(1.0) / (_f32(rel_step) + _f32(1.0)), _f32(ema_decay))
                keep, take = float(decay), float(_f32(1.0) - decay)
                params = dict(student.named_parameters())
                with torch.no_grad():
                    for name, tp in teacher.named_parameters():
                        sp = params[name]
                        if tp is sp:
                            raise ValueError("true_ema needs a teacher synced with alias=False")
                        tp.copy_(keep * tp + take * sp)

        metrics = {"loss": loss.detach(), "sup_loss": sup_loss.detach(),
                   "unsup_loss": unsup_loss.detach(), "contra_loss": contra_loss.detach(),
                   **step_metrics(pred_all[:n_l], label_l, num_classes, ignore_index)}
        return state, metrics

    return sup_step, semi_step
