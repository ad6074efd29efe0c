"""Training and testing from files on one device (counterpart of the
``supervised``, ``flow_supervised``, ``gan``, ``flow_gan`` and
``contrastive`` wiring of the JAX package's ``Runner.fit`` and
``Runner.test``, floodseg_tpu/cli/runner.py).

``run_fit`` (single-frame ``supervised``), ``run_flow_fit``
(``flow_supervised``), ``run_gan_fit`` (s4GAN, ``gan`` and ``flow_gan``)
and ``run_contrastive_fit`` (U2PL, ``contrastive``) build what
``Runner.fit`` builds for their method without the config layer, the
logger and the checkpoints: the method's transforms with their sizing
rules, the train dataset of each role (``SemDataset`` or ``FlowDataset``:
"l", and for the semi-supervised methods "u", and for s4GAN "gt", split
as ``Runner._train_datasets`` splits them), each behind its own infinite,
shuffled, ``drop_last`` loader that copies each batch to the device, the
optimizers and poly schedules, and the method's train and eval steps. All
run one loop (``_fit_loop``): the epochs' steps, validation every
``check_val_every_n_epoch`` epochs through the eval step, and the early
stopping counter. Step metrics stay on the device and are read back once
an epoch. ``FitConfig`` holds the settings; the CLI makes it from the
layered YAML (core/config.py::fit_config), and its defaults are that
layering's for flow_supervised PSPNet-50. The crop size is linked to the
architecture as ``apply_links`` links it (``round_train``). ``FitHooks``
is what the CLI's Runner (cli/runner.py) adds around the loop: resume,
a checkpoint and the logger's records every epoch.

``run_test`` evaluates a model on the held-out lists (test.txt, test2.txt)
as ``Runner.test`` does: the single-frame methods through the multi-scale
flip sliding window (train/evaluate.py::multi_scale_test), the flow
methods through the crop sliding window (flow_sliding_window_test) or,
with ``no_cropping``, the whole-frame eval step; ``contrastive`` serves
the U2PL teacher once it is synced, the student before.
"""

import os
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn

from floodseg_tpu_torch.core.config import default_fit_config, round_train
from floodseg_tpu_torch.core.device import DeviceLike, resolve_device
from floodseg_tpu_torch.core.profiler import PhaseProfiler
from floodseg_tpu_torch.data.dataset import FlowDataset, SemDataset
from floodseg_tpu_torch.data.loader import DataLoader, device_put
from floodseg_tpu_torch.data.transforms import (
    MEAN,
    Compose,
    build_test_transform,
    build_train_transform,
    build_val_transform,
)
from floodseg_tpu_torch.models.discriminator import S4GANDiscriminator
from floodseg_tpu_torch.models.layers import init_from_generator_
from floodseg_tpu_torch.ops.metrics import MetricMeter, intersection_and_union
from floodseg_tpu_torch.train.contrastive import (
    ContrastiveConfig,
    U2PLState,
    create_u2pl_state,
    make_u2pl_steps,
    served_model,
    sync_teacher,
)
from floodseg_tpu_torch.train.evaluate import (
    flow_sliding_window_test,
    make_crop_forward,
    multi_scale_test,
)
from floodseg_tpu_torch.train.flow import (
    make_flow_eval_step,
    make_flow_test_crop_fn,
    make_flow_train_step,
)
from floodseg_tpu_torch.train.gan import (
    flow_g_forward,
    make_gan_train_step,
    single_frame_g_forward,
)
from floodseg_tpu_torch.train.optim import AUX_KEYS, make_optimizer, model_arch
from floodseg_tpu_torch.train.state import TrainState, create_train_state
from floodseg_tpu_torch.train.supervised import make_eval_step, make_loss_fn, make_train_step


@dataclass
class FitConfig:
    """The settings ``run_fit``, ``run_flow_fit``, ``run_gan_fit``,
    ``run_contrastive_fit``, ``run_validate`` and ``run_test`` read, named
    as in the config (model.*, data.*, trainer.*; core/config.py::FIELDS
    says which field each comes from). It has no defaults of its own: the
    CLI makes it from the layered YAML (core/config.py::fit_config), and
    ``default_fit_config(**overrides)`` is the repository's flow_supervised
    PSPNet-50 layering with overrides, the one source of the values a
    caller does not set.

    ``train_h`` and ``train_w`` are the crop before ``round_train``, which
    the run applies for the model's architecture as ``apply_links`` does.
    ``aux_weight`` is the single-frame method's (0 turns the aux loss off).
    ``test_h`` and ``test_w`` are the test crop, None for the rounded train
    crop (the link ``apply_links`` makes).

    The s4GAN settings: ``lr_D`` (the discriminator's Adam),
    ``threshold_st``, ``lambda_fm``, ``lambda_st`` and ``data_ratio`` (the
    labeled share of train.txt when there is no train_u.txt). The
    generator's loss is plain CE (``loss`` is not read).

    The U2PL settings (``contrastive``): ``contrastive`` (the ContrastiveCfg
    step settings), ``bank_capacity``, ``bank_class0_capacity`` and
    ``true_ema`` (model.contrastive.*), ``sup_only_epoch``,
    ``unsupervised_apply_aug``, ``unsupervised_drop_percent``,
    ``unsupervised_loss_weight`` and ``ema_decay``; the loss is always OHEM
    plus the aux loss at ``aux_weight`` (``loss`` is not read)."""
    data_variant: Optional[str]
    classes: int
    ignore_index: int
    classes_ignore: Sequence[int]
    train_h: int
    train_w: int
    resize_h: int
    resize_w: int
    resize_factor: float
    scale_min: float
    scale_max: float
    no_cropping: bool
    frame_delta: int
    no_random_frame_delta: bool
    feature_based: bool
    no_warp: bool
    no_interpolation_percentage: float
    aux_weight: float
    batch_size: int
    batch_size_val: int
    workers: int
    optimizer: str
    lr: float
    momentum: float
    weight_decay: float
    power: float
    loss: str
    ohem_thresh: float
    ohem_min_kept: int
    max_epochs: int
    seed: int
    check_val_every_n_epoch: int
    early_stopping_patience: int
    early_stopping_min_delta: float
    limit_train_batches: Optional[int]
    limit_val_batches: Optional[int]
    test_h: Optional[int]
    test_w: Optional[int]
    test_scales: Sequence[float]
    test_base_size: int
    resize_factor_test: float
    batch_size_test: int
    workers_test: int
    limit_test_batches: Optional[int]
    lr_D: float
    threshold_st: float
    lambda_fm: float
    lambda_st: float
    data_ratio: float
    contrastive: ContrastiveConfig
    bank_capacity: int
    bank_class0_capacity: int
    true_ema: bool
    sup_only_epoch: int
    unsupervised_apply_aug: str
    unsupervised_drop_percent: float
    unsupervised_loss_weight: float
    ema_decay: float


def crop_size(cfg: FitConfig, arch: str) -> Tuple[int, int]:
    """The train crop (h, w) for ``arch``: each side through ``round_train``
    (``apply_links`` also sets train_h from train_w; the configs' crops are
    square)."""
    return round_train(cfg.train_h, arch), round_train(cfg.train_w, arch)


def _test_crop(cfg: FitConfig, arch: str) -> Tuple[int, int]:
    """The test crop (h, w): ``test_h``/``test_w``, or the rounded train
    crop where they are None."""
    th, tw = crop_size(cfg, arch)
    return (th if cfg.test_h is None else cfg.test_h,
            tw if cfg.test_w is None else cfg.test_w)


def sem_transforms(cfg: FitConfig, arch: str) -> Dict[str, Compose]:
    """The single-frame train, val and test transforms of
    ``Runner._transforms``: all resize to the frame size; train rotates,
    and pads a crop larger than the scaled frame with MEAN (labels with the
    ignore index); val is center-cropped; test only resizes (float32, not
    normalised: the test normalises each crop on the device)."""
    th, tw = crop_size(cfg, arch)
    resize = (cfg.resize_h, cfg.resize_w)
    classes_ignore = list(cfg.classes_ignore)
    return {
        "train": build_train_transform(th, tw, classes_ignore, cfg.scale_min,
                                       cfg.scale_max, resize, with_rotate=True,
                                       crop_padding=MEAN, ignore_index=cfg.ignore_index),
        "val": build_val_transform(th, tw, classes_ignore, resize, crop_padding=MEAN,
                                   ignore_index=cfg.ignore_index),
        "test": build_test_transform(classes_ignore, resize, normalize=False),
    }


def flow_frame_size(cfg: FitConfig, arch: str, factor: float) -> Tuple[int, int]:
    """The frame size of the flow test transform (``factor`` =
    ``resize_factor_test``) and of predict (``resize_factor_predict``):
    (the val resize's height, the train resize's width) times ``factor``,
    each side for the ViT a multiple of 32 (at least 32) so that the token
    grid spans the frame. ``no_cropping`` trains on frames resized to 1.5x
    the crop and validates on the crop; otherwise both resize to the frame
    size times ``resize_factor``."""
    th, tw = crop_size(cfg, arch)
    if cfg.no_cropping:
        size = (th, int(tw * 1.5) + 1)
    else:
        size = (int(cfg.resize_h * cfg.resize_factor), int(cfg.resize_w * cfg.resize_factor))
    size = (int(size[0] * factor), int(size[1] * factor))
    if arch == "vit":
        size = tuple(max(32, round_train(side, "vit")) for side in size)
    return size


def flow_transforms(cfg: FitConfig, arch: str = "pspnet") -> Dict[str, Compose]:
    """The train, val and test transforms with the flow sizing rules of
    ``Runner._transforms``: with ``no_cropping`` the train frames are
    resized to 1.5x the crop and scaled down into it, and val is resized
    to the crop; otherwise both resize to the frame size times
    ``resize_factor`` and val is center-cropped. The train crop pads with
    nothing (a scaled frame smaller than the crop raises); ``no_warp``
    also rotates. Test resizes to ``flow_frame_size`` at
    ``resize_factor_test`` and normalises."""
    th, tw = crop_size(cfg, arch)
    scale_min, scale_max = cfg.scale_min, cfg.scale_max
    if cfg.resize_factor != 1.0:
        scale_min = 1.0
    if cfg.no_cropping:
        factor = 1.5
        resize = (int(th * factor) + 1, int(tw * factor) + 1)
        resize_val = (th, tw)
        scale_min, scale_max = 1.0 / factor + 0.001, 1.0
    else:
        resize = (int(cfg.resize_h * cfg.resize_factor), int(cfg.resize_w * cfg.resize_factor))
        resize_val = resize
    test_resize = flow_frame_size(cfg, arch, cfg.resize_factor_test)
    return {
        "train": build_train_transform(th, tw, list(cfg.classes_ignore), scale_min, scale_max,
                                       resize, with_rotate=cfg.no_warp, crop_padding=None,
                                       ignore_index=cfg.ignore_index),
        "val": build_val_transform(th, tw, list(cfg.classes_ignore), resize_val,
                                   crop=not cfg.no_cropping, crop_padding=None,
                                   ignore_index=cfg.ignore_index),
        "test": build_test_transform(list(cfg.classes_ignore), test_resize, normalize=True),
    }


def _list_path(data_root: str, variant: Optional[str], name: str) -> str:
    if variant:
        return os.path.join(data_root, "list", variant, name)
    return os.path.join(data_root, "list", name)


def step_generator(seed: int, global_step: int) -> torch.Generator:
    """The step's dropout generator (the JAX Runner's fold_in(rng, step))."""
    return torch.Generator().manual_seed(
        int(np.random.default_rng((seed, global_step)).integers(2 ** 62)))


def _prepare(model: nn.Module, dev: torch.device) -> nn.Module:
    model.to(dev)
    if dev.type == "cuda":
        model.to(memory_format=torch.channels_last)
    return model


# the seed offsets of the roles' shuffle streams (Runner._train_loaders)
ROLE_SEED_OFFSETS = {"l": 0, "u": 1, "gt": 2}

FLOW_METHODS = ("flow_supervised", "flow_gan")
GAN_METHODS = ("gan", "flow_gan")
SEMI_METHODS = GAN_METHODS + ("contrastive",)
METHODS = ("supervised", "flow_supervised", "gan", "flow_gan", "contrastive")


def train_loaders(cfg: FitConfig, roles: Mapping[str, object],
                  device: DeviceLike = None) -> Tuple[Dict[str, DataLoader], int]:
    """``Runner._train_loaders`` on one device: for each role of ``roles``
    ("l", and "u" and "gt" for s4GAN) an infinite, shuffled, ``drop_last``
    loader of ``batch_size`` with the role's seed offset that copies each
    batch to ``device``; and the steps an epoch, the longer of the labeled
    and unlabeled sets over the batch (at least 1), then at most
    ``limit_train_batches``. A labeled or unlabeled set smaller than the
    batch raises (its loader would yield nothing)."""
    dev = resolve_device(device)
    batch = cfg.batch_size
    small = {name: len(roles[k]) for k, name in (("l", "labeled"), ("u", "unlabeled"))
             if k in roles and len(roles[k]) < batch}
    if small:
        raise ValueError(f"batch {batch} exceeds the train set(s) {small}; lower batch_size "
                         f"or adjust data_ratio")
    put = (lambda b: device_put(b, dev))
    loaders = {k: DataLoader(ds, batch_size=batch, shuffle=True, num_workers=cfg.workers,
                             seed=cfg.seed + ROLE_SEED_OFFSETS[k], infinite=True,
                             drop_last=True, device_put=put)
               for k, ds in roles.items()}
    steps_per_epoch = max(1, max(len(roles[k]) // batch for k in ("l", "u") if k in roles))
    if cfg.limit_train_batches is not None:
        steps_per_epoch = min(steps_per_epoch, cfg.limit_train_batches)
    return loaders, steps_per_epoch


def _flow_dataset(cfg: FitConfig, split: str, data_root: str, path: str, role: str,
                  transform) -> FlowDataset:
    return FlowDataset(split, data_root, path, type=role, transform=transform,
                       frame_delta=cfg.frame_delta, no_warp=cfg.no_warp,
                       no_random_frame_delta=cfg.no_random_frame_delta)


def val_dataset(cfg: FitConfig, data_root: str, method: str, arch: str):
    """The val split of ``method`` as ``Runner._dataset("val", "val.txt",
    "l", tf["val"])`` makes it: a "l" ``FlowDataset`` under the flow val
    transform for the flow methods, else a ``SemDataset`` under the
    single-frame one. The fit's validation and ``run_validate`` read it."""
    path = _list_path(data_root, cfg.data_variant, "val.txt")
    if method in FLOW_METHODS:
        return _flow_dataset(cfg, "val", data_root, path, "l", flow_transforms(cfg, arch)["val"])
    return SemDataset("val", data_root, path, sem_transforms(cfg, arch)["val"])


def _val_loader(cfg: FitConfig, val_ds, dev: torch.device) -> DataLoader:
    return DataLoader(val_ds, batch_size=cfg.batch_size_val, num_workers=cfg.workers,
                      seed=cfg.seed, device_put=lambda b: device_put(b, dev))


def eval_step_for(model: nn.Module, cfg: FitConfig, method: str) -> Callable:
    """The eval step validation runs for ``method``: the flow one
    (interpolated, whole frame) for the flow methods, else the
    single-frame one."""
    if method in FLOW_METHODS:
        return make_flow_eval_step(model, cfg.classes, cfg.ignore_index, cfg.feature_based,
                                   cfg.no_warp)
    return make_eval_step(model, cfg.classes, cfg.ignore_index)


def _validate(cfg: FitConfig, eval_fn: Callable, state, val_loader: DataLoader) -> MetricMeter:
    """One validation pass: ``eval_fn(state, batch)`` over at most
    ``limit_val_batches`` batches, its counts in a ``MetricMeter``."""
    meter = MetricMeter(cfg.classes)
    for bi, batch in enumerate(val_loader):
        if cfg.limit_val_batches is not None and bi >= cfg.limit_val_batches:
            break
        m = eval_fn(state, batch)
        meter.update(*(m[k].cpu().numpy() for k in ("intersection", "union", "target")))
    return meter


def _max_iter(cfg: FitConfig, steps_per_epoch: int) -> int:
    return max(1, steps_per_epoch * cfg.max_epochs)


def _state(model: nn.Module, cfg: FitConfig, steps_per_epoch: int,
           pretrained: Optional[Mapping[str, torch.Tensor]],
           exclude: Sequence[str] = ()) -> TrainState:
    opt, schedule = make_optimizer(model, cfg.lr, _max_iter(cfg, steps_per_epoch),
                                   cfg.optimizer.lower(), cfg.momentum, cfg.weight_decay,
                                   cfg.power, exclude=exclude)
    return create_train_state(model, opt, schedule, pretrained)


def method_state(model: nn.Module, cfg: FitConfig, method: str, steps_per_epoch: int,
                 pretrained: Optional[Mapping[str, torch.Tensor]] = None,
                 discriminator: Optional[nn.Module] = None,
                 teacher: Optional[nn.Module] = None, device: DeviceLike = None):
    """The state ``method`` trains, at step 0, for ``model`` (moved to
    ``device``) with the poly schedule of ``steps_per_epoch`` steps an epoch:
    a ``TrainState`` (SGD or Adam over the trunk and head groups) for
    "supervised" and "flow_supervised"; for s4GAN the (generator,
    discriminator) pair, the generator's optimizer without the aux heads
    (``AUX_KEYS``: never updated), the discriminator's Adam (``lr_D``,
    betas (0.9, 0.99), no weight decay, one group; the same poly schedule),
    ``discriminator`` or one with weights drawn from a generator seeded with
    ``seed``; for "contrastive" a ``U2PLState`` (create_u2pl_state: the
    ``teacher`` or one drawn from ``seed + 1``, the bank on the model's
    device). ``pretrained`` goes on ``model`` only. The run_* functions and
    the CLI's Runner (to restore a checkpoint into) build it here."""
    dev = resolve_device(device)
    _prepare(model, dev)
    if method in GAN_METHODS:
        state_g = _state(model, cfg, steps_per_epoch, pretrained, exclude=AUX_KEYS)
        if discriminator is None:
            discriminator = init_from_generator_(S4GANDiscriminator(cfg.classes),
                                                 torch.Generator().manual_seed(cfg.seed))
        _prepare(discriminator, dev)
        opt_d, schedule_d = make_optimizer(discriminator, cfg.lr_D,
                                           _max_iter(cfg, steps_per_epoch), "adam",
                                           weight_decay=0.0, power=cfg.power,
                                           head_lr_scale=1.0, betas=(0.9, 0.99))
        return state_g, TrainState(0, discriminator, opt_d, schedule_d)
    if method == "contrastive":
        opt, schedule = make_optimizer(model, cfg.lr, _max_iter(cfg, steps_per_epoch),
                                       cfg.optimizer.lower(), cfg.momentum, cfg.weight_decay,
                                       cfg.power)
        return create_u2pl_state(model, opt, schedule, teacher, cfg.bank_capacity,
                                 cfg.bank_class0_capacity, cfg.classes,
                                 cfg.contrastive.max_enqueue, pretrained, seed=cfg.seed + 1)
    if method not in ("supervised",) + FLOW_METHODS:
        raise ValueError(f"unknown method {method!r}")
    return _state(model, cfg, steps_per_epoch, pretrained)


class FitHooks:
    """What a caller adds around the epochs (the CLI's Runner resumes,
    saves a checkpoint and logs through these; cli/runner.py). ``start(state,
    steps_per_epoch)`` returns the state to train, the epoch to start at and
    the early-stopping state (best validation mIoU, its epoch, validations
    without improvement) to start from; the steps before the start epoch
    count as taken, so each step's generator is the one it would have had.
    ``end_epoch(epoch, state, record, global_step, early_stop)`` runs after
    each epoch's validation and early-stopping update, with the epoch's
    record and the early-stopping state after it. These defaults start
    afresh and do nothing."""

    def start(self, state, steps_per_epoch: int):
        return state, 0, (-np.inf, -1, 0)

    def end_epoch(self, epoch: int, state, record: Dict, global_step: int,
                  early_stop: Tuple[float, int, int]) -> None:
        pass


def _fit_loop(cfg: FitConfig, state, train_fn: Callable, eval_fn: Callable,
              loaders: Mapping[str, DataLoader], val_loader: DataLoader,
              steps_per_epoch: int, profiler: Optional[PhaseProfiler],
              on_step: Optional[Callable[[int, object, Dict], None]],
              on_epoch: Optional[Callable[[int], None]] = None,
              hooks: Optional[FitHooks] = None) -> Dict:
    """The epochs: ``train_fn(state, batch, generator)`` for each step,
    metrics read back once an epoch, validation through ``eval_fn(state,
    batch)`` and early stopping on the validation mIoU. ``state`` is the
    method's (a ``TrainState``, or s4GAN's (generator, discriminator)
    pair); ``batch`` is the "l" loader's batch when it is the only role,
    else the dict of every role's batch, as the JAX Runner draws them.

    Returns a summary: per epoch the mean train loss, the train mIoU and,
    on validation epochs, the validation mIoU, mAcc, accuracy and counts;
    the best validation mIoU and its epoch; the steps taken; the final
    state. ``profiler`` records each step's wait for its batches
    (``train_load``) and the step (``train_step``; give the profiler a sync
    to time the device); ``on_step(global_step, state, metrics)`` runs
    after each step; ``on_epoch(epoch)`` before each epoch's first step
    (the host counter of a method whose step depends on the epoch);
    ``hooks`` a ``FitHooks``. Each record also holds ``epoch_time``, the
    seconds of the epoch's steps and read-back."""
    profiler = profiler or PhaseProfiler()
    hooks = hooks or FitHooks()
    epochs: List[Dict] = []
    state, start_epoch, (best_metric, best_epoch, wait_count) = hooks.start(
        state, steps_per_epoch)
    val_every = max(1, cfg.check_val_every_n_epoch)
    global_step = start_epoch * steps_per_epoch
    its = {k: iter(v) for k, v in loaders.items()}
    try:
        for epoch in range(start_epoch, cfg.max_epochs):
            t0 = time.perf_counter()
            if on_epoch is not None:
                on_epoch(epoch)
            step_metrics = []
            for _ in range(steps_per_epoch):
                with profiler.profile("train_load"):
                    batch = {k: next(it) for k, it in its.items()}
                    if len(batch) == 1:
                        batch = batch["l"]
                with profiler.profile("train_step"):
                    state, metrics = train_fn(state, batch,
                                              step_generator(cfg.seed, global_step))
                step_metrics.append(metrics)
                if on_step is not None:
                    on_step(global_step, state, metrics)
                global_step += 1
            # one read-back an epoch
            host = [{k: v.cpu().numpy() for k, v in m.items()} for m in step_metrics]
            meter = MetricMeter(cfg.classes)
            for m in host:
                meter.update(m["intersection"], m["union"], m["target"])
            record = {"epoch": epoch,
                      "train_loss": float(np.mean([float(m["loss"]) for m in host])),
                      "train_miou": meter.summary()["miou"],
                      "epoch_time": time.perf_counter() - t0}
            do_val = (epoch + 1) % val_every == 0 and cfg.limit_val_batches != 0
            if do_val:
                val_meter = _validate(cfg, eval_fn, state, val_loader)
                vs = val_meter.summary()
                record.update(val_miou=vs["miou"], val_macc=vs["macc"],
                              val_accuracy=vs["allacc"],
                              val_counts={k: getattr(val_meter, k).copy()
                                          for k in ("intersection", "union", "target")})
            epochs.append(record)
            stop = False
            if do_val:
                if record["val_miou"] > best_metric + cfg.early_stopping_min_delta:
                    best_metric, best_epoch, wait_count = record["val_miou"], epoch, 0
                else:
                    wait_count += 1
                    stop = wait_count >= cfg.early_stopping_patience
            hooks.end_epoch(epoch, state, record, global_step,
                            (best_metric, best_epoch, wait_count))
            if stop:
                break
    finally:
        for it in its.values():
            it.close()
    return {"epochs": epochs, "steps": global_step, "steps_per_epoch": steps_per_epoch,
            "best_val_miou": float(best_metric) if np.isfinite(best_metric) else None,
            "best_epoch": best_epoch, "state": state}


def run_fit(model: nn.Module, data_root: str, cfg: Optional[FitConfig] = None,
            pretrained: Optional[Mapping[str, torch.Tensor]] = None,
            profiler: Optional[PhaseProfiler] = None,
            on_step: Optional[Callable[[int, TrainState, Dict], None]] = None,
            device: DeviceLike = None, hooks: Optional[FitHooks] = None) -> Dict:
    """Train ``model`` (any of the port's three architectures) on the tree
    at ``data_root`` as the JAX package's ``Runner.fit`` does for
    ``supervised`` on one device: single frames through ``SemDataset``,
    the whole model in training mode, OHEM (or CE) on ``pred`` plus
    ``aux_weight`` times that on ``aux``, validation on center crops.
    ``pretrained``: state_dict entries overlaid first (shape-checked);
    returns ``_fit_loop``'s summary, with its ``profiler``, ``on_step``
    and ``hooks`` (``FitHooks``)."""
    cfg = cfg or default_fit_config()
    dev = resolve_device(device)
    _prepare(model, dev)
    arch = model_arch(model)
    train_ds = SemDataset("train", data_root,
                          _list_path(data_root, cfg.data_variant, "train.txt"),
                          sem_transforms(cfg, arch)["train"])
    val_ds = val_dataset(cfg, data_root, "supervised", arch)
    loaders, steps_per_epoch = train_loaders(cfg, {"l": train_ds}, dev)
    state = method_state(model, cfg, "supervised", steps_per_epoch, pretrained, device=dev)
    loss_fn = make_loss_fn(cfg.loss, cfg.aux_weight, cfg.ignore_index, cfg.ohem_thresh,
                           cfg.ohem_min_kept)
    train_step = make_train_step(model, loss_fn, cfg.classes, cfg.ignore_index)
    eval_step = eval_step_for(model, cfg, "supervised")
    return _fit_loop(cfg, state, train_step, eval_step, loaders, _val_loader(cfg, val_ds, dev),
                     steps_per_epoch, profiler, on_step, hooks=hooks)


def run_flow_fit(model: nn.Module, data_root: str, cfg: Optional[FitConfig] = None,
                 pretrained: Optional[Mapping[str, torch.Tensor]] = None,
                 profiler: Optional[PhaseProfiler] = None,
                 on_step: Optional[Callable[[int, TrainState, Dict], None]] = None,
                 device: DeviceLike = None, hooks: Optional[FitHooks] = None) -> Dict:
    """Train ``model`` (any of the port's three architectures) on the tree
    at ``data_root`` as the JAX package's ``Runner.fit`` does for
    ``flow_supervised`` on one device: FlowDataset items, the interpolated
    and plain train steps with the host-side ``no_interpolation_percentage``
    coin, whole-frame validation through the interpolated eval step.
    ``pretrained``, the hooks and the summary as in ``run_fit``."""
    cfg = cfg or default_fit_config()
    dev = resolve_device(device)
    _prepare(model, dev)
    arch = model_arch(model)
    train_ds = _flow_dataset(cfg, "train", data_root,
                             _list_path(data_root, cfg.data_variant, "train.txt"), "l",
                             flow_transforms(cfg, arch)["train"])
    val_ds = val_dataset(cfg, data_root, "flow_supervised", arch)
    loaders, steps_per_epoch = train_loaders(cfg, {"l": train_ds}, dev)
    state = method_state(model, cfg, "flow_supervised", steps_per_epoch, pretrained,
                         device=dev)
    loss_fn = make_loss_fn(cfg.loss, 0.0, cfg.ignore_index, cfg.ohem_thresh,
                           cfg.ohem_min_kept)
    interp_step, plain_step = make_flow_train_step(model, loss_fn, cfg.classes,
                                                   cfg.ignore_index, cfg.feature_based,
                                                   cfg.no_warp)
    eval_step = eval_step_for(model, cfg, "flow_supervised")
    coin = np.random.default_rng(cfg.seed)

    def train_fn(state, batch, rng):
        plain = (cfg.no_interpolation_percentage > 0
                 and coin.random() < cfg.no_interpolation_percentage)
        return (plain_step if plain else interp_step)(state, batch, rng)

    return _fit_loop(cfg, state, train_fn, eval_step, loaders, _val_loader(cfg, val_ds, dev),
                     steps_per_epoch, profiler, on_step, hooks=hooks)


def _set_items(ds, items) -> None:
    ds.items = list(items)
    if hasattr(ds, "length"):
        ds.length = len(ds.items)


def role_datasets(cfg: FitConfig, data_root: str, method: str,
                  transform: Optional[Callable] = None) -> Dict[str, object]:
    """The train datasets by role of a semi-supervised ``method`` (s4GAN's
    ``gan`` and ``flow_gan``, U2PL's ``contrastive``), as
    ``Runner._train_datasets`` and ``Runner._train_loaders`` make them:
    "l" over train.txt and "u" over train_u.txt when it exists; otherwise
    train.txt split into disjoint "l" and "u" sets by ``data_ratio`` with
    ``np.random.default_rng(seed).permutation``, raising when either side
    would be empty; for s4GAN also "gt" over the labeled set's items. Flow
    roles are ``FlowDataset`` of the role's type; single-frame ones
    ``SemDataset``, the "u" role's the "test" split (its labels are
    zeros)."""
    flow = method in FLOW_METHODS

    def dataset(list_name: str, role: str):
        path = _list_path(data_root, cfg.data_variant, list_name)
        if flow:
            return _flow_dataset(cfg, "train", data_root, path, role, transform)
        return SemDataset("test" if role == "u" else "train", data_root, path, transform)

    ds_l = dataset("train.txt", "l")
    if os.path.exists(_list_path(data_root, cfg.data_variant, "train_u.txt")):
        ds_u = dataset("train_u.txt", "u")
    else:
        ds_u = dataset("train.txt", "u")
        items = list(ds_l.items)
        perm = np.random.default_rng(cfg.seed).permutation(len(items))
        size_l = int(cfg.data_ratio * len(items))
        if size_l == 0 or size_l == len(items):
            raise ValueError(
                f"data_ratio={cfg.data_ratio} splits {len(items)} train items into "
                f"l={size_l}/u={len(items) - size_l}; a semi-supervised method needs both "
                f"non-empty: adjust data_ratio or provide train_u.txt")
        _set_items(ds_l, [items[i] for i in perm[:size_l]])
        _set_items(ds_u, [items[i] for i in perm[size_l:]])
    if method not in GAN_METHODS:
        return {"l": ds_l, "u": ds_u}
    ds_gt = dataset("train.txt", "gt")
    _set_items(ds_gt, ds_l.items)
    return {"l": ds_l, "u": ds_u, "gt": ds_gt}


def run_gan_fit(model: nn.Module, data_root: str, cfg: Optional[FitConfig] = None,
                method: str = "flow_gan", discriminator: Optional[nn.Module] = None,
                pretrained: Optional[Mapping[str, torch.Tensor]] = None,
                profiler: Optional[PhaseProfiler] = None,
                on_step: Optional[Callable[[int, Tuple[TrainState, TrainState], Dict],
                                           None]] = None,
                device: DeviceLike = None, hooks: Optional[FitHooks] = None) -> Dict:
    """Train ``model`` (the generator, any of the port's three
    architectures) on the tree at ``data_root`` as the JAX package's
    ``Runner.fit`` does for s4GAN ``method`` ("flow_gan" or "gan") on one
    device: the three roles' loaders (``role_datasets``, ``train_loaders``),
    the generator's SGD over the trunk and head groups without the aux
    heads (``AUX_KEYS``: never updated), the discriminator's Adam (``lr_D``,
    betas (0.9, 0.99), no weight decay, one group; the same poly schedule),
    the s4GAN step (train/gan.py; the flow method's generator forward is the
    interpolated one) and validation through the generator's eval step (the
    flow or the single-frame one). ``discriminator``: an
    ``S4GANDiscriminator`` for ``cfg.classes`` (None: one with weights drawn
    from a generator seeded with ``cfg.seed``). The state the hooks see and
    the summary's "state" are the (generator, discriminator) pair;
    otherwise ``pretrained``, the hooks and the summary as in ``run_fit``."""
    cfg = cfg or default_fit_config()
    if method not in GAN_METHODS:
        raise ValueError(f"run_gan_fit takes 'gan' or 'flow_gan', got {method!r}")
    flow = method in FLOW_METHODS
    dev = resolve_device(device)
    _prepare(model, dev)
    arch = model_arch(model)
    roles = role_datasets(cfg, data_root, method,
                          (flow_transforms if flow else sem_transforms)(cfg, arch)["train"])
    val_ds = val_dataset(cfg, data_root, method, arch)
    loaders, steps_per_epoch = train_loaders(cfg, roles, dev)
    state_g, state_d = method_state(model, cfg, method, steps_per_epoch, pretrained,
                                    discriminator=discriminator, device=dev)
    g_forward = (flow_g_forward(model, cfg.feature_based, cfg.no_warp) if flow
                 else single_frame_g_forward(model))
    step = make_gan_train_step(g_forward, cfg.classes, cfg.ignore_index, cfg.threshold_st,
                               cfg.lambda_fm, cfg.lambda_st, gt_norm_by_labeled_max=not flow)
    eval_step = eval_step_for(model, cfg, method)

    def train_fn(state, batch, rng):
        state_g, state_d, metrics = step(state[0], state[1], batch, rng)
        return (state_g, state_d), metrics

    return _fit_loop(cfg, (state_g, state_d), train_fn,
                     lambda state, batch: eval_step(state[0], batch), loaders,
                     _val_loader(cfg, val_ds, dev), steps_per_epoch, profiler, on_step,
                     hooks=hooks)


def run_contrastive_fit(model: nn.Module, data_root: str, cfg: Optional[FitConfig] = None,
                        teacher: Optional[nn.Module] = None,
                        pretrained: Optional[Mapping[str, torch.Tensor]] = None,
                        profiler: Optional[PhaseProfiler] = None,
                        on_step: Optional[Callable[[int, U2PLState, Dict], None]] = None,
                        draws: Optional[Callable[[int], object]] = None,
                        device: DeviceLike = None,
                        hooks: Optional[FitHooks] = None) -> Dict:
    """Train ``model`` (a port architecture with its rep head,
    ``build_model(..., semisupervised=True)``) on the tree at ``data_root``
    as the JAX package's ``Runner.fit`` does for ``contrastive`` (U2PL) on
    one device: the "l" and "u" roles' single-frame loaders
    (``role_datasets``, ``train_loaders``), the student's SGD over the trunk
    and head groups (the rep head a head), the teacher (``teacher``, or a
    copy of the architecture with weights drawn from a generator seeded
    with ``seed + 1``; ``pretrained`` goes on the student only), the bank
    on the device; ``sup_step`` in the epochs before ``sup_only_epoch``,
    then ``sync_teacher`` once (aliased unless ``true_ema``) and
    ``semi_step`` with ``epoch_frac`` = epoch / max_epochs and the steps
    since the boundary from host counters; validation serves the teacher
    once synced and the student before. ``draws(global_step)`` gives a
    semi step's draws object (None: the step's own, train/contrastive.py).
    The summary is ``_fit_loop``'s, its "state" the ``U2PLState``, and
    "served" which model each validation pass served, (epoch, "teacher" or
    "student")."""
    cfg = cfg or default_fit_config()
    dev = resolve_device(device)
    _prepare(model, dev)
    arch = model_arch(model)
    roles = role_datasets(cfg, data_root, "contrastive", sem_transforms(cfg, arch)["train"])
    val_ds = val_dataset(cfg, data_root, "contrastive", arch)
    loaders, steps_per_epoch = train_loaders(cfg, roles, dev)
    state = method_state(model, cfg, "contrastive", steps_per_epoch, pretrained,
                         teacher=teacher, device=dev)
    sup_step, semi_step = make_u2pl_steps(
        cfg.classes, cfg.contrastive, cfg.ignore_index, cfg.aux_weight, cfg.ohem_thresh,
        cfg.ohem_min_kept, cfg.unsupervised_apply_aug, cfg.unsupervised_drop_percent,
        cfg.unsupervised_loss_weight, cfg.ema_decay, cfg.true_ema)
    host = {"epoch": 0, "i": 0, "step": 0}
    served: List[Tuple[int, str]] = []

    def on_epoch(epoch):
        host["epoch"], host["i"], host["step"] = epoch, 0, epoch * steps_per_epoch

    def train_fn(state, batch, rng):
        e, i, step = host["epoch"], host["i"], host["step"]
        host["i"], host["step"] = i + 1, step + 1
        if e < cfg.sup_only_epoch:
            return sup_step(state, batch, rng)
        if not state.teacher_synced:
            sync_teacher(state, alias=not cfg.true_ema)
        rel = max((e - cfg.sup_only_epoch) * steps_per_epoch + i, 0)
        return semi_step(state, batch, rng, e / cfg.max_epochs, rel,
                         None if draws is None else draws(step))

    def eval_fn(state, batch):
        m = served_model(state)
        if not served or served[-1][0] != host["epoch"]:
            served.append((host["epoch"], "teacher" if m is state.teacher else "student"))
        return eval_step_for(m, cfg, "contrastive")(state, batch)

    summary = _fit_loop(cfg, state, train_fn, eval_fn, loaders, _val_loader(cfg, val_ds, dev),
                        steps_per_epoch, profiler, on_step, on_epoch, hooks)
    summary["served"] = served
    return summary


_TIME_MAJOR_KEYS = ("mvs_left", "mvs_right")  # (T, B, ...)


def _single_samples(batch: Dict):
    """A collated batch split into one-sample batches (the sliding-window
    tests take one frame at a time; the test batch size sizes only the
    loader). Grids are time-major."""
    size = next(np.shape(v)[0] for k, v in batch.items() if k not in _TIME_MAJOR_KEYS)
    if size == 1:
        yield batch
        return
    for i in range(size):
        yield {k: (v[:, i:i + 1] if k in _TIME_MAJOR_KEYS else v[i:i + 1])
               for k, v in batch.items()}


def run_validate(model: nn.Module, data_root: str, cfg: Optional[FitConfig] = None,
                 method: str = "flow_supervised", device: DeviceLike = None) -> Dict:
    """One validation pass of ``model`` (its own weights) as the fit loop
    makes it for ``method`` (the CLI's ``validate``): ``val_dataset``
    behind the val loader, the method's eval step (``eval_step_for``), at
    most ``limit_val_batches`` batches (0 returns {}). Returns
    val_miou_epoch, val_macc_epoch and val_accuracy_epoch."""
    cfg = cfg or default_fit_config()
    if method not in METHODS:
        raise ValueError(f"unknown method {method!r}")
    if cfg.limit_val_batches == 0:
        return {}
    ds = val_dataset(cfg, data_root, method, model_arch(model))
    s = _validate(cfg, eval_step_for(model, cfg, method), None,
                  _val_loader(cfg, ds, resolve_device(device))).summary()
    return {"val_miou_epoch": s["miou"], "val_macc_epoch": s["macc"],
            "val_accuracy_epoch": s["allacc"]}


def run_test(model: nn.Module, data_root: str, cfg: Optional[FitConfig] = None,
             method: str = "flow_supervised", profiler: Optional[PhaseProfiler] = None,
             device: DeviceLike = None,
             on_sample: Optional[Callable[[Dict, np.ndarray], None]] = None) -> Dict:
    """Evaluate ``model`` (its own weights, in eval mode) on the tree at
    ``data_root`` as the JAX package's ``Runner.test`` does for ``method``
    on one device: "supervised", "gan" and "contrastive" take the
    single-frame route, "flow_supervised" and "flow_gan" the flow route.
    For "contrastive" ``model`` may be a ``U2PLState``: the test serves
    the model ``Runner._eval_variables`` picks, the teacher once synced,
    the student before.

    For each of test.txt and test2.txt under the list variant that exists:
    the test transform's dataset (``FlowDataset("test", type="l")`` or
    ``SemDataset("val")``) behind an unshuffled loader of
    ``batch_size_test`` items on ``workers_test`` threads, at most
    ``limit_test_batches`` batches (0 returns {}). Flow with
    ``no_cropping`` evaluates each batch whole through the eval step;
    otherwise each sample goes through ``flow_sliding_window_test`` (the
    test crop) or ``multi_scale_test`` (``test_scales``,
    ``test_base_size``), and its map's counts against the label feed a
    ``MetricMeter``. Returns test_miou{k}_epoch, test_macc{k}_epoch,
    test_accuracy{k}_epoch and test_miou{k}_epoch_classes for list k, and
    test_miou_epoch, their mean, when both ran. ``profiler`` records
    "test_step" (a whole-frame batch) or "test_sample" (a sliding-window
    sample, with the sliding window's own regions inside). ``on_sample(sample,
    pred)`` sees each sliding-window sample and its class map (the CLI's
    test-image table).
    """
    cfg = cfg or default_fit_config()
    if method not in METHODS:
        raise ValueError(f"run_test takes 'supervised', 'flow_supervised', 'gan', 'flow_gan' "
                         f"or 'contrastive', got {method!r}")
    if cfg.limit_test_batches == 0:
        return {}
    if isinstance(model, U2PLState):
        model = served_model(model)
    flow = method in FLOW_METHODS
    dev = resolve_device(device)
    arch = model_arch(model)
    crop_h, crop_w = _test_crop(cfg, arch)
    transform = (flow_transforms if flow else sem_transforms)(cfg, arch)["test"]
    if flow:
        crop_fn = make_flow_test_crop_fn(model, cfg.classes, cfg.feature_based, cfg.no_warp,
                                         device=dev)
        eval_whole = eval_step_for(model, cfg, method)
    else:
        crop_forward = make_crop_forward(model, cfg.classes, device=dev)
    variables = model.state_dict()
    profiler = profiler or PhaseProfiler()
    results = {}
    for k, name in enumerate(("test.txt", "test2.txt"), start=1):
        path = _list_path(data_root, cfg.data_variant, name)
        if not os.path.exists(path):
            continue
        if flow:
            ds = _flow_dataset(cfg, "test", data_root, path, "l", transform)
        else:
            ds = SemDataset("val", data_root, path, transform)
        loader = DataLoader(ds, batch_size=cfg.batch_size_test, num_workers=cfg.workers_test,
                            seed=cfg.seed)
        meter = MetricMeter(cfg.classes)
        for bi, batch in enumerate(loader):
            if cfg.limit_test_batches is not None and bi >= cfg.limit_test_batches:
                break
            if flow and cfg.no_cropping:
                with profiler.profile("test_step"):
                    m = eval_whole(None, device_put(batch, dev))
                    counts = [m[c].cpu().numpy() for c in ("intersection", "union", "target")]
                meter.update(*counts)
                continue
            for sub in _single_samples(batch):
                with profiler.profile("test_sample"):
                    if flow:
                        pred = flow_sliding_window_test(crop_fn, variables, sub, cfg.classes,
                                                        crop_h, crop_w, profiler=profiler)
                    else:
                        pred = multi_scale_test(crop_forward, variables,
                                                sub["frame_current"][0], cfg.classes, crop_h,
                                                crop_w, cfg.test_scales, cfg.test_base_size,
                                                profiler=profiler)
                meter.update(*intersection_and_union(
                    torch.from_numpy(pred), torch.from_numpy(sub["label"][0]), cfg.classes,
                    cfg.ignore_index))
                if on_sample is not None:
                    on_sample(sub, pred)
        s = meter.summary()
        results[f"test_miou{k}_epoch"] = s["miou"]
        results[f"test_macc{k}_epoch"] = s["macc"]
        results[f"test_accuracy{k}_epoch"] = s["allacc"]
        results[f"test_miou{k}_epoch_classes"] = s["iou_class"]
    if "test_miou2_epoch" in results:
        results["test_miou_epoch"] = (results["test_miou1_epoch"]
                                      + results["test_miou2_epoch"]) / 2
    return results
