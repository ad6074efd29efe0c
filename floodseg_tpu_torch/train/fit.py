"""Flow-supervised training from files on one device (counterpart of the
``flow_supervised`` wiring of the JAX package's ``Runner.fit``,
floodseg_tpu/cli/runner.py).

``run_flow_fit`` builds what ``Runner.fit`` builds for that method
without the config layer, the logger and the checkpoints: the flow
transforms with their sizing rules, the train FlowDataset behind an
infinite, shuffled, ``drop_last`` loader that copies each batch to the
device, the optimizer and poly schedule over the trunk and head groups,
the interpolated and plain train steps with the host-side
``no_interpolation_percentage`` coin, validation every
``check_val_every_n_epoch`` epochs through the eval step, and the early
stopping counter. Step metrics stay on the device and are read back once
an epoch. ``FitConfig`` holds the settings, with the defaults of the
repository's flow training config (configs/train_flow_supervised.yaml
over pspnet.yaml, train_base.yaml and dataset_flow.yaml).
"""

import os
from dataclasses import dataclass
from typing import Callable, Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch
import torch.nn as nn

from floodseg_tpu_torch.core.device import DeviceLike, resolve_device
from floodseg_tpu_torch.core.profiler import PhaseProfiler
from floodseg_tpu_torch.data.dataset import FlowDataset
from floodseg_tpu_torch.data.loader import DataLoader, device_put
from floodseg_tpu_torch.data.transforms import (
    Compose,
    build_train_transform,
    build_val_transform,
)
from floodseg_tpu_torch.ops.metrics import MetricMeter
from floodseg_tpu_torch.train.flow import make_flow_eval_step, make_flow_train_step
from floodseg_tpu_torch.train.optim import make_optimizer
from floodseg_tpu_torch.train.state import TrainState, create_train_state
from floodseg_tpu_torch.train.supervised import make_loss_fn


@dataclass
class FitConfig:
    """The flow_supervised settings ``run_flow_fit`` reads, named as in the
    JAX package's config (model.*, data.*, trainer.*)."""
    data_variant: Optional[str] = "all"
    classes: int = 5
    ignore_index: int = 255
    classes_ignore: Sequence[int] = (5,)
    train_h: int = 433
    train_w: int = 433
    resize_h: int = 1072
    resize_w: int = 1920
    resize_factor: float = 1.0
    scale_min: float = 0.5
    scale_max: float = 2.0
    no_cropping: bool = False
    frame_delta: int = 25
    no_random_frame_delta: bool = False
    feature_based: bool = True
    no_warp: bool = False
    no_interpolation_percentage: float = 0.0
    batch_size: int = 2
    batch_size_val: int = 1
    workers: int = 8
    optimizer: str = "sgd"
    lr: float = 1e-4
    momentum: float = 0.9
    weight_decay: float = 1e-4
    power: float = 0.9
    loss: str = "ohem"
    ohem_thresh: float = 0.7
    ohem_min_kept: int = 100000
    max_epochs: int = 100
    seed: int = 42
    check_val_every_n_epoch: int = 1
    early_stopping_patience: int = 10
    early_stopping_min_delta: float = 1e-3
    limit_train_batches: Optional[int] = None
    limit_val_batches: Optional[int] = None


def flow_transforms(cfg: FitConfig) -> Dict[str, Compose]:
    """The train and val transforms with the flow sizing rules of
    ``Runner._transforms``: with ``no_cropping`` the train frames are
    resized to 1.5x the crop and scaled down into it, and val is resized
    to the crop; otherwise both resize to the frame size times
    ``resize_factor`` and val is center-cropped. The train crop pads with
    nothing (a scaled frame smaller than the crop raises)."""
    th, tw = cfg.train_h, cfg.train_w
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
    return {
        "train": build_train_transform(th, tw, list(cfg.classes_ignore), scale_min, scale_max,
                                       resize, with_rotate=cfg.no_warp, crop_padding=None,
                                       ignore_index=cfg.ignore_index),
        "val": build_val_transform(th, tw, list(cfg.classes_ignore), resize_val,
                                   crop=not cfg.no_cropping, crop_padding=None,
                                   ignore_index=cfg.ignore_index),
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


def run_flow_fit(model: nn.Module, data_root: str, cfg: Optional[FitConfig] = None,
                 pretrained: Optional[Mapping[str, torch.Tensor]] = None,
                 profiler: Optional[PhaseProfiler] = None,
                 on_step: Optional[Callable[[int, TrainState, Dict], None]] = None,
                 device: DeviceLike = None) -> Dict:
    """Train ``model`` (the port's PSPNet) on the tree at ``data_root`` as
    the JAX package's ``Runner.fit`` does for ``flow_supervised`` on one
    device, and return a summary: per epoch the mean train loss, the train
    mIoU and, on validation epochs, the validation mIoU, mAcc, accuracy and
    counts; the best validation mIoU and its epoch; the steps taken; the
    final ``TrainState``.

    ``pretrained``: state_dict entries overlaid first (shape-checked).
    ``profiler`` records each step's wait for its batch (``train_load``)
    and the step (``train_step``; give the profiler a sync to time the
    device); ``on_step(global_step, state, metrics)`` runs after each step.
    """
    cfg = cfg or FitConfig()
    dev = resolve_device(device)
    _prepare(model, dev)
    tf = flow_transforms(cfg)
    put = (lambda b: device_put(b, dev))
    train_ds = FlowDataset("train", data_root, _list_path(data_root, cfg.data_variant,
                                                          "train.txt"),
                           type="l", transform=tf["train"], frame_delta=cfg.frame_delta,
                           no_warp=cfg.no_warp, no_random_frame_delta=cfg.no_random_frame_delta)
    if len(train_ds) < cfg.batch_size:
        raise ValueError(f"batch {cfg.batch_size} exceeds the train set ({len(train_ds)})")
    loader = DataLoader(train_ds, batch_size=cfg.batch_size, shuffle=True,
                        num_workers=cfg.workers, seed=cfg.seed, infinite=True,
                        drop_last=True, device_put=put)
    steps_per_epoch = max(1, len(train_ds) // cfg.batch_size)
    if cfg.limit_train_batches is not None:
        steps_per_epoch = min(steps_per_epoch, cfg.limit_train_batches)
    val_ds = FlowDataset("val", data_root, _list_path(data_root, cfg.data_variant, "val.txt"),
                         type="l", transform=tf["val"], frame_delta=cfg.frame_delta,
                         no_warp=cfg.no_warp, no_random_frame_delta=cfg.no_random_frame_delta)
    val_loader = DataLoader(val_ds, batch_size=cfg.batch_size_val, num_workers=cfg.workers,
                            seed=cfg.seed, device_put=put)

    max_iter = max(1, steps_per_epoch * cfg.max_epochs)
    opt, schedule = make_optimizer(model, cfg.lr, max_iter, cfg.optimizer.lower(),
                                   cfg.momentum, cfg.weight_decay, cfg.power)
    state = create_train_state(model, opt, schedule, pretrained)
    loss_fn = make_loss_fn(cfg.loss, 0.0, cfg.ignore_index, cfg.ohem_thresh,
                           cfg.ohem_min_kept)
    interp_step, plain_step = make_flow_train_step(model, loss_fn, cfg.classes,
                                                   cfg.ignore_index, cfg.feature_based,
                                                   cfg.no_warp)
    eval_step = make_flow_eval_step(model, cfg.classes, cfg.ignore_index,
                                    cfg.feature_based, cfg.no_warp)
    coin = np.random.default_rng(cfg.seed)
    profiler = profiler or PhaseProfiler()

    epochs: List[Dict] = []
    best_metric, best_epoch, wait_count = -np.inf, -1, 0
    val_every = max(1, cfg.check_val_every_n_epoch)
    global_step = 0
    it = iter(loader)
    try:
        for epoch in range(cfg.max_epochs):
            step_metrics = []
            for _ in range(steps_per_epoch):
                with profiler.profile("train_load"):
                    batch = next(it)
                plain = (cfg.no_interpolation_percentage > 0
                         and coin.random() < cfg.no_interpolation_percentage)
                with profiler.profile("train_step"):
                    state, metrics = (plain_step if plain else interp_step)(
                        state, batch, step_generator(cfg.seed, global_step))
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
                      "train_miou": meter.summary()["miou"]}
            do_val = (epoch + 1) % val_every == 0 and cfg.limit_val_batches != 0
            if do_val:
                val_meter = MetricMeter(cfg.classes)
                for bi, vb in enumerate(val_loader):
                    if cfg.limit_val_batches is not None and bi >= cfg.limit_val_batches:
                        break
                    m = eval_step(state, vb)
                    val_meter.update(*(m[k].cpu().numpy()
                                       for k in ("intersection", "union", "target")))
                vs = val_meter.summary()
                record.update(val_miou=vs["miou"], val_macc=vs["macc"],
                              val_accuracy=vs["allacc"],
                              val_counts={k: getattr(val_meter, k).copy()
                                          for k in ("intersection", "union", "target")})
            epochs.append(record)
            if do_val:
                if record["val_miou"] > best_metric + cfg.early_stopping_min_delta:
                    best_metric, best_epoch, wait_count = record["val_miou"], epoch, 0
                else:
                    wait_count += 1
                    if wait_count >= cfg.early_stopping_patience:
                        break
    finally:
        it.close()
    return {"epochs": epochs, "steps": global_step, "steps_per_epoch": steps_per_epoch,
            "best_val_miou": float(best_metric) if np.isfinite(best_metric) else None,
            "best_epoch": best_epoch, "state": state}
