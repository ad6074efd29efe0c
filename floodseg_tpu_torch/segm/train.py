"""Standalone Segmenter trainer (counterpart of floodseg_tpu/segm/train.py).

``python -m floodseg_tpu_torch.segm.train --log-dir LOG --dataset ade20k
--data-root ROOT [...]`` (or ``--img-dir``/``--ann-dir`` folders, or
``--pascal-context ROOT``), with the JAX trainer's flags and defaults.

The port's parts: an infinite shuffled ``DataLoader`` of the global batch
(``drop_last``); ``SegmenterViT`` with float32 parameters, computing in
bf16 under ``--amp``; SGD with the poly schedule over one parameter group;
cross entropy with ignore 255 and the supervised step; the window-sliding
mmseg evaluation after every ``--eval-freq`` epochs;
``CheckpointManager`` keeping the top 3 by ``val_miou`` and the last
epoch, resumed from ``last`` unless ``--no-resume`` (an epoch without an
eval saves only ``last``); and the JSONL ``log.txt`` (``epoch``,
``train_loss``, ``val_mean_iou``, ``val_mean_acc``), which
scripts/segm_plot_logs.py reads.

``--num-devices`` counts the ranks of the process group (parallel/dist.py
sets it up from FLOODSEG_MULTIHOST and its variables): the global batch is
``--batch-size`` times the ranks, each rank loads and runs its share, and
the evaluation splits the images over the ranks. It runs on the card;
``main(argv, device="cpu")`` runs the plain path on the CPU.
"""

import argparse
import json
import os
import time

import torch


def build_parser():
    p = argparse.ArgumentParser(prog="floodseg_tpu_torch.segm.train")
    p.add_argument("--log-dir", required=True)
    p.add_argument("--img-dir", default=None, help="training images")
    p.add_argument("--ann-dir", default=None, help="training annotations")
    p.add_argument("--val-img-dir", default=None)
    p.add_argument("--val-ann-dir", default=None)
    p.add_argument("--pascal-context", default=None, metavar="ROOT",
                   help="train on PascalContext from ROOT/VOCdevkit/VOC2010 "
                        "(train+val splits, 60 classes) instead of "
                        "--img-dir/--ann-dir folders — the reference's "
                        "dataset-by-name selection (segm/data/factory.py)")
    p.add_argument("--dataset", default=None,
                   choices=["ade20k", "cityscapes", "pascal_context"],
                   help="named dataset with the faithful mmseg pipeline "
                        "(ratio-range keep-ratio resize, cat_max_ratio "
                        "crop, PhotoMetricDistortion, pad-with-ignore) and "
                        "its standard n_cls/palette/max_ratio — the full "
                        "reference registry (segm/data/factory.py); "
                        "requires --data-root")
    p.add_argument("--data-root", default=None,
                   help="dataset root for --dataset (ade20k: the "
                        "ADEChallengeData2016 dir; cityscapes: the dir "
                        "holding leftImg8bit/gtFine; pascal_context: the "
                        "dir holding VOCdevkit)")
    p.add_argument("--normalization", default="vit",
                   choices=["vit", "deit"],
                   help="normalization stats pair (segm/data/utils.py "
                        "STATS), used by --dataset pipelines")
    p.add_argument("--img-suffix", default=".jpg")
    p.add_argument("--ann-suffix", default=".png")
    p.add_argument("--reduce-zero-label", action="store_true",
                   help="ADE20k label convention (0=unlabeled)")
    p.add_argument("--n-cls", type=int, default=None,
                   help="required unless --pascal-context (then 60)")
    p.add_argument("--im-size", type=int, default=512)
    p.add_argument("--crop-size", type=int, default=None)
    p.add_argument("--window-size", type=int, default=None)
    p.add_argument("--window-stride", type=int, default=None)
    p.add_argument("--patch-size", type=int, default=32)
    p.add_argument("--d-model", type=int, default=768)
    p.add_argument("--n-layers", type=int, default=12)
    p.add_argument("--dec-layers", type=int, default=2)
    p.add_argument("--decoder", default="mask_transformer",
                   choices=["mask_transformer", "linear"],
                   help="MaskTransformer or the linear patch classifier "
                        "(reference segm/model/decoder.py:13-34)")
    p.add_argument("--dropout", type=float, default=0.0)
    p.add_argument("--batch-size", type=int, default=8,
                   help="per-device; the global batch is batch * n_devices")
    p.add_argument("--epochs", type=int, default=64)
    p.add_argument("-lr", "--learning-rate", type=float, default=0.001)
    p.add_argument("--weight-decay", type=float, default=0.0)
    p.add_argument("--eval-freq", type=int, default=1)
    p.add_argument("--amp", action="store_true",
                   help="bfloat16 compute with float32 parameters")
    p.add_argument("--no-resume", action="store_true")
    p.add_argument("--num-devices", type=int, default=None)
    p.add_argument("--workers", type=int, default=4)
    p.add_argument("--seed", type=int, default=42)
    return p


def init_model(model: torch.nn.Module, seed: int) -> torch.nn.Module:
    """The model's initial weights, drawn from ``seed``."""
    from floodseg_tpu_torch.models.layers import init_from_generator_

    return init_from_generator_(model, torch.Generator().manual_seed(seed))


def _train_dataset(args, crop):
    from floodseg_tpu_torch.segm.data import (
        SegFolderDataset,
        build_train_pipeline,
        pascal_context_dataset,
        segm_dataset,
    )

    if args.dataset:
        if not args.data_root:
            raise SystemExit("--dataset requires --data-root")
        ds = segm_dataset(args.dataset, args.data_root, "train", image_size=args.im_size,
                          crop_size=crop, normalization=args.normalization)
        if args.n_cls is None:
            args.n_cls = ds.n_cls
        return ds
    if args.pascal_context:
        if args.n_cls is None:
            args.n_cls = 60
        return pascal_context_dataset(args.pascal_context, "train",
                                      transform=build_train_pipeline(args.im_size, crop))
    if args.img_dir and args.ann_dir:
        if args.n_cls is None:
            raise SystemExit("--n-cls is required with --img-dir/--ann-dir")
        return SegFolderDataset(args.img_dir, args.ann_dir, args.img_suffix, args.ann_suffix,
                                transform=build_train_pipeline(args.im_size, crop),
                                reduce_zero_label=args.reduce_zero_label)
    raise SystemExit("pass --dataset+--data-root, --img-dir/--ann-dir, or --pascal-context")


def _val_dataset(args, crop):
    from floodseg_tpu_torch.segm.data import (
        SegFolderDataset,
        build_eval_pipeline,
        pascal_context_dataset,
        segm_dataset,
    )

    if args.dataset:
        return segm_dataset(args.dataset, args.data_root, "val", image_size=args.im_size,
                            crop_size=crop, normalization=args.normalization)
    if args.pascal_context:
        return pascal_context_dataset(args.pascal_context, "val",
                                      transform=build_eval_pipeline(args.im_size))
    if args.val_img_dir and args.val_ann_dir:
        return SegFolderDataset(args.val_img_dir, args.val_ann_dir, args.img_suffix,
                                args.ann_suffix, transform=build_eval_pipeline(args.im_size),
                                reduce_zero_label=args.reduce_zero_label)
    return None


def append_log(log_dir: str, epoch: int, train_loss: float, summ=None) -> None:
    """The epoch's line of ``log_dir/log.txt``: its train loss and, after an
    evaluation, ``summ``'s mean IoU and accuracy."""
    entry = {"epoch": epoch, "train_loss": train_loss}
    if summ is not None:
        entry["val_mean_iou"] = summ["miou"]
        entry["val_mean_acc"] = summ["macc"]
    with open(os.path.join(log_dir, "log.txt"), "a") as f:
        f.write(json.dumps(entry) + "\n")


def main(argv=None, device=None) -> int:
    args = build_parser().parse_args(argv)
    crop = args.crop_size or args.im_size
    window = args.window_size or args.im_size
    stride = args.window_stride or max(1, window - 32)

    from floodseg_tpu_torch.core.checkpoint import CheckpointManager
    from floodseg_tpu_torch.core.device import resolve_device
    from floodseg_tpu_torch.data.loader import DataLoader, device_put
    from floodseg_tpu_torch.models.vit import SegmenterViT
    from floodseg_tpu_torch.parallel.dist import maybe_initialize_multihost
    from floodseg_tpu_torch.parallel.mesh import current_world, resolve_num_devices
    from floodseg_tpu_torch.segm.data import IGNORE_LABEL
    from floodseg_tpu_torch.segm.inference import evaluate_dataset
    from floodseg_tpu_torch.segm.logger import MetricLogger
    from floodseg_tpu_torch.train import supervised as sup
    from floodseg_tpu_torch.train.fit import step_generator
    from floodseg_tpu_torch.train.optim import make_optimizer
    from floodseg_tpu_torch.train.state import create_train_state

    dev = resolve_device(device)
    maybe_initialize_multihost(device=str(dev))
    world = current_world()
    n_dev = resolve_num_devices(args.num_devices, world)
    global_batch = args.batch_size * n_dev

    train_ds = _train_dataset(args, crop)
    if global_batch > len(train_ds):
        raise SystemExit(
            f"global batch {global_batch} ({args.batch_size} x {n_dev} "
            f"devices) exceeds the train set ({len(train_ds)})")
    loader = DataLoader(train_ds, batch_size=global_batch, shuffle=True,
                        num_workers=args.workers, seed=args.seed, infinite=True,
                        drop_last=True, device_put=lambda b: device_put(b, dev), world=world)
    steps_per_epoch = max(1, len(train_ds) // global_batch)

    model = SegmenterViT(
        classes=args.n_cls, image_size=crop, patch_size=args.patch_size,
        d_model=args.d_model, n_layers=args.n_layers, dec_layers=args.dec_layers,
        decoder_type=args.decoder, dropout=args.dropout,
        dtype=torch.bfloat16 if args.amp else torch.float32)
    model = init_model(model, args.seed).to(dev)
    max_iter = steps_per_epoch * args.epochs
    opt, schedule = make_optimizer(model, args.learning_rate, max_iter,
                                   weight_decay=args.weight_decay, head_lr_scale=1.0)
    state = create_train_state(model, opt, schedule)
    loss_fn = sup.make_loss_fn("ce", aux_weight=0.0, ignore_index=IGNORE_LABEL)
    step = sup.make_train_step(model, loss_fn, args.n_cls, IGNORE_LABEL, world)

    ckpt = CheckpointManager(os.path.join(args.log_dir, "checkpoints"), save_top_k=3,
                             world=world, monitor="val_miou")
    start_epoch = 0
    if not args.no_resume and ckpt.last_path is not None:
        state = ckpt.restore(state, ckpt.last_path)
        le = ckpt.last_epoch
        start_epoch = (le + 1) if le is not None else 0
        print(f"resumed from {ckpt.last_path} at epoch {start_epoch}", flush=True)

    val_ds = _val_dataset(args, crop)
    it = iter(loader)
    gstep = start_epoch * steps_per_epoch
    for epoch in range(start_epoch, args.epochs):
        logger = MetricLogger()
        t0 = time.time()
        for _ in logger.log_every(range(steps_per_epoch), 50, f"Epoch: [{epoch}]"):
            state, m = step(state, next(it), step_generator(args.seed, gstep))
            logger.update(loss=float(m["loss"]))
            gstep += 1
        print(f"Epoch {epoch}: {logger} ({time.time() - t0:.1f}s)", flush=True)

        metrics = {}
        if val_ds is not None and (epoch + 1) % args.eval_freq == 0:
            summ = evaluate_dataset(model, val_ds, args.n_cls, window, stride,
                                    ignore_index=IGNORE_LABEL, world=world)
            metrics["val_miou"] = summ["miou"]
            print(f"Eval [{epoch}]: mean_iou {summ['miou']:.4f} "
                  f"mean_acc {summ['macc']:.4f}", flush=True)
        ckpt.save(state, epoch, metrics)

        if world.is_main:
            append_log(args.log_dir, epoch, logger.meters["loss"].global_avg,
                       summ if "val_miou" in metrics else None)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
