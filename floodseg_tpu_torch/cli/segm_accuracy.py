"""ImageNet-style classification accuracy of a ViT backbone (counterpart of
scripts/segm_accuracy.py).

    python -m floodseg_tpu_torch.cli.segm_accuracy --data-dir IMAGENET/val \\
        --n-cls 1000 [--ckpt CKPT] [--image-size 224 --patch-size 16]

The ImageFolder val split (``segm/data.py::ImageFolderClsDataset``: bicubic
short side, centre crop) goes through ``ViTClassifier`` in batches; top-1
and top-k (k = min(5, n_cls)) accuracy over all images. ``--ckpt`` is a
checkpoint of the port or a file of the classifier's state_dict (default:
random weights from seed 0). Runs on the card unless ``--device cpu``.
"""

import argparse


def build_parser():
    p = argparse.ArgumentParser(prog="floodseg_tpu_torch.cli.segm_accuracy")
    p.add_argument("--data-dir", required=True,
                   help="ImageFolder split dir (class-per-subdirectory)")
    p.add_argument("--ckpt", default=None,
                   help="checkpoint or state_dict file (default: random init)")
    p.add_argument("--n-cls", type=int, default=1000)
    p.add_argument("--image-size", type=int, default=224)
    p.add_argument("--crop-size", type=int, default=None)
    p.add_argument("--patch-size", type=int, default=16)
    p.add_argument("--d-model", type=int, default=768)
    p.add_argument("--n-layers", type=int, default=12)
    p.add_argument("--normalization", default="vit", choices=["vit", "deit"])
    p.add_argument("-bs", "--batch-size", type=int, default=32)
    p.add_argument("-nw", "--num-workers", type=int, default=4)
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    import torch

    from floodseg_tpu_torch.core.checkpoint import read_model_state
    from floodseg_tpu_torch.core.device import full_precision_f32, resolve_device
    from floodseg_tpu_torch.data.loader import DataLoader, device_put
    from floodseg_tpu_torch.models.layers import init_flax_defaults_
    from floodseg_tpu_torch.models.vit import ViTClassifier
    from floodseg_tpu_torch.ops.metrics import AverageMeter, topk_accuracy
    from floodseg_tpu_torch.segm.data import ImageFolderClsDataset
    from floodseg_tpu_torch.segm.logger import MetricLogger

    dev = resolve_device(args.device)
    crop = args.crop_size or args.image_size
    ds = ImageFolderClsDataset(args.data_dir, image_size=args.image_size, crop_size=crop,
                               split="val", normalization=args.normalization)
    loader = DataLoader(ds, batch_size=args.batch_size, num_workers=args.num_workers,
                        device_put=lambda b: device_put(b, dev))
    model = ViTClassifier(n_cls=args.n_cls, image_size=crop, patch_size=args.patch_size,
                          d_model=args.d_model, n_layers=args.n_layers)
    if args.ckpt:
        model.load_state_dict(read_model_state(args.ckpt), strict=True)
    else:  # the JAX script's model.init at PRNGKey(0)
        init_flax_defaults_(model, torch.Generator().manual_seed(0))
    model = model.to(dev).eval()

    k2 = min(5, args.n_cls)  # top-5 needs >= 5 classes
    acc1_m, acc5_m = AverageMeter(), AverageMeter()
    logger = MetricLogger()
    for batch in logger.log_every(loader, 20, "acc"):
        with torch.no_grad(), full_precision_f32():
            logits = model(batch["im"])
        target = torch.as_tensor(batch["target"], dtype=torch.int64, device=logits.device)
        acc1, acc5 = topk_accuracy(logits, target, topk=(1, k2))
        n = batch["im"].shape[0]
        acc1_m.update(float(acc1), n)
        acc5_m.update(float(acc5), n)
        logger.update(acc1=float(acc1), acc5=float(acc5))
    print(f"accuracy: top1 {acc1_m.avg:.2f} top{k2} {acc5_m.avg:.2f} "
          f"({acc1_m.count} images)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
