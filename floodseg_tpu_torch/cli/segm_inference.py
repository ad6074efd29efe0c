"""Folder inference and evaluation with the standalone Segmenter
(counterpart of scripts/segm_inference.py).

    python -m floodseg_tpu_torch.cli.segm_inference --ckpt CKPT -i IN_DIR \\
        -o OUT_DIR --n-cls 150 [--window-size 512 --window-stride 480] \\
        [--blend 0.5] [--ann-dir ANN_DIR [--reduce-zero-label]]

Every image of the folder is resized (short side to ``--image-size``, PIL's
bicubic), segmented by ``sliding_inference`` at its original shape, and
written under its own name as the colour map blended over the input (PNG,
or a quality-75 JPEG for a .jpg name, as PIL saves them). Colours come from
``--colors`` (a colors.txt palette) or a palette drawn from seed 0. With
``--ann-dir`` the mmseg mean IoU / mean accuracy against the stem-matched
masks. ``--ckpt`` is a checkpoint of ``segm.train`` (or a state_dict file;
'-' for random weights). Runs on the card unless ``--device cpu``.
"""

import argparse
import os

import numpy as np


def palette(n: int, colors_path=None) -> np.ndarray:
    if colors_path:
        return np.loadtxt(colors_path).astype(np.uint8)[:n]
    rng = np.random.default_rng(0)
    return rng.integers(0, 255, (n, 3), dtype=np.uint8)


def build_parser():
    p = argparse.ArgumentParser(prog="floodseg_tpu_torch.cli.segm_inference")
    p.add_argument("--ckpt", required=True,
                   help="checkpoint or state_dict file ('-' for random init)")
    p.add_argument("-i", "--input-dir", required=True)
    p.add_argument("-o", "--output-dir", required=True)
    p.add_argument("--n-cls", type=int, required=True)
    p.add_argument("--image-size", type=int, default=512)
    p.add_argument("--window-size", type=int, default=None)
    p.add_argument("--window-stride", type=int, default=None)
    p.add_argument("--patch-size", type=int, default=32)
    p.add_argument("--d-model", type=int, default=768)
    p.add_argument("--n-layers", type=int, default=12)
    p.add_argument("--dec-layers", type=int, default=2)
    p.add_argument("--decoder", default="mask_transformer",
                   choices=["mask_transformer", "linear"])
    p.add_argument("--colors", default=None)
    p.add_argument("--blend", type=float, default=0.5)
    p.add_argument("--ann-dir", default=None,
                   help="ground-truth masks (stem-matched .png): report "
                        "mean_iou/mean_acc like segm/eval/miou.py")
    p.add_argument("--ann-suffix", default=".png")
    p.add_argument("--reduce-zero-label", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    import torch

    from floodseg_tpu_torch.core.checkpoint import read_model_state
    from floodseg_tpu_torch.core.device import resolve_device
    from floodseg_tpu_torch.data.image import imread, read_rgb, write_jpeg, write_png
    from floodseg_tpu_torch.data.transforms import MEAN, STD
    from floodseg_tpu_torch.models.layers import init_flax_defaults_
    from floodseg_tpu_torch.models.vit import SegmenterViT
    from floodseg_tpu_torch.ops.cv2_compat import pil_resize_bicubic
    from floodseg_tpu_torch.ops.metrics import MetricMeter, intersection_and_union
    from floodseg_tpu_torch.segm.inference import sliding_inference

    dev = resolve_device(args.device)
    window = args.window_size or args.image_size
    stride = args.window_stride or max(1, window - 32)
    model = SegmenterViT(classes=args.n_cls, image_size=window, patch_size=args.patch_size,
                         d_model=args.d_model, n_layers=args.n_layers,
                         dec_layers=args.dec_layers, decoder_type=args.decoder)
    if args.ckpt != "-":
        model.load_state_dict(read_model_state(args.ckpt), strict=True)
    else:  # the JAX script's model.init at PRNGKey(0)
        init_flax_defaults_(model, torch.Generator().manual_seed(0))
    model = model.to(dev).eval()
    colors = palette(args.n_cls, args.colors)
    os.makedirs(args.output_dir, exist_ok=True)
    mean, std = np.asarray(MEAN, np.float32), np.asarray(STD, np.float32)

    meter = MetricMeter(args.n_cls) if args.ann_dir else None
    n_matched = 0
    names = sorted(f for f in os.listdir(args.input_dir)
                   if f.lower().endswith((".jpg", ".jpeg", ".png")))
    for name in names:
        ori = read_rgb(os.path.join(args.input_dir, name))
        # short-side resize (aspect kept), the mmseg test protocol; the
        # probabilities are resized back to the original shape
        sc = args.image_size / min(ori.shape[:2])
        im = pil_resize_bicubic(ori, (max(1, round(ori.shape[1] * sc)),
                                      max(1, round(ori.shape[0] * sc))))
        x = (im.astype(np.float32) - mean) / std
        prob = sliding_inference(model, x, args.n_cls, window, stride,
                                 ori_shape=ori.shape[:2])
        pred_t = prob.argmax(-1)
        pred = pred_t.cpu().numpy()
        blend = (args.blend * colors[pred] + (1 - args.blend) * ori).astype(np.uint8)
        out = os.path.join(args.output_dir, name)
        if name.lower().endswith(".png"):
            write_png(out, blend)
        else:
            write_jpeg(out, blend, quality=75)
        if meter is not None:
            ann = os.path.join(args.ann_dir, os.path.splitext(name)[0] + args.ann_suffix)
            if os.path.exists(ann):
                lab = imread(ann).astype(np.int32)
                if args.reduce_zero_label:
                    lab = np.where(lab == 0, 256, lab) - 1
                counts = intersection_and_union(pred_t, torch.from_numpy(lab).to(dev),
                                                args.n_cls, 255)
                meter.update(*(c.cpu().numpy() for c in counts))
                n_matched += 1
        print(name, flush=True)
    print(f"wrote {len(names)} segmentations to {args.output_dir}")
    if meter is not None and meter.count > 0:
        s = meter.summary_mmseg()
        if n_matched < len(names):
            print(f"WARNING: only {n_matched}/{len(names)} images had a "
                  f"matching annotation under {args.ann_dir} (check --ann-suffix)")
        print(f"mean_iou {s['miou']:.4f} mean_acc {s['macc']:.4f} "
              f"overall_acc {s['allacc']:.4f} ({n_matched}/{len(names)} images)")
        print("iou_per_class", [None if np.isnan(v) else round(float(v), 4)
                                for v in s["iou_class"]])
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
