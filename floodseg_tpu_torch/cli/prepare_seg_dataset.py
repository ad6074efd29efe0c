"""Lay out a downloaded segmentation dataset for SegFolderDataset
(counterpart of scripts/prepare_seg_dataset.py).

    python -m floodseg_tpu_torch.cli.prepare_seg_dataset {ade20k,cityscapes} SRC DST

- ade20k: SRC = ADEChallengeData2016/, already images/<split> +
  annotations/<split> with matching stems; checked and linked through.
  Train with --reduce-zero-label (labels 1..150, 0 = unlabeled).
- cityscapes: SRC holds leftImg8bit/<split>/<city>/*_leftImg8bit.png and
  gtFine/<split>/<city>/*_gtFine_labelIds.png; the labelIds become the 19
  trainIds (every other id 255, ignored), written as L PNGs by the port's
  codec, and both sides are flattened into DST/images/<split> +
  DST/annotations/<split> with matching stems.
"""

import argparse
import os

import numpy as np

from floodseg_tpu_torch.data.image import imread, write_png

# Cityscapes labelId -> trainId (the public 19-class evaluation mapping;
# all other ids are ignore=255)
CITYSCAPES_ID_TO_TRAIN = {
    7: 0, 8: 1, 11: 2, 12: 3, 13: 4, 17: 5, 19: 6, 20: 7, 21: 8, 22: 9,
    23: 10, 24: 11, 25: 12, 26: 13, 27: 14, 28: 15, 31: 16, 32: 17, 33: 18,
}


def _link_or_copy(src: str, dst: str):
    if os.path.exists(dst):
        return
    try:
        os.symlink(os.path.abspath(src), dst)
    except OSError:
        import shutil
        shutil.copy2(src, dst)


def prepare_ade20k(src: str, dst: str):
    n = 0
    for split in ("training", "validation"):
        img_src = os.path.join(src, "images", split)
        ann_src = os.path.join(src, "annotations", split)
        if not os.path.isdir(img_src):
            raise SystemExit(f"missing {img_src} — SRC should be ADEChallengeData2016/")
        img_dst = os.path.join(dst, "images", split)
        ann_dst = os.path.join(dst, "annotations", split)
        os.makedirs(img_dst, exist_ok=True)
        os.makedirs(ann_dst, exist_ok=True)
        for f in sorted(os.listdir(img_src)):
            if not f.endswith(".jpg"):
                continue
            stem = f[:-4]
            ann = os.path.join(ann_src, stem + ".png")
            if not os.path.exists(ann):
                continue
            _link_or_copy(os.path.join(img_src, f), os.path.join(img_dst, f))
            _link_or_copy(ann, os.path.join(ann_dst, stem + ".png"))
            n += 1
    print(f"ade20k: {n} pairs; train SegFolderDataset with "
          f"reduce_zero_label=True (--n-cls 150)")


def prepare_cityscapes(src: str, dst: str):
    lut = np.full(256, 255, np.uint8)
    for k, v in CITYSCAPES_ID_TO_TRAIN.items():
        lut[k] = v
    n = 0
    for split in ("train", "val"):
        img_root = os.path.join(src, "leftImg8bit", split)
        ann_root = os.path.join(src, "gtFine", split)
        if not os.path.isdir(img_root):
            raise SystemExit(f"missing {img_root}")
        img_dst = os.path.join(dst, "images", split)
        ann_dst = os.path.join(dst, "annotations", split)
        os.makedirs(img_dst, exist_ok=True)
        os.makedirs(ann_dst, exist_ok=True)
        for city in sorted(os.listdir(img_root)):
            cdir = os.path.join(img_root, city)
            for f in sorted(os.listdir(cdir)):
                if not f.endswith("_leftImg8bit.png"):
                    continue
                stem = f[: -len("_leftImg8bit.png")]
                ann = os.path.join(ann_root, city, stem + "_gtFine_labelIds.png")
                if not os.path.exists(ann):
                    continue
                _link_or_copy(os.path.join(cdir, f), os.path.join(img_dst, stem + ".png"))
                write_png(os.path.join(ann_dst, stem + ".png"), lut[imread(ann)])
                n += 1
    print(f"cityscapes: {n} pairs converted to 19 trainIds "
          f"(--n-cls 19, img suffix .png)")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="floodseg_tpu_torch.cli.prepare_seg_dataset")
    p.add_argument("dataset", choices=["ade20k", "cityscapes"])
    p.add_argument("src")
    p.add_argument("dst")
    args = p.parse_args(argv)
    {"ade20k": prepare_ade20k, "cityscapes": prepare_cityscapes}[args.dataset](args.src,
                                                                             args.dst)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
