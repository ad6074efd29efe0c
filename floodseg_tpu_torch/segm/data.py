"""Folder-layout datasets of the standalone Segmenter (counterpart of
floodseg_tpu/segm/data.py).

``SegFolderDataset`` reads (image, mask) pairs from an image directory and
an annotation directory with matching stems (``recursive`` for Cityscapes'
per-city subdirectories; ``reduce_zero_label`` for ADE20K's 0 = unlabeled,
which shifts the classes to 0..149 with 255 ignored). ``segm_dataset`` is
the named registry: ADE20K, Cityscapes and PascalContext with their
layouts, class counts, names, palettes and the mmseg pipelines of
``segm/pipeline.py``. ``build_train_pipeline`` is the simpler flood-style
pipeline of ad-hoc ``--img-dir``/``--ann-dir`` runs.
``ImageFolderClsDataset`` is the classification dataset of the accuracy
eval.

Items are the JAX package's: the same files, the same generator draws in
the same order, the same arrays. Images are read with ``data/image.py``'s
``read_rgb`` (PIL's ``convert("RGB")``), labels with ``imread`` (PIL's
``np.asarray(Image.open(p))``), and resized with ``ops/cv2_compat.py``.
"""

import os
from typing import Callable, List, Optional

import numpy as np

from floodseg_tpu_torch.data.image import imread, read_rgb
from floodseg_tpu_torch.data.transforms import (
    MEAN,
    STD,
    Compose,
    Crop,
    Normalize,
    RandomHorizontalFlip,
    RandScale,
    Resize,
)
from floodseg_tpu_torch.ops.cv2_compat import cv2_resize_cubic, cv2_resize_linear

IGNORE_LABEL = 255


def build_train_pipeline(im_size: int, crop_size: int, scale_range=(0.5, 2.0)) -> Compose:
    """Resize to im_size square, a random scale, a random crop padded with
    the mean and the ignore label, a flip, normalize."""
    return Compose([
        Resize((im_size, im_size)),
        RandScale(scale_range),
        Crop((crop_size, crop_size), crop_type="rand", padding=MEAN, ignore_label=IGNORE_LABEL),
        RandomHorizontalFlip(),
        Normalize(MEAN, STD),
    ])


class ResizeShortSide:
    """Resize frames so the short side is ``size`` (aspect kept), the label
    left at its annotation resolution (the mmseg eval protocol scores at
    ori_shape by resizing the probabilities back)."""

    def __init__(self, size: int):
        self.size = int(size)

    def __call__(self, sample, rng):
        im = sample["frame_current"]
        h, w = im.shape[:2]
        s = self.size / min(h, w)
        nh, nw = max(1, int(round(h * s))), max(1, int(round(w * s)))
        sample["frame_current"] = cv2_resize_linear(im, (nh, nw))
        return sample


def build_eval_pipeline(im_size: int) -> Compose:
    """Short-side resize (label kept) and normalize."""
    return Compose([ResizeShortSide(im_size), Normalize(MEAN, STD)])


# the [0, 1]-range normalization pairs of the classification pipeline
CLS_STATS = {
    "vit": {"mean": (0.5, 0.5, 0.5), "std": (0.5, 0.5, 0.5)},
    "deit": {"mean": (0.485, 0.456, 0.406), "std": (0.229, 0.224, 0.225)},
}


class ImageFolderClsDataset:
    """Classification dataset over the ImageFolder convention
    (root/<class_name>/*.jpg, classes sorted by name).

    val: bicubic short-side resize to image_size + 32, centre crop, [0, 1]
    normalize; train: RandomResizedCrop (scale 0.08-1, ratio 3/4-4/3, 10
    tries, then torchvision's clamped centre crop), bicubic resize to the
    crop and a flip. Items: {"im": (crop, crop, 3) float32, "target"}.
    """

    def __init__(self, root: str, image_size: int = 224, crop_size: int = 224,
                 split: str = "val", normalization: str = "vit"):
        self.root = root
        self.image_size = image_size
        self.crop_size = crop_size
        self.split = split
        stats = CLS_STATS[normalization]
        self.mean = np.asarray(stats["mean"], np.float32)
        self.std = np.asarray(stats["std"], np.float32)
        classes = sorted(d for d in os.listdir(root) if os.path.isdir(os.path.join(root, d)))
        if not classes:
            raise FileNotFoundError(f"no class directories under {root}")
        self.classes = classes
        self.items = []
        exts = (".jpg", ".jpeg", ".png", ".bmp")
        for ci, c in enumerate(classes):
            cdir = os.path.join(root, c)
            for f in sorted(os.listdir(cdir)):
                if f.lower().endswith(exts):
                    self.items.append((os.path.join(cdir, f), ci))
        self.n_cls = len(classes)

    def __len__(self):
        return len(self.items)

    def _random_resized_crop(self, im: np.ndarray, rng: np.random.Generator) -> np.ndarray:
        h, w = im.shape[:2]
        for _ in range(10):
            area = h * w * rng.uniform(0.08, 1.0)
            ratio = np.exp(rng.uniform(np.log(3 / 4), np.log(4 / 3)))
            cw = int(round(np.sqrt(area * ratio)))
            ch = int(round(np.sqrt(area / ratio)))
            if cw <= w and ch <= h:
                y0 = rng.integers(0, h - ch + 1)
                x0 = rng.integers(0, w - cw + 1)
                return im[y0:y0 + ch, x0:x0 + cw]
        in_ratio = w / h
        if in_ratio < 3 / 4:
            cw, ch = w, min(h, int(round(w / (3 / 4))))
        elif in_ratio > 4 / 3:
            cw, ch = min(w, int(round(h * (4 / 3)))), h
        else:
            cw, ch = w, h
        y0, x0 = (h - ch) // 2, (w - cw) // 2
        return im[y0:y0 + ch, x0:x0 + cw]

    def get(self, index: int, rng: np.random.Generator):
        path, target = self.items[index]
        im = read_rgb(path)
        h, w = im.shape[:2]
        cs = self.crop_size
        if self.split == "train":
            im = cv2_resize_cubic(self._random_resized_crop(im, rng), (cs, cs))
            if rng.random() < 0.5:
                im = im[:, ::-1]
        else:
            s = (self.image_size + 32) / min(h, w)
            nh, nw = int(round(h * s)), int(round(w * s))
            im = cv2_resize_cubic(im, (nh, nw))
            y0, x0 = max(0, (nh - cs) // 2), max(0, (nw - cs) // 2)
            im = im[y0:y0 + cs, x0:x0 + cs]
        im = (im.astype(np.float32) / 255.0 - self.mean) / self.std
        return {"im": np.ascontiguousarray(im), "target": np.int32(target)}


class SegFolderDataset:
    """(image, mask) pairs from parallel directories:
    img_dir/stem<img_suffix> with ann_dir/stem<ann_suffix>, sorted by stem
    (``recursive``: stems carry the relative subpath)."""

    def __init__(self, img_dir: str, ann_dir: str, img_suffix: str = ".jpg",
                 ann_suffix: str = ".png", transform: Optional[Callable] = None,
                 reduce_zero_label: bool = False, recursive: bool = False):
        self.img_dir = img_dir
        self.ann_dir = ann_dir
        self.img_suffix = img_suffix
        self.ann_suffix = ann_suffix
        self.transform = transform
        self.reduce_zero_label = reduce_zero_label
        if recursive:
            stems = sorted(
                os.path.relpath(os.path.join(d, f), img_dir)[:-len(img_suffix)]
                for d, _, fs in os.walk(img_dir) for f in fs if f.endswith(img_suffix))
        else:
            stems = sorted(f[:-len(img_suffix)] for f in os.listdir(img_dir)
                           if f.endswith(img_suffix))
        self.items: List[str] = [s for s in stems
                                 if os.path.exists(os.path.join(ann_dir, s + ann_suffix))]
        if not self.items:
            raise FileNotFoundError(f"no (image, annotation) pairs under {img_dir} / {ann_dir}")

    def __len__(self):
        return len(self.items)

    def get(self, index: int, rng: np.random.Generator):
        stem = self.items[index]
        image = read_rgb(os.path.join(self.img_dir, stem + self.img_suffix)).astype(np.float32)
        label = imread(os.path.join(self.ann_dir, stem + self.ann_suffix)).astype(np.int32)
        if self.reduce_zero_label:
            label = np.where(label == 0, IGNORE_LABEL + 1, label) - 1
        sample = {"frame_current": image, "label": label}
        if self.transform is not None:
            sample = self.transform(sample, rng)
        sample["label"] = np.asarray(sample["label"], dtype=np.int32)
        return sample


class SegListDataset(SegFolderDataset):
    """(image, mask) pairs named by a split file of stems (the VOC layout
    of PascalContext); loading is SegFolderDataset's."""

    def __init__(self, img_dir: str, ann_dir: str, split_file: str, img_suffix: str = ".jpg",
                 ann_suffix: str = ".png", transform: Optional[Callable] = None,
                 reduce_zero_label: bool = False):
        self.img_dir = img_dir
        self.ann_dir = ann_dir
        self.img_suffix = img_suffix
        self.ann_suffix = ann_suffix
        self.transform = transform
        self.reduce_zero_label = reduce_zero_label
        with open(split_file) as f:
            stems = [ln.strip() for ln in f if ln.strip()]
        self.items = [s for s in stems if os.path.exists(os.path.join(ann_dir, s + ann_suffix))]
        if not self.items:
            raise FileNotFoundError(f"no annotated stems from {split_file} under {ann_dir}")


def segm_presets():
    """Per dataset: the class count, the config's ``max_ratio`` (ADE20K 4,
    Cityscapes 2, PascalContext 8), the zero-label reduction, the names and
    the palette."""
    from floodseg_tpu_torch.segm import catalog

    return {
        "ade20k": dict(n_cls=150, max_ratio=4, reduce_zero_label=True,
                       names=catalog.ADE20K_NAMES, palette=catalog.ADE20K_PALETTE),
        "cityscapes": dict(n_cls=19, max_ratio=2, reduce_zero_label=False,
                           names=catalog.CITYSCAPES_NAMES, palette=catalog.CITYSCAPES_PALETTE),
        "pascal_context": dict(n_cls=60, max_ratio=8, reduce_zero_label=False,
                               names=catalog.PASCAL_CONTEXT_NAMES,
                               palette=catalog.PASCAL_CONTEXT_PALETTE),
    }


def segm_dataset(name: str, root: str, split: str = "train", image_size: int = 512,
                 crop_size: int = 512, normalization: str = "vit"):
    """A named dataset with the mmseg train or eval pipeline and its
    n_cls / names / palette / max_ratio. Layouts:

      ade20k:         root/images/{training,validation} +
                      root/annotations/{...}; labels 1..150, 0 unlabeled
      cityscapes:     root/leftImg8bit/<split>/<city>/*_leftImg8bit.png +
                      root/gtFine/<split>/<city>/*_gtFine_labelTrainIds.png
      pascal_context: root/VOCdevkit/VOC2010 with its split lists
    """
    from floodseg_tpu_torch.segm.pipeline import (
        build_mmseg_eval_pipeline,
        build_mmseg_train_pipeline,
    )

    presets = segm_presets()
    if name not in presets:
        raise ValueError(f"unknown dataset {name!r}; have {sorted(presets)}")
    meta = presets[name]
    if split == "train":
        tf = build_mmseg_train_pipeline(image_size, crop_size, max_ratio=meta["max_ratio"],
                                        normalization=normalization)
    else:
        tf = build_mmseg_eval_pipeline(image_size, max_ratio=meta["max_ratio"],
                                       normalization=normalization)
    if name == "ade20k":
        sub = {"train": "training", "val": "validation"}.get(split, split)
        ds = SegFolderDataset(os.path.join(root, "images", sub),
                              os.path.join(root, "annotations", sub),
                              img_suffix=".jpg", ann_suffix=".png", transform=tf,
                              reduce_zero_label=True)
    elif name == "cityscapes":
        ds = SegFolderDataset(os.path.join(root, "leftImg8bit", split),
                              os.path.join(root, "gtFine", split),
                              img_suffix="_leftImg8bit.png",
                              ann_suffix="_gtFine_labelTrainIds.png", transform=tf,
                              recursive=True)
    else:
        ds = pascal_context_dataset(root, split=split, transform=tf)
    ds.n_cls = meta["n_cls"]
    ds.ignore_label = IGNORE_LABEL
    ds.names = meta["names"]
    ds.palette = meta["palette"]
    ds.max_ratio = meta["max_ratio"]
    return ds


def pascal_context_dataset(root: str, split: str = "train",
                           transform: Optional[Callable] = None):
    """PascalContext (60 classes, ignore 255) over root/VOCdevkit/VOC2010:
    JPEGImages, SegmentationClassContext and
    ImageSets/SegmentationContext/{train,val}.txt. The test split raises,
    as the reference's does."""
    if split == "test":
        raise ValueError("Test split is not valid for Pascal Context dataset")
    voc = os.path.join(root, "VOCdevkit", "VOC2010")
    ds = SegListDataset(os.path.join(voc, "JPEGImages"),
                        os.path.join(voc, "SegmentationClassContext"),
                        os.path.join(voc, "ImageSets", "SegmentationContext", f"{split}.txt"),
                        transform=transform)
    ds.n_cls = 60
    ds.ignore_label = IGNORE_LABEL
    return ds
