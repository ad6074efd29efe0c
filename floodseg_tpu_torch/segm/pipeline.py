"""The mmseg train and eval pipelines of the Segmenter stack (counterpart of
floodseg_tpu/segm/pipeline.py).

The mmseg-0.x semantics the reference's dataset configs select, in the
port's Sample-dict / explicit ``np.random.Generator`` transform style, with
the same draws in the same order as the JAX package's ops, so one generator
gives both packages the same images and labels:

Train:
    Resize(img_scale=(max_ratio*S, S), ratio_range=(0.5, 2.0), keep_ratio)
    RandomCrop(crop_size, cat_max_ratio=0.75)
    RandomFlip(0.5)
    PhotoMetricDistortion()
    Normalize(mean*255, std*255)
    Pad(size=crop_size, pad_val=0, seg_pad_val=255)

Eval: a keep-ratio Resize to img_scale=(max_ratio*S, S) and Normalize; the
label stays at annotation resolution and scoring resizes the probability
map back.

cv2 is not used: the resizes are ``ops/cv2_compat.py``'s INTER_LINEAR
(float32 frames) and INTER_NEAREST (labels), the colour conversions its
uint8 HSV pair, all equal to cv2's to the bit.
"""

from typing import Tuple

import numpy as np

from floodseg_tpu_torch.data.transforms import Compose, Normalize, RandomHorizontalFlip
from floodseg_tpu_torch.ops.cv2_compat import (
    cv2_hsv2rgb_u8,
    cv2_resize_linear,
    cv2_resize_nearest,
    cv2_rgb2hsv_u8,
)

IGNORE_LABEL = 255

# the [0, 1]-range normalization pairs; mmseg's Normalize takes them x255
SEG_STATS = {
    "vit": {"mean": (0.5, 0.5, 0.5), "std": (0.5, 0.5, 0.5)},
    "deit": {"mean": (0.485, 0.456, 0.406), "std": (0.229, 0.224, 0.225)},
}


def _rescale_size(h: int, w: int, scale: Tuple[int, int]) -> Tuple[int, int]:
    """mmcv.imrescale sizing: the factor fits the long edge under
    max(scale) and the short edge under min(scale); each dimension rounds
    as int(dim * factor + 0.5)."""
    max_long, max_short = max(scale), min(scale)
    f = min(max_long / max(h, w), max_short / min(h, w))
    return int(h * f + 0.5), int(w * f + 0.5)


class RatioRangeResize:
    """mmseg Resize(img_scale, ratio_range, keep_ratio=True): one uniform
    ratio draw scales img_scale, then the image rescales keeping its aspect
    (bilinear; the label nearest). With ratio_range=None this is the eval
    keep-ratio resize, which leaves the label alone."""

    def __init__(self, img_scale: Tuple[int, int], ratio_range=None):
        self.img_scale = (int(img_scale[0]), int(img_scale[1]))
        self.ratio_range = ratio_range

    def __call__(self, sample, rng):
        im = sample["frame_current"]
        h, w = im.shape[:2]
        scale = self.img_scale
        if self.ratio_range is not None:
            r = float(rng.uniform(*self.ratio_range))
            scale = (int(self.img_scale[0] * r), int(self.img_scale[1] * r))
        nh, nw = _rescale_size(h, w, scale)
        sample["frame_current"] = cv2_resize_linear(im, (nh, nw))
        if self.ratio_range is not None and sample.get("label") is not None:
            sample["label"] = cv2_resize_nearest(np.asarray(sample["label"], np.int32),
                                                 (nh, nw))
        return sample


class RandomCropCatMax:
    """mmseg RandomCrop(crop_size, cat_max_ratio): uniform crop offsets,
    redrawn up to 10 times until no single non-ignore class fills
    cat_max_ratio of the crop or more; the loop stops early only on a crop
    with more than one class."""

    def __init__(self, crop_size: Tuple[int, int], cat_max_ratio: float = 1.0,
                 ignore_label: int = IGNORE_LABEL):
        self.crop_size = crop_size
        self.cat_max_ratio = cat_max_ratio
        self.ignore_label = ignore_label

    def _bbox(self, h, w, rng):
        mh = max(h - self.crop_size[0], 0)
        mw = max(w - self.crop_size[1], 0)
        y0 = int(rng.integers(0, mh + 1))
        x0 = int(rng.integers(0, mw + 1))
        return y0, x0, y0 + self.crop_size[0], x0 + self.crop_size[1]

    def __call__(self, sample, rng):
        im = sample["frame_current"]
        label = sample.get("label")
        h, w = im.shape[:2]
        y0, x0, y1, x1 = self._bbox(h, w, rng)
        if label is not None and self.cat_max_ratio < 1.0:
            for _ in range(10):
                cls, cnt = np.unique(label[y0:y1, x0:x1], return_counts=True)
                cnt = cnt[cls != self.ignore_label]
                if len(cnt) > 1 and cnt.max() / cnt.sum() < self.cat_max_ratio:
                    break
                y0, x0, y1, x1 = self._bbox(h, w, rng)
        sample["frame_current"] = im[y0:y1, x0:x1]
        if label is not None:
            sample["label"] = label[y0:y1, x0:x1]
        return sample


class PhotoMetricDistortion:
    """mmseg PhotoMetricDistortion: each sub-op applies on a coin flip
    (``rng.integers(2)``, in mmseg's draw order), contrast runs first or
    last on another flip, and every op clips to [0, 255] and truncates to
    uint8 before the next. Saturation and hue go through cv2's uint8 HSV
    (H in 0..179, wrapping)."""

    def __init__(self, brightness_delta: int = 32, contrast_range=(0.5, 1.5),
                 saturation_range=(0.5, 1.5), hue_delta: int = 18):
        self.brightness_delta = brightness_delta
        self.contrast_range = contrast_range
        self.saturation_range = saturation_range
        self.hue_delta = hue_delta

    @staticmethod
    def _convert(img, alpha=1.0, beta=0.0):
        return np.clip(img.astype(np.float32) * alpha + beta, 0, 255).astype(np.uint8)

    def __call__(self, sample, rng):
        img = np.clip(np.asarray(sample["frame_current"]), 0, 255).astype(np.uint8)
        if rng.integers(2):
            img = self._convert(img, beta=float(rng.uniform(-self.brightness_delta,
                                                            self.brightness_delta)))
        mode = int(rng.integers(2))
        if mode == 1 and rng.integers(2):
            img = self._convert(img, alpha=float(rng.uniform(*self.contrast_range)))
        if rng.integers(2):
            hsv = cv2_rgb2hsv_u8(img)
            hsv[..., 1] = self._convert(hsv[..., 1],
                                        alpha=float(rng.uniform(*self.saturation_range)))
            img = cv2_hsv2rgb_u8(hsv)
        if rng.integers(2):
            hsv = cv2_rgb2hsv_u8(img)
            hsv[..., 0] = (hsv[..., 0].astype(int)
                           + int(rng.integers(-self.hue_delta, self.hue_delta))) % 180
            img = cv2_hsv2rgb_u8(hsv)
        if mode == 0 and rng.integers(2):
            img = self._convert(img, alpha=float(rng.uniform(*self.contrast_range)))
        sample["frame_current"] = img.astype(np.float32)
        return sample


class PadToSize:
    """mmseg Pad(size, pad_val=0, seg_pad_val=255): bottom/right padding of
    image and label up to ``size`` (nothing on larger inputs)."""

    def __init__(self, size: Tuple[int, int], pad_val: float = 0.0,
                 seg_pad_val: int = IGNORE_LABEL):
        self.size = size
        self.pad_val = pad_val
        self.seg_pad_val = seg_pad_val

    def __call__(self, sample, rng):
        im = sample["frame_current"]
        ph = max(0, self.size[0] - im.shape[0])
        pw = max(0, self.size[1] - im.shape[1])
        if ph or pw:
            sample["frame_current"] = np.pad(im, ((0, ph), (0, pw), (0, 0)),
                                             constant_values=self.pad_val)
            if sample.get("label") is not None:
                sample["label"] = np.pad(np.asarray(sample["label"]), ((0, ph), (0, pw)),
                                         constant_values=self.seg_pad_val)
        return sample


def _stats255(normalization: str):
    """The normalization pair x255, each value rounded to 2 decimals
    (``np.round``) as the reference rounds it: deit's mean is [123.68,
    116.28, 103.53], not ImageNet's [123.675, 116.28, 103.53]."""
    s = SEG_STATS[normalization]
    mean = [float(np.round(255.0 * v, 2)) for v in s["mean"]]
    std = [float(np.round(255.0 * v, 2)) for v in s["std"]]
    return mean, std


def build_mmseg_train_pipeline(image_size: int, crop_size: int, max_ratio: int = 4,
                               normalization: str = "vit") -> Compose:
    """The full train pipeline (see the module note)."""
    mean, std = _stats255(normalization)
    return Compose([
        RatioRangeResize((max_ratio * image_size, image_size), ratio_range=(0.5, 2.0)),
        RandomCropCatMax((crop_size, crop_size), cat_max_ratio=0.75),
        RandomHorizontalFlip(0.5),
        PhotoMetricDistortion(),
        Normalize(mean, std),
        PadToSize((crop_size, crop_size), pad_val=0, seg_pad_val=IGNORE_LABEL),
    ])


class _EvalResize(RatioRangeResize):
    """The eval keep-ratio resize with the label kept at its original
    resolution."""

    def __call__(self, sample, rng):
        label = sample.pop("label", None)
        sample = super().__call__(sample, rng)
        if label is not None:
            sample["label"] = label
        return sample


def build_mmseg_eval_pipeline(image_size: int, max_ratio: int = 4,
                              normalization: str = "vit") -> Compose:
    """Keep-ratio resize to img_scale=(max_ratio*S, S) and normalize; the
    label stays at annotation resolution for scoring at ori_shape."""
    mean, std = _stats255(normalization)
    return Compose([_EvalResize((max_ratio * image_size, image_size)), Normalize(mean, std)])
