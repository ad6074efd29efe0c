"""The predict path's host transforms and the frame resize.

Counterpart of the predict path's part of floodseg_tpu/data/transforms.py:
transforms take and return a sample dict carrying any of frame_current,
frame_prev, frame_next, mvs_left, mvs_right and label, in numpy on the
host, with an ``np.random.Generator`` (unused by these). The train
transforms come with training.

The JAX package resizes with cv2; the machine with the card has neither
cv2 nor PIL, so ``resize_frames`` is the port's own half-pixel bilinear
(ops/resize.py with align_corners=False, cv2.INTER_LINEAR's convention),
within 1 grey level of cv2 on uint8 frames and equal at a frame's own
size; labels resize by cv2.INTER_NEAREST's index rule.
"""

from typing import Dict

import numpy as np
import torch

from floodseg_tpu_torch.ops.resize import resize_bilinear

# ImageNet mean/std scaled by 255
MEAN = [0.485 * 255, 0.456 * 255, 0.406 * 255]
STD = [0.229 * 255, 0.224 * 255, 0.225 * 255]

Sample = Dict[str, object]
_FRAMES = ("frame_current", "frame_prev", "frame_next")


def resize_frames(frames, size) -> torch.Tensor:
    """Resize frames (..., H, W, 3) to ``size=(h, w)``: half-pixel bilinear
    in float32. uint8 frames come back as uint8, rounded and clipped as cv2
    returns them; float frames keep their dtype. Grids need no resize: their
    coordinates are normalized."""
    x = torch.as_tensor(frames)
    if x.dtype == torch.uint8:
        y = resize_bilinear(x.to(torch.float32), size, align_corners=False)
        return y.round().clamp(0, 255).to(torch.uint8)
    return resize_bilinear(x, size, align_corners=False)


def _map_frames(sample: Sample, fn) -> Sample:
    for k in _FRAMES:
        if sample.get(k) is not None:
            sample[k] = fn(sample[k])
    return sample


class Compose:
    def __init__(self, transforms):
        self.transforms = [t for t in transforms if t is not None]

    def __call__(self, sample: Sample, rng: np.random.Generator) -> Sample:
        for t in self.transforms:
            sample = t(sample, rng)
        return sample


class IgnoreClasses:
    """Project a set of classes to Background (class 0)."""

    def __init__(self, classes_to_ignore=None):
        self.classes = list(classes_to_ignore or [])

    def __call__(self, sample, rng):
        label = sample.get("label")
        if label is not None:
            for c in self.classes:
                label = np.where(label == c, 0, label)
            sample["label"] = label
        return sample


def _nearest_index(n_in: int, n_out: int) -> np.ndarray:
    """cv2.INTER_NEAREST's source index of each output index:
    floor(x / (n_out / n_in)), clipped."""
    scale = 1.0 / (n_out / n_in)
    return np.minimum(np.floor(np.arange(n_out) * scale).astype(np.int64), n_in - 1)


class Resize:
    """Resize to fixed (h, w): frames bilinear (``resize_frames``), label
    nearest. Grids are untouched (normalized coords are resolution
    independent). A frame already of that size is returned as it is."""

    def __init__(self, size):
        self.size = tuple(int(s) for s in size)  # (h, w)

    def _frame(self, im):
        if tuple(im.shape[:2]) == self.size:
            return im
        return resize_frames(np.ascontiguousarray(im), self.size).numpy()

    def __call__(self, sample, rng):
        _map_frames(sample, self._frame)
        label = sample.get("label")
        if label is not None and tuple(label.shape[:2]) != self.size:
            h, w = self.size
            label = np.asarray(label)
            sample["label"] = label[_nearest_index(label.shape[0], h)][
                :, _nearest_index(label.shape[1], w)]
        return sample


class Normalize:
    """float32 conversion + (x - mean) / std on frames (std optional)."""

    def __init__(self, mean=MEAN, std=STD):
        self.mean = np.asarray(mean, dtype=np.float32)
        self.std = None if std is None else np.asarray(std, dtype=np.float32)

    def __call__(self, sample, rng):
        def norm(im):
            im = im.astype(np.float32) - self.mean
            if self.std is not None:
                im = im / self.std
            return im

        return _map_frames(sample, norm)


class ToFloat:
    """float32 conversion without normalization (the port's predict
    builders normalize on the device)."""

    def __call__(self, sample, rng):
        return _map_frames(sample, lambda im: im.astype(np.float32))


def build_test_transform(classes_ignore=None, resize=(1072, 1920),
                         normalize: bool = False) -> Compose:
    """Ignore classes, resize, then normalize or only convert to float32.
    The port's flow predict passes ``normalize=False``: its builders
    normalize on the device."""
    return Compose([
        IgnoreClasses(classes_ignore),
        Resize(resize),
        Normalize() if normalize else ToFloat(),
    ])
