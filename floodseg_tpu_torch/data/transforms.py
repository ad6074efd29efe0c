"""The host transforms and the frame resize.

Counterpart of floodseg_tpu/data/transforms.py: transforms take and return
a sample dict carrying any of frame_current, frame_prev, frame_next,
mvs_left, mvs_right and label, in numpy on the host, with an
``np.random.Generator``, from which each transform draws what the JAX
package's draws, in the same order.

The JAX package resizes, blurs and pads with cv2; the machine with the card
has neither cv2 nor PIL. ``resize_frames`` (the predict path's ``Resize``)
is the port's own half-pixel bilinear (ops/resize.py with
align_corners=False, cv2.INTER_LINEAR's convention), within 1 grey level
of cv2 on uint8 frames and equal at a frame's own size. The train
transforms reproduce cv2's arithmetic instead (ops/cv2_compat.py):
cv2.resize(None, fx, fy) sizes the output with round(w * fx) and maps with
1 / fx; GaussianBlur((5, 5), 0) is the fixed [1, 4, 6, 4, 1] / 16 table;
labels resize by INTER_NEAREST's floor(x / fx) rule; ``RandRotate``
(getRotationMatrix2D and warpAffine, frames bilinear and labels nearest,
constant borders) runs only on the single-frame and ``no_warp``
pipelines, since grids cannot rotate.
"""

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from floodseg_tpu_torch.ops.cv2_compat import (
    blur_5_valid,
    reflect101,
    cv2_gaussian_blur_5,
    cv2_resize_linear,
    cv2_resize_nearest,
    rotation_matrix_2d,
    warp_affine,
)
from floodseg_tpu_torch.ops.resize import resize_bilinear
from floodseg_tpu_torch.video.grid import crop_motion_vectors_np, flip_grid_np

# ImageNet mean/std scaled by 255
MEAN = [0.485 * 255, 0.456 * 255, 0.406 * 255]
STD = [0.229 * 255, 0.224 * 255, 0.225 * 255]

Sample = Dict[str, object]
_FRAMES = ("frame_current", "frame_prev", "frame_next")
_GRIDS = ("mvs_left", "mvs_right")
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


def _map_grids(sample: Sample, fn) -> Sample:
    for k in _GRIDS:
        if sample.get(k) is not None:
            sample[k] = [fn(m) for m in sample[k]]
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


def _scaled_hw(shape, fy: float, fx: float) -> Tuple[int, int]:
    """cv2's output size for fx, fy: saturate_cast<int>, round half to even."""
    return int(np.rint(shape[0] * fy)), int(np.rint(shape[1] * fx))


class RandScale:
    """Scale frames and label by s drawn from the generator: frames
    bilinear, the label nearest; grids are untouched. With
    ``aspect_ratio`` (a range, which no pipeline sets), a ratio ar drawn
    after s stretches the two axes apart: fx = s * sqrt(ar), fy = s /
    sqrt(ar), as the JAX transform draws and computes them."""

    def __init__(self, scale, aspect_ratio=None):
        if not 0 < scale[0] <= scale[1]:
            raise ValueError(f"RandScale needs 0 < min <= max, got {scale}")
        self.scale = scale
        self.aspect_ratio = aspect_ratio

    def draw(self, rng) -> Tuple[float, float]:
        """(fy, fx), drawn as the JAX transform draws them."""
        s = self.scale[0] + (self.scale[1] - self.scale[0]) * rng.random()
        ar = 1.0
        if self.aspect_ratio is not None:
            lo, hi = self.aspect_ratio
            ar = float(np.sqrt(lo + (hi - lo) * rng.random()))
        return s / ar, s * ar

    @staticmethod
    def apply(sample, fy: float, fx: float):
        _map_frames(sample, lambda im: cv2_resize_linear(
            im, _scaled_hw(im.shape, fy, fx), (fy, fx)))
        label = sample.get("label")
        if label is not None:
            label = np.asarray(label)
            sample["label"] = cv2_resize_nearest(label, _scaled_hw(label.shape, fy, fx),
                                                 (fy, fx))
        return sample

    def __call__(self, sample, rng):
        return self.apply(sample, *self.draw(rng))


class RandRotate:
    """With probability ``p``, rotate frames and label by an angle drawn
    uniformly from ``rotate`` (degrees) about the centre of the label (or
    of frame_current), keeping their size: frames bilinear with the
    ``padding`` border, the label nearest with ``ignore_label``. Grids are
    untouched: the pipelines that rotate carry none, or ignore them."""

    def __init__(self, rotate, padding, ignore_label=255, p=0.5):
        self.rotate = rotate
        self.padding = padding
        self.ignore_label = ignore_label
        self.p = p

    def draw(self, rng) -> Optional[float]:
        """The angle, or None when the coin says no rotation (the JAX
        transform's draws: the coin, then the angle)."""
        if rng.random() >= self.p:
            return None
        return self.rotate[0] + (self.rotate[1] - self.rotate[0]) * rng.random()

    @staticmethod
    def matrix(hw, angle: float) -> np.ndarray:
        h, w = hw
        return rotation_matrix_2d((w / 2, h / 2), angle, 1)

    def apply(self, sample, angle: float):
        ref = sample.get("label")
        if ref is None:
            ref = sample["frame_current"]
        h, w = np.asarray(ref).shape[:2]
        m = self.matrix((h, w), angle)
        _map_frames(sample, lambda im: warp_affine(np.asarray(im), m, (w, h),
                                                   border_value=self.padding))
        if sample.get("label") is not None:
            sample["label"] = warp_affine(np.asarray(sample["label"]), m, (w, h),
                                          nearest=True, border_value=self.ignore_label)
        return sample

    def __call__(self, sample, rng):
        angle = self.draw(rng)
        return sample if angle is None else self.apply(sample, angle)


class RandomGaussianBlur:
    """With probability 1/2, blur every frame with the 5x5 kernel of sigma 0."""

    def __init__(self, radius=5):
        if radius != 5:
            raise ValueError("only cv2's fixed 5x5 kernel (radius 5) is ported")
        self.radius = radius

    @staticmethod
    def draw(rng) -> bool:
        return rng.random() < 0.5

    def __call__(self, sample, rng):
        if self.draw(rng):
            _map_frames(sample, cv2_gaussian_blur_5)
        return sample


class RandomHorizontalFlip:
    """With probability ``p``, mirror frames and label left to right and
    flip the grids (``flip_grid_np``)."""

    def __init__(self, p=0.5):
        self.p = p

    def draw(self, rng) -> bool:
        return not rng.random() >= self.p

    @staticmethod
    def apply(sample):
        _map_frames(sample, lambda im: np.ascontiguousarray(im[:, ::-1]))
        _map_grids(sample, flip_grid_np)
        if sample.get("label") is not None:
            sample["label"] = np.ascontiguousarray(np.asarray(sample["label"])[:, ::-1])
        return sample

    def __call__(self, sample, rng):
        return self.apply(sample) if self.draw(rng) else sample


def _pad_constant(im: np.ndarray, t: int, b: int, l: int, r: int, value) -> np.ndarray:
    """cv2.copyMakeBorder(BORDER_CONSTANT): ``value`` per channel (a scalar
    or a sequence), rounded and saturated to uint8 for uint8 images."""
    v = np.broadcast_to(np.asarray(value, np.float64), (im.shape[2],) if im.ndim == 3 else ())
    if im.dtype == np.uint8:
        v = np.clip(np.rint(v), 0, 255)
    out = np.empty((im.shape[0] + t + b, im.shape[1] + l + r) + im.shape[2:], im.dtype)
    out[...] = v.astype(im.dtype)
    out[t:t + im.shape[0], l:l + im.shape[1]] = im
    return out


class Crop:
    """rand or center crop, padding first when the input is smaller than
    the crop (frames with ``padding``, the label with ``ignore_label``;
    no padding value configured raises). Grids are renormalised to the crop
    window (``crop_motion_vectors_np``)."""

    def __init__(self, size, crop_type="center", padding=None, ignore_label=255):
        self.crop_h, self.crop_w = (size, size) if isinstance(size, int) else size
        if crop_type not in ("rand", "center"):
            raise ValueError(f"crop_type must be rand or center, got {crop_type!r}")
        self.crop_type = crop_type
        self.padding = padding
        self.ignore_label = ignore_label

    @staticmethod
    def _ref(sample):
        if sample.get("label") is not None:
            return sample["label"]
        return next(sample[k] for k in _FRAMES if sample.get(k) is not None)

    def __call__(self, sample, rng):
        h, w = self._ref(sample).shape[:2]
        pad_h, pad_w = max(self.crop_h - h, 0), max(self.crop_w - w, 0)
        if pad_h > 0 or pad_w > 0:
            if self.padding is None:
                raise RuntimeError(
                    f"Crop to {self.crop_h}x{self.crop_w} requires padding a "
                    f"{h}x{w} input, but no padding value was configured")
            t, b_ = pad_h // 2, pad_h - pad_h // 2
            l, r = pad_w // 2, pad_w - pad_w // 2
            _map_frames(sample, lambda im: _pad_constant(im, t, b_, l, r, self.padding))
            if sample.get("label") is not None:
                sample["label"] = _pad_constant(np.asarray(sample["label"]), t, b_, l, r,
                                                self.ignore_label)
            h, w = self._ref(sample).shape[:2]

        if self.crop_type == "rand":
            h_off = int(rng.integers(0, h - self.crop_h + 1))
            w_off = int(rng.integers(0, w - self.crop_w + 1))
        else:
            h_off = (h - self.crop_h) // 2
            w_off = (w - self.crop_w) // 2

        def crop(im):
            return np.ascontiguousarray(im[h_off:h_off + self.crop_h,
                                           w_off:w_off + self.crop_w])

        _map_frames(sample, crop)
        if sample.get("label") is not None:
            sample["label"] = crop(np.asarray(sample["label"]))
        for k in _GRIDS:
            if sample.get(k) is not None:
                sample[k] = crop_motion_vectors_np(sample[k], h, w, self.crop_h,
                                                   self.crop_w, h_off, w_off)
        return sample


class ScaleBlurFlipCrop:
    """RandScale, RandRotate (when ``rotate`` is given), RandomGaussianBlur,
    RandomHorizontalFlip and a rand Crop in one transform: the same draws
    in the same order and the same pixels, computed on the crop window
    only.

    The scale is separable and pointwise in its output indices, the
    rotation pointwise in its output pixel (its source coordinates depend
    on that pixel's row and column alone), the blur reads a 2-pixel halo
    (reflected at the frame's border) and commutes with the flip (a
    symmetric kernel and border), so each frame's window comes from the
    rotated pixels at the window's rows and columns plus the halo, in
    flipped order when flipped, and those from the scaled pixels of the
    block their taps read. A scaled frame smaller than the crop takes the
    unfused path (full frames, then Crop's padding). Grids are flipped,
    then cropped, as the unfused transforms do.
    """

    def __init__(self, scale, size, padding=None, ignore_label=255,
                 rotate: Optional[RandRotate] = None):
        self.scale = RandScale(scale)
        self.rotate = rotate
        self.blur = RandomGaussianBlur()
        self.flip = RandomHorizontalFlip()
        self.crop = Crop(size, crop_type="rand", padding=padding, ignore_label=ignore_label)

    def __call__(self, sample, rng):
        fy, fx = self.scale.draw(rng)
        angle = self.rotate.draw(rng) if self.rotate is not None else None
        blur = self.blur.draw(rng)
        flip = self.flip.draw(rng)
        ref = np.asarray(Crop._ref(sample))
        h0, w0 = ref.shape[:2]
        h, w = _scaled_hw(ref.shape, fy, fx)
        ch, cw = self.crop.crop_h, self.crop.crop_w
        same = all(np.asarray(sample[k]).shape[:2] == (h0, w0)
                   for k in _FRAMES + ("label",) if sample.get(k) is not None)
        if h < ch or w < cw or not same:
            self.scale.apply(sample, fy, fx)
            if angle is not None:
                self.rotate.apply(sample, angle)
            if blur:
                _map_frames(sample, cv2_gaussian_blur_5)
            if flip:
                self.flip.apply(sample)
            return self.crop(sample, rng)

        h_off = int(rng.integers(0, h - ch + 1))
        w_off = int(rng.integers(0, w - cw + 1))
        halo = 2 if blur else 0
        rows = reflect101(np.arange(h_off - halo, h_off + ch + halo), h)
        cols = reflect101(np.arange(w_off - halo, w_off + cw + halo), w)
        if flip:
            cols = w - 1 - cols
        m = None if angle is None else RandRotate.matrix((h, w), angle)

        def window(im):
            if m is None:
                p = cv2_resize_linear(im, (h, w), (fy, fx), rows=rows, cols=cols)
            else:
                p = warp_affine(((h, w), lambda r, c: cv2_resize_linear(
                    im, (h, w), (fy, fx), rows=r, cols=c)), m, (w, h),
                    border_value=self.rotate.padding, rows=rows, cols=cols)
            return np.ascontiguousarray(blur_5_valid(p) if blur else p)

        _map_frames(sample, window)
        label = sample.get("label")
        if label is not None:
            label = np.asarray(label)
            lr, lc = rows[halo:halo + ch], cols[halo:halo + cw]
            if m is None:
                out = cv2_resize_nearest(label, (h, w), (fy, fx), rows=lr, cols=lc)
            else:
                out = warp_affine(((h, w), lambda r, c: cv2_resize_nearest(
                    label, (h, w), (fy, fx), rows=r, cols=c)), m, (w, h), nearest=True,
                    border_value=self.rotate.ignore_label, rows=lr, cols=lc)
            sample["label"] = np.ascontiguousarray(out)
        if flip:
            _map_grids(sample, flip_grid_np)
        for k in _GRIDS:
            if sample.get(k) is not None:
                sample[k] = crop_motion_vectors_np(sample[k], h, w, ch, cw, h_off, w_off)
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


def build_train_transform(train_h: int, train_w: int, classes_ignore=None,
                          scale_min: float = 0.5, scale_max: float = 2.0,
                          resize=(1072, 1920), with_rotate: bool = True,
                          crop_padding=MEAN, ignore_index: int = 255,
                          normalize: bool = True) -> Compose:
    """Ignore classes, resize, random scale, random rotation in [-10, 10]
    degrees (``with_rotate``: the single-frame pipeline and the flow
    ``no_warp`` one, where there are no grids to rotate; padded with MEAN),
    random blur, random flip, random crop (all as ``ScaleBlurFlipCrop``),
    then normalize (or only float32)."""
    rotate = (RandRotate([-10, 10], padding=MEAN, ignore_label=ignore_index)
              if with_rotate else None)
    return Compose([
        IgnoreClasses(classes_ignore),
        Resize(resize),
        ScaleBlurFlipCrop([scale_min, scale_max], [train_h, train_w], padding=crop_padding,
                          ignore_label=ignore_index, rotate=rotate),
        Normalize() if normalize else ToFloat(),
    ])


def build_val_transform(train_h: int, train_w: int, classes_ignore=None,
                        resize=(1072, 1920), crop: bool = True, crop_padding=MEAN,
                        ignore_index: int = 255) -> Compose:
    """Ignore classes, resize, center crop (``crop``), normalize."""
    return Compose([
        IgnoreClasses(classes_ignore),
        Resize(resize),
        Crop([train_h, train_w], crop_type="center", padding=crop_padding,
             ignore_label=ignore_index) if crop else None,
        Normalize(),
    ])
