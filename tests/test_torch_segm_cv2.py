"""The port's replacements of cv2 and PIL on the Segmenter stack's path,
against cv2 and PIL themselves (oracles only; the port imports neither).

- ``cv2_rgb2hsv_u8`` / ``cv2_hsv2rgb_u8`` equal ``cv2.cvtColor`` on every
  uint8 input: all 2**24 RGB triples, all 180 x 256 x 256 HSV triples, each
  in rows of 256 pixels (cv2's vector body) and of 31 (its scalar tail,
  which rounds HSV2RGB's result where the body truncates it), and on
  images of widths whose rows end in a tail.
- ``cv2_resize_cubic`` against ``cv2.resize(INTER_CUBIC)`` on seeded
  random uint8 images, up and down, 1 and 3 channels, at sizes up to
  300 px: cv2 5.0 hands INTER_CUBIC to IPP, whose float32 summation order
  is not documented; the port's order leaves values that lie within about
  one float32 ulp of a half rounding the other way. The bound: no value
  off by more than 1, and at most 2e-5 of the values off at all (9 of
  1,569,871 measured, 5.7e-6).
- ``cv2_resize_linear`` on float32 1-, 3- and 4-channel images of random
  sizes (the mmseg resize's input): equal to cv2 but at source positions
  within about 1e-15 of an integer, where cv2 5.0 lands elsewhere; held
  within 64 ulps at no more than 5e-3 of the values (47 ulps and 0.21%
  measured, in 12 of 180 cases; the sizes of
  tests/test_torch_segm_data.py are all equal).
- ``pil_resize_bicubic`` equals PIL's ``Image.resize`` (BICUBIC) bit for
  bit, up and down, on L and RGB images.
- ``read_rgb`` equals ``Image.open(p).convert("RGB")`` on L, RGB, P (8 and
  4 bit) PNGs and on grayscale and colour JPEGs; ``imread`` keeps a P
  PNG's indices, as ``np.asarray(Image.open(p))`` does.
"""

import cv2
import numpy as np
import pytest
from PIL import Image

from floodseg_tpu_torch.data.image import imread, read_rgb
from floodseg_tpu_torch.ops.cv2_compat import (
    cv2_hsv2rgb_u8,
    cv2_resize_cubic,
    cv2_resize_linear,
    cv2_rgb2hsv_u8,
    pil_resize_bicubic,
)

CUBIC_SHARE = 2e-5


def _rows(triples: np.ndarray, width: int) -> np.ndarray:
    """(n, 3) -> (rows, width, 3), the last row padded with the first
    triples."""
    pad = -len(triples) % width
    return np.concatenate([triples, triples[:pad]]).reshape(-1, width, 3)


@pytest.mark.parametrize("width", [256, 31], ids=["vector", "tail"])
def test_rgb2hsv_equals_cv2_on_every_rgb_triple(width):
    for r in range(0, 256, 16):
        idx = np.arange(r << 16, (r + 16) << 16, dtype=np.uint32)
        rgb = np.stack([(idx >> 16) & 255, (idx >> 8) & 255, idx & 255], -1).astype(np.uint8)
        rgb = _rows(rgb, width)
        np.testing.assert_array_equal(cv2_rgb2hsv_u8(rgb), cv2.cvtColor(rgb, cv2.COLOR_RGB2HSV))


@pytest.mark.parametrize("width", [256, 31], ids=["vector", "tail"])
def test_hsv2rgb_equals_cv2_on_every_hsv_triple(width):
    for h0 in range(0, 180, 12):
        hh, ss, vv = np.meshgrid(np.arange(h0, h0 + 12), np.arange(256), np.arange(256),
                                 indexing="ij")
        hsv = _rows(np.stack([hh, ss, vv], -1).astype(np.uint8).reshape(-1, 3), width)
        np.testing.assert_array_equal(cv2_hsv2rgb_u8(hsv), cv2.cvtColor(hsv, cv2.COLOR_HSV2RGB))


def test_hsv_round_trip_equals_cv2_on_images():
    rng = np.random.default_rng(1)
    for w in (1, 24, 33, 70, 95, 128):
        rgb = rng.integers(0, 256, (7, w, 3), dtype=np.uint8)
        hsv = cv2.cvtColor(rgb, cv2.COLOR_RGB2HSV)
        np.testing.assert_array_equal(cv2_rgb2hsv_u8(rgb), hsv)
        np.testing.assert_array_equal(cv2_hsv2rgb_u8(hsv), cv2.cvtColor(hsv, cv2.COLOR_HSV2RGB))


def test_resize_cubic_against_cv2():
    rng = np.random.default_rng(5)
    off = total = 0
    for i in range(24):
        h, w = (int(v) for v in rng.integers(5, 300, 2))
        oh, ow = (int(v) for v in rng.integers(5, 300, 2))
        shape = (h, w, 3) if i % 4 else (h, w)
        im = rng.integers(0, 256, shape, dtype=np.uint8)
        ref = cv2.resize(im, (ow, oh), interpolation=cv2.INTER_CUBIC)
        ours = cv2_resize_cubic(im, (oh, ow))
        assert ours.shape == ref.shape and ours.dtype == np.uint8
        d = np.abs(ours.astype(np.int64) - ref)
        assert d.max() <= 1, (shape, oh, ow)
        off += int((d > 0).sum())
        total += d.size
    assert off <= CUBIC_SHARE * total, (off, total)


def test_resize_linear_float32_against_cv2_on_random_sizes():
    rng = np.random.default_rng(7)
    off = total = 0
    for ch in (1, 3, 4):
        for _ in range(60):
            h, w = (int(v) for v in rng.integers(2, 90, 2))
            oh, ow = (int(v) for v in rng.integers(2, 180, 2))
            im = (rng.random((h, w, ch)) * 255).astype(np.float32)
            ref = cv2.resize(im, (ow, oh), interpolation=cv2.INTER_LINEAR).reshape(oh, ow, ch)
            ours = cv2_resize_linear(im, (oh, ow))
            d = np.abs(ours - ref)
            assert (d <= 64 * np.spacing(np.abs(ref))).all(), (h, w, oh, ow, ch)
            off += int((d > 0).sum())
            total += d.size
    assert off <= 5e-3 * total, (off, total)


@pytest.mark.parametrize("size", [(37, 53, 80, 61), (300, 200, 224, 224), (64, 48, 17, 29),
                                  (1, 7, 3, 9)])
def test_pil_resize_bicubic_equals_pil(size):
    h, w, oh, ow = size
    rng = np.random.default_rng(h + w)
    for shape in ((h, w, 3), (h, w)):
        im = rng.integers(0, 256, shape, dtype=np.uint8)
        ref = np.asarray(Image.fromarray(im).resize((ow, oh)))
        np.testing.assert_array_equal(pil_resize_bicubic(im, (ow, oh)), ref)


def test_read_rgb_equals_pil_convert(tmp_path):
    rng = np.random.default_rng(0)
    files = {}
    files["l.png"] = Image.fromarray(rng.integers(0, 256, (23, 37), dtype=np.uint8))
    files["rgb.png"] = Image.fromarray(rng.integers(0, 256, (23, 37, 3), dtype=np.uint8))
    p8 = Image.fromarray(rng.integers(0, 200, (23, 37), dtype=np.uint8), "P")
    p8.putpalette(rng.integers(0, 256, 600).tolist())
    files["p8.png"] = p8
    p4 = Image.fromarray(rng.integers(0, 12, (19, 41), dtype=np.uint8), "P")
    p4.putpalette(rng.integers(0, 256, 36).tolist())
    files["p4.png"] = p4
    files["gray.jpg"] = Image.fromarray(rng.integers(0, 256, (33, 45), dtype=np.uint8))
    files["rgb.jpg"] = Image.fromarray(rng.integers(0, 256, (33, 45, 3), dtype=np.uint8))
    for name, im in files.items():
        path = str(tmp_path / name)
        im.save(path)
        ref = np.asarray(Image.open(path).convert("RGB"))
        ours = read_rgb(path)
        assert ours.dtype == np.uint8 and ours.shape == ref.shape, name
        np.testing.assert_array_equal(ours, ref, err_msg=name)
        np.testing.assert_array_equal(imread(path), np.asarray(Image.open(path)), err_msg=name)


def test_read_rgb_raises_on_other_files(tmp_path):
    path = str(tmp_path / "rgba.png")
    Image.fromarray(np.zeros((4, 4, 4), np.uint8), "RGBA").save(path)
    with pytest.raises(ValueError, match="unsupported PNG"):
        read_rgb(path)
    path = str(tmp_path / "x.bmp")
    Image.fromarray(np.zeros((4, 4, 3), np.uint8)).save(path)
    with pytest.raises(ValueError, match="neither a JPEG nor a PNG"):
        read_rgb(path)
