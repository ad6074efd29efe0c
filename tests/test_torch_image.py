"""The port's image codec (floodseg_tpu_torch/data/image.py, csrc/jpeg.cpp)
against PIL, the JAX package's codec, on the CPU.

The port's JPEG decoder must give PIL's pixels exactly on files PIL writes
(baseline 4:2:0 and 4:4:4 at quality 75, 92 and 95, sizes that are not a
multiple of the MCU, restart markers, grayscale), and its encoder must
write, for an RGB frame at quality 92, the bytes PIL writes, so that PIL
decodes both files to the same pixels. PNGs round-trip both ways. The
codec builds here with the host C++ compiler.
"""

import io
import threading

import numpy as np
import pytest
from PIL import Image

from floodseg_tpu_torch.data import image, synthetic_clip

SIZES = [(64, 64), (37, 53), (101, 77), (2, 3), (17, 300)]


def _frame(h, w, seed=0):
    """A smooth, textured RGB frame with noise (what the data path carries)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    base = np.stack([80 + 60 * np.sin(xx * 0.07 + rng.uniform()),
                     90 + 50 * np.cos(yy * 0.05),
                     120 + 40 * np.sin((xx + yy) * 0.03)], -1)
    return np.clip(base + rng.normal(0, 12, base.shape), 0, 255).astype(np.uint8)


def _pil_jpeg(arr, **kw) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="JPEG", **kw)
    return buf.getvalue()


def _pil_decode(data: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(data)))


@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("quality", [75, 92, 95])
@pytest.mark.parametrize("subsampling", [2, 0], ids=["420", "444"])
def test_jpeg_decode_equals_pil(size, quality, subsampling):
    arr = _frame(*size, seed=size[0] * size[1] + quality)
    data = _pil_jpeg(arr, quality=quality, subsampling=subsampling)
    got = image.decode_jpeg(data)
    ref = _pil_decode(data)
    assert got.dtype == np.uint8 and got.shape == ref.shape == size + (3,)
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("kind", ["restart_markers", "grayscale", "422"])
def test_jpeg_decode_equals_pil_other_layouts(kind):
    arr = _frame(101, 77, seed=5)
    if kind == "restart_markers":
        data = _pil_jpeg(arr, quality=92, restart_marker_blocks=3)
        assert b"\xff\xdd" in data and b"\xff\xd0" in data
    elif kind == "grayscale":
        data = _pil_jpeg(arr[..., 1], quality=90)
    else:
        data = _pil_jpeg(arr, quality=92, subsampling=1)
    got = image.decode_jpeg(data)
    np.testing.assert_array_equal(got, _pil_decode(data))


@pytest.mark.parametrize("size", SIZES + [(192, 256)], ids=lambda s: f"{s[0]}x{s[1]}")
def test_jpeg_encode_equals_pil(size):
    """At quality 92 (the synthetic writer's), the port writes PIL's bytes,
    so PIL decodes the port's file to the pixels of its own."""
    arr = _frame(*size, seed=7)
    ours = image.encode_jpeg(arr, quality=92)
    ref = _pil_jpeg(arr, quality=92)
    np.testing.assert_array_equal(_pil_decode(ours), _pil_decode(ref))
    assert ours == ref
    np.testing.assert_array_equal(image.decode_jpeg(ours), _pil_decode(ref))


def test_jpeg_round_trip_psnr_at_q92():
    """A synthetic frame at the reference's 1072x1920 comes back from q92
    above 35 dB (37.8 measured)."""
    arr = synthetic_clip(1, size=(1072, 1920))["frames"][0]
    back = image.decode_jpeg(image.encode_jpeg(arr, 92)).astype(np.float64)
    mse = np.mean((back - arr) ** 2)
    assert 10 * np.log10(255.0 ** 2 / mse) > 35


@pytest.mark.parametrize("kind", ["progressive", "cmyk", "not_a_jpeg", "truncated"])
def test_jpeg_decode_raises_on_unsupported(kind):
    arr = _frame(32, 32)
    if kind == "progressive":
        data, match = _pil_jpeg(arr, quality=90, progressive=True), "progressive"
    elif kind == "cmyk":
        buf = io.BytesIO()
        Image.fromarray(arr).convert("CMYK").save(buf, format="JPEG")
        data, match = buf.getvalue(), "4 components"
    elif kind == "not_a_jpeg":
        data, match = b"GIF89a" + bytes(20), "not a JPEG"
    else:
        data, match = _pil_jpeg(arr, quality=90)[:200], "JPEG"
    with pytest.raises(ValueError, match=match):
        image.decode_jpeg(data)


def test_jpeg_decode_in_threads():
    """Loader threads decode at once (the ctypes call releases the GIL) and
    each gets its own frame's pixels."""
    datas = [_pil_jpeg(_frame(64, 80, seed=s), quality=92) for s in range(8)]
    refs = [_pil_decode(d) for d in datas]
    got = [None] * len(datas)

    def work(i):
        for _ in range(3):
            got[i] = image.decode_jpeg(datas[i])

    threads = [threading.Thread(target=work, args=(i,)) for i in range(len(datas))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    for g, r in zip(got, refs):
        np.testing.assert_array_equal(g, r)


def _pil_png(img: Image.Image) -> bytes:
    buf = io.BytesIO()
    img.save(buf, format="PNG")
    return buf.getvalue()


PALETTE = np.array([[0, 0, 0], [30, 95, 170], [65, 117, 5], [212, 98, 1], [255, 244, 1]],
                   np.uint8)


@pytest.mark.parametrize("mode", ["L", "P", "RGB"])
def test_png_reads_what_pil_writes(mode):
    rng = np.random.default_rng(1)
    if mode == "RGB":
        arr = _frame(45, 67)
        img = Image.fromarray(arr)
    else:
        # a label-like map: smooth regions (PIL's adaptive filters then
        # pick every filter type somewhere) with scattered noise
        arr = ((np.add.outer(np.arange(45), np.arange(67)) // 9) % 5).astype(np.uint8)
        arr[rng.random(arr.shape) < 0.05] = 3
        img = Image.fromarray(arr, mode="L")
        if mode == "P":
            img = img.convert("P")
            img.putpalette(PALETTE.flatten().tolist())
    data = _pil_png(img)
    np.testing.assert_array_equal(image.decode_png(data), np.asarray(Image.open(io.BytesIO(data))))


@pytest.mark.parametrize("mode", ["L", "P"])
def test_pil_reads_what_png_writes(mode):
    arr = np.random.default_rng(2).integers(0, 5, (33, 70)).astype(np.uint8)
    data = image.encode_png(arr, palette=PALETTE if mode == "P" else None)
    img = Image.open(io.BytesIO(data))
    assert img.mode == mode
    np.testing.assert_array_equal(np.asarray(img), arr)
    if mode == "P":
        assert img.getpalette()[:15] == PALETTE.flatten().tolist()
    np.testing.assert_array_equal(image.decode_png(data), arr)


def test_imread_and_writers_on_files(tmp_path):
    arr = _frame(48, 64)
    image.write_jpeg(str(tmp_path / "f.jpg"), arr, quality=92)
    image.write_png(str(tmp_path / "m.png"), arr[..., 0] % 5)
    np.testing.assert_array_equal(image.imread(str(tmp_path / "f.jpg")),
                                  np.asarray(Image.open(tmp_path / "f.jpg")))
    np.testing.assert_array_equal(image.imread(str(tmp_path / "m.png")), arr[..., 0] % 5)
    (tmp_path / "x.bin").write_bytes(b"nothing")
    with pytest.raises(ValueError, match="neither a JPEG nor a PNG"):
        image.imread(str(tmp_path / "x.bin"))
