"""Image files without PIL: baseline JPEG and 8-bit PNG.

The port's counterpart of what PIL does for the JAX package: reading frames
and masks (floodseg_tpu/data/dataset.py::_imread, ``np.asarray(Image.open(p))``)
and writing them (data/synthetic.py, train/predict.py). The machine with the
card has no PIL, cv2 or imageio, so the codec is the repository's own:

- JPEG in C++ (``csrc/jpeg.cpp``, built with the host compiler by
  ``ops/build.py`` on first use): baseline Huffman decoding with libjpeg's
  ISLOW inverse DCT, fancy upsampling and YCbCr tables, and a baseline 4:2:0
  encoder with the standard tables and the IJG quality scaling, so both
  equal PIL's (libjpeg-turbo) on the files the data path sees. Progressive,
  arithmetic, 12-bit and CMYK files raise. A ctypes call releases the GIL,
  so the loader's threads decode in parallel.
- PNG on ``zlib``: read 8-bit L and RGB, and P at 1, 2, 4 or 8 bits
  (palette indices, as PIL reads a P image; PIL writes a palette of up to
  16 colours at 4 bits), the row filters undone in the same C++ library;
  written as 8-bit L or P with filter 0 on every row.
- ``read_rgb``: PIL's ``Image.open(path).convert("RGB")`` of those files:
  RGB as it is, L (a grayscale JPEG or PNG) repeated into three channels,
  P looked up in its PLTE chunk (an index past the palette reads black).

There is no fallback: a codec that does not build raises.
"""

import ctypes
import struct
import threading
import zlib
from typing import Optional

import numpy as np

from floodseg_tpu_torch.ops import build

_PNG_SIG = b"\x89PNG\r\n\x1a\n"
_PNG_CHANNELS = {0: 1, 2: 3, 3: 1}  # colour type (L, RGB, P) -> samples a pixel
_BIND_LOCK = threading.Lock()


def _codec() -> ctypes.CDLL:
    lib = build.load("jpeg")
    with _BIND_LOCK:
        if not getattr(lib, "_floodseg_bound", False):
            p, i, sz, buf = ctypes.c_void_p, ctypes.c_int, ctypes.c_size_t, ctypes.c_char_p
            ip = ctypes.POINTER(ctypes.c_int)
            lib.floodseg_codec_error.argtypes = []
            lib.floodseg_codec_error.restype = ctypes.c_char_p
            lib.floodseg_jpeg_info.argtypes = [buf, sz, ip, ip, ip]
            lib.floodseg_jpeg_info.restype = i
            lib.floodseg_jpeg_decode.argtypes = [buf, sz, p, i, i, i]
            lib.floodseg_jpeg_decode.restype = i
            lib.floodseg_jpeg_encode.argtypes = [p, i, i, i, p, sz]
            lib.floodseg_jpeg_encode.restype = ctypes.c_long
            lib.floodseg_png_unfilter.argtypes = [buf, i, i, i, p]
            lib.floodseg_png_unfilter.restype = i
            lib._floodseg_bound = True
    return lib


def _raise(lib, what: str):
    raise ValueError(f"{what}: {lib.floodseg_codec_error().decode()}")


def decode_jpeg(data: bytes) -> np.ndarray:
    """A baseline JPEG in memory -> uint8 (H, W, 3) RGB, or (H, W) grayscale."""
    lib = _codec()
    data = bytes(data)
    h, w, c = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    if lib.floodseg_jpeg_info(data, len(data), ctypes.byref(h), ctypes.byref(w),
                              ctypes.byref(c)) != 0:
        _raise(lib, "cannot read JPEG header")
    shape = (h.value, w.value) if c.value == 1 else (h.value, w.value, c.value)
    out = np.empty(shape, np.uint8)
    if lib.floodseg_jpeg_decode(data, len(data), out.ctypes.data, h.value, w.value,
                                c.value) != 0:
        _raise(lib, "cannot decode JPEG")
    return out


def encode_jpeg(rgb: np.ndarray, quality: int = 92) -> bytes:
    """uint8 (H, W, 3) RGB -> baseline 4:2:0 JFIF bytes, as PIL's
    ``save(..., quality=quality)`` writes them."""
    rgb = np.ascontiguousarray(rgb)
    if rgb.dtype != np.uint8 or rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError(f"encode_jpeg takes uint8 (H, W, 3), got {rgb.dtype} {rgb.shape}")
    lib = _codec()
    h, w = rgb.shape[:2]
    cap = h * w * 3 + 65536
    while True:
        out = np.empty(cap, np.uint8)
        n = lib.floodseg_jpeg_encode(rgb.ctypes.data, h, w, int(quality), out.ctypes.data, cap)
        if n == -2:
            cap *= 4
            continue
        if n < 0:
            _raise(lib, "cannot encode JPEG")
        return out[:n].tobytes()


def _chunks(data: bytes):
    pos = len(_PNG_SIG)
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        if len(body) != length:
            raise ValueError("corrupt PNG: truncated chunk")
        yield kind, body
        pos += 12 + length


def decode_png(data: bytes) -> np.ndarray:
    """A non-interlaced PNG in memory -> uint8 (H, W) for L and P (palette
    indices), (H, W, 3) for RGB."""
    return _decode_png(data)[0]


def _decode_png(data: bytes):
    """(decode_png's array, the colour type, the PLTE chunk as (n, 3)
    uint8 or None)."""
    if not data.startswith(_PNG_SIG):
        raise ValueError("not a PNG file")
    header, idat, palette = None, [], None
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError("corrupt PNG: no IHDR")
    w, h, depth, ctype, _, _, interlace = header
    packed = ctype == 3 and depth in (1, 2, 4)
    if (depth != 8 and not packed) or ctype not in _PNG_CHANNELS or interlace:
        raise ValueError(f"unsupported PNG: bit depth {depth}, colour type {ctype}, "
                         f"interlace {interlace}")
    ch = _PNG_CHANNELS[ctype]
    rowbytes = (w * depth + 7) // 8 if packed else w * ch
    raw = zlib.decompress(b"".join(idat))
    if len(raw) != h * (rowbytes + 1):
        raise ValueError("corrupt PNG: image data of the wrong size")
    lib = _codec()
    out = np.empty((h, rowbytes), np.uint8)
    if lib.floodseg_png_unfilter(raw, h, rowbytes, ch, out.ctypes.data) != 0:
        _raise(lib, "cannot read PNG")
    if packed:  # palette indices, most significant bits first
        shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
        idx = (out[:, :, None] >> shifts) & ((1 << depth) - 1)
        return np.ascontiguousarray(idx.reshape(h, -1)[:, :w]), ctype, palette
    out = out.reshape(h, w, ch)
    return (out[..., 0] if ch == 1 else out), ctype, palette


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def encode_png(arr: np.ndarray, palette: Optional[np.ndarray] = None) -> bytes:
    """uint8 (H, W) -> an L PNG, or a P PNG with ``palette`` (n, 3) uint8
    (n <= 256); uint8 (H, W, 3) -> an RGB PNG. Filter 0 on every row."""
    arr = np.ascontiguousarray(arr)
    rgb = arr.ndim == 3 and arr.shape[2] == 3 and palette is None
    if arr.dtype != np.uint8 or not (arr.ndim == 2 or rgb):
        raise ValueError(f"encode_png takes uint8 (H, W) or (H, W, 3), got {arr.dtype} "
                         f"{arr.shape}")
    h, w = arr.shape[:2]
    ctype = 2 if rgb else 3 if palette is not None else 0
    raw = np.concatenate([np.zeros((h, 1), np.uint8), arr.reshape(h, -1)], axis=1).tobytes()
    out = [_PNG_SIG, _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0))]
    if palette is not None:
        pal = np.asarray(palette, np.uint8).reshape(-1, 3)
        if len(pal) > 256:
            raise ValueError("a PNG palette holds at most 256 colours")
        out.append(_chunk(b"PLTE", pal.tobytes()))
    out += [_chunk(b"IDAT", zlib.compress(raw, 6)), _chunk(b"IEND", b"")]
    return b"".join(out)


def imread(path: str) -> np.ndarray:
    """Read a JPEG or PNG file as PIL's ``np.asarray(Image.open(path))``
    gives it for the data path's files."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:2] == b"\xff\xd8":
        return decode_jpeg(data)
    if data.startswith(_PNG_SIG):
        return decode_png(data)
    raise ValueError(f"{path}: neither a JPEG nor a PNG file")


def read_rgb(path: str) -> np.ndarray:
    """A JPEG or PNG file as PIL's ``np.asarray(Image.open(path)
    .convert("RGB"))`` gives it: uint8 (H, W, 3). A P PNG without a PLTE
    chunk, and any other file, raises."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:2] == b"\xff\xd8":
        im = decode_jpeg(data)
    elif data.startswith(_PNG_SIG):
        im, ctype, palette = _decode_png(data)
        if ctype == 3:
            if palette is None:
                raise ValueError(f"{path}: a palette PNG without a PLTE chunk")
            lut = np.zeros((256, 3), np.uint8)
            lut[:len(palette)] = palette[:256]
            return lut[im]
    else:
        raise ValueError(f"{path}: neither a JPEG nor a PNG file")
    if im.ndim == 2:
        return np.repeat(im[..., None], 3, axis=2)
    return im


def write_jpeg(path: str, rgb: np.ndarray, quality: int = 92) -> None:
    data = encode_jpeg(rgb, quality)
    with open(path, "wb") as f:
        f.write(data)


def write_png(path: str, arr: np.ndarray, palette: Optional[np.ndarray] = None) -> None:
    data = encode_png(arr, palette)
    with open(path, "wb") as f:
        f.write(data)
