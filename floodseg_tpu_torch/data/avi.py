"""Motion-JPEG AVI files, written and read with the port's JPEG codec.

``MJPGWriter`` is the counterpart of floodseg_tpu/train/predict.py's
``_Cv2Writer`` (an MJPG AVI through OpenCV): a RIFF AVI with one video
stream ('vids', 'MJPG'), one JPEG a frame in the 'movi' list and an
'idx1' index, which OpenCV and ffmpeg read. ``read_mjpg_avi`` reads the
frames back.
"""

import struct
from typing import List

import numpy as np

from floodseg_tpu_torch.data.image import decode_jpeg, encode_jpeg

_AVIF_HASINDEX = 0x10
_AVIIF_KEYFRAME = 0x10


class MJPGWriter:
    """``append_data(rgb)`` one (H, W, 3) uint8 frame at a time (every
    frame of one size), ``close()`` to finish the file."""

    def __init__(self, path: str, fps: int = 25):
        self._f = open(path, "wb")
        self._fps = int(fps)
        self._size = None
        self._index = []      # (offset from 'movi', size)
        self._movi_start = None

    def append_data(self, frame_rgb: np.ndarray) -> None:
        h, w = frame_rgb.shape[:2]
        if self._size is None:
            self._size = (w, h)
            self._f.write(b"\0" * self._header_size())
            self._movi_start = self._f.tell() - 4  # the 'movi' fourcc
        elif self._size != (w, h):
            raise ValueError(f"frame of {w}x{h} in a {self._size[0]}x{self._size[1]} video")
        data = encode_jpeg(frame_rgb, 92)
        self._index.append((self._f.tell() - self._movi_start, len(data)))
        self._f.write(b"00dc" + struct.pack("<I", len(data)) + data)
        if len(data) % 2:
            self._f.write(b"\0")

    @staticmethod
    def _header_size() -> int:
        # RIFF + hdrl LIST (avih, strl LIST (strh, strf)) + movi LIST header
        return 12 + 12 + (8 + 56) + 12 + (8 + 56) + (8 + 40) + 12

    def _header(self, movi_bytes: int, file_bytes: int) -> bytes:
        w, h = self._size
        frames = len(self._index)
        biggest = max(s for _, s in self._index)
        avih = struct.pack("<14I", 1_000_000 // self._fps, 0, 0, _AVIF_HASINDEX, frames, 0, 1,
                           biggest, w, h, 0, 0, 0, 0)
        strh = (b"vidsMJPG" + struct.pack("<IHHIIIIIIiI", 0, 0, 0, 0, 1, self._fps, 0, frames,
                                           biggest, -1, 0)
                + struct.pack("<4h", 0, 0, w, h))
        strf = struct.pack("<IiiHH4sIiiII", 40, w, h, 1, 24, b"MJPG", w * h * 3, 0, 0, 0, 0)
        strl = (b"LIST" + struct.pack("<I", 4 + 8 + len(strh) + 8 + len(strf)) + b"strl"
                + b"strh" + struct.pack("<I", len(strh)) + strh
                + b"strf" + struct.pack("<I", len(strf)) + strf)
        hdrl = b"hdrl" + b"avih" + struct.pack("<I", len(avih)) + avih + strl
        out = (b"RIFF" + struct.pack("<I", file_bytes - 8) + b"AVI "
               + b"LIST" + struct.pack("<I", len(hdrl)) + hdrl
               + b"LIST" + struct.pack("<I", movi_bytes) + b"movi")
        assert len(out) == self._header_size()
        return out

    def close(self) -> None:
        if self._f.closed:
            return
        try:
            if self._size is not None:
                movi_bytes = self._f.tell() - self._movi_start
                idx = b"".join(b"00dc" + struct.pack("<III", _AVIIF_KEYFRAME, off, size)
                               for off, size in self._index)
                self._f.write(b"idx1" + struct.pack("<I", len(idx)) + idx)
                file_bytes = self._f.tell()
                self._f.seek(0)
                self._f.write(self._header(movi_bytes, file_bytes))
        finally:
            self._f.close()


def read_mjpg_avi(path: str) -> List[np.ndarray]:
    """Every frame of a motion-JPEG AVI, decoded, in file order."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:4] != b"RIFF" or data[8:12] != b"AVI ":
        raise ValueError(f"{path}: not an AVI file")
    frames = []

    def walk(pos, end):
        while pos + 8 <= end:
            cid = data[pos:pos + 4]
            size = struct.unpack("<I", data[pos + 4:pos + 8])[0]
            if cid == b"LIST":
                walk(pos + 12, pos + 8 + size)
            elif cid[2:] in (b"dc", b"db") and size:
                frames.append(decode_jpeg(data[pos + 8:pos + 8 + size]))
            pos += 8 + size + (size & 1)

    walk(12, len(data))
    return frames
