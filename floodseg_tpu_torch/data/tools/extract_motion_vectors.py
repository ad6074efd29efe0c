"""Extract the frames and block motion-vector grids of an H.264 video
(counterpart of floodseg_tpu/data/tools/extract_motion_vectors.py).

Each frame of mvextractor's ``VideoCap`` keeps its full 16x16-block motion
vectors, which become its (grid, inv_grid) sampling grids
(video/grid.py::grids_from_motion_vectors); the tool writes
``<out>/<video>/{images/<i>.jpg, grids/<i>.npy, inv_grids/<i>.npy}``, the
frame through the port's JPEG encoder (the decoder's BGR as RGB, quality
92).

The video must be encoded without B-frames (``ffmpeg -c:v libx264 -x264opts
bframes=0 -partitions none -filter:v fps=25,scale=1920x1072``), so that
every vector points one frame back. mvextractor is optional: without it
``extract`` stops with a message. ``extract(..., source=...)`` takes any
iterable of (BGR frame, vectors) in its place.

    python -m floodseg_tpu_torch.data.tools.extract_motion_vectors VIDEO... [--out frames]
"""

import argparse
import os
from typing import Iterable, Iterator, Optional, Tuple

import numpy as np

from floodseg_tpu_torch.data.image import write_jpeg
from floodseg_tpu_torch.video.grid import BLOCK_SIZE, grids_from_motion_vectors

Frames = Iterable[Tuple[np.ndarray, np.ndarray]]


def video_frames(video_path: str) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """(BGR frame, motion vectors) of each decoded frame of ``video_path``
    through mvextractor's ``VideoCap``; raises ``SystemExit`` when
    mvextractor is absent or the video does not open."""
    try:
        from mvextractor.videocap import VideoCap
    except ImportError as e:
        raise SystemExit(
            "mvextractor is required for motion-vector extraction "
            "(pip install motion-vector-extractor) — not bundled in this "
            "image; the rest of the framework runs without it.") from e
    cap = VideoCap()
    if not cap.open(video_path):
        raise SystemExit(f"could not open {video_path}")

    def frames():
        try:
            while True:
                ok, frame, mvs, _frame_type, _ = cap.read()
                if not ok:
                    break
                yield frame, mvs
        finally:
            cap.release()

    return frames()


def extract(video_path: str, out_root: str = "frames", source: Optional[Frames] = None) -> int:
    """Write ``video_path``'s frames and grids under ``out_root/<video
    name>``; ``source``: (BGR frame, mvextractor-layout vectors) pairs in
    place of the decoder. Returns the frames written."""
    frames = video_frames(video_path) if source is None else source
    name = os.path.splitext(os.path.basename(video_path))[0]
    img_dir = os.path.join(out_root, name, "images")
    grid_dir = os.path.join(out_root, name, "grids")
    inv_dir = os.path.join(out_root, name, "inv_grids")
    for d in (img_dir, grid_dir, inv_dir):
        os.makedirs(d, exist_ok=True)
    i = 0
    for frame, mvs in frames:
        h, w = frame.shape[:2]
        # only full 16x16 vectors take part
        if len(mvs):
            mvs = mvs[(mvs[:, 1] == BLOCK_SIZE) & (mvs[:, 2] == BLOCK_SIZE)]
        grid, inv_grid = grids_from_motion_vectors(mvs, h, w)
        write_jpeg(os.path.join(img_dir, f"{i}.jpg"), np.ascontiguousarray(frame[..., ::-1]))
        np.save(os.path.join(grid_dir, f"{i}.npy"), grid)
        np.save(os.path.join(inv_dir, f"{i}.npy"), inv_grid)
        i += 1
    print(f"{name}: {i} frames extracted")
    return i


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("videos", nargs="+")
    p.add_argument("--out", default="frames")
    args = p.parse_args(argv)
    for v in args.videos:
        extract(v, args.out)


if __name__ == "__main__":
    main()
