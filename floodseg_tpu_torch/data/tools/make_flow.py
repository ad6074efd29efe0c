"""Build the train/val/test/test2/train_u lists of a tree from its labeled
masks (counterpart of floodseg_tpu/data/tools/make_flow.py).

Label files are numbered per clip (``masks/<clip>/<k>.png``, k at 1 fps of a
25 fps stream); ``get_global_frame_id`` maps each to a global frame id
through the clip's start offset and (piecewise) playback speed. Writes
``list/<variant>/{train,val,test,test2,train_u}.txt``, ``dataset.csv`` and
prints each list's length and the class distribution. The UAV-5 clip
tables are the defaults; pass others for a new dataset.

Masks are read with the port's codec (data/image.py::imread, PIL's
arrays); ``dataset.csv`` is written with the ``csv`` module in the bytes
``pandas.DataFrame.to_csv(index=False)`` writes, so neither PIL nor pandas
is needed.

    python -m floodseg_tpu_torch.data.tools.make_flow --root <tree> [--variant all]
"""

import argparse
import csv
import os
from typing import Dict, List, Union

import numpy as np

from floodseg_tpu_torch.data.image import imread

# each clip's start offset in the concatenated source video
VIDEO_SEGMENT_START_FRAME: Dict[str, int] = {
    "florida-01": 13037, "florida-02": 2389, "florida-03": 6137,
    "florida-04": 23626, "florida-05": 27884, "florida-06": 30737,
    "florida-07": 8746, "florida-08": 15048, "florida-09": 21209,
    "texas-01": 0, "florida-u": 0,
}

# each clip's playback speed; a list is piecewise chapters
VIDEO_SPEED: Dict[str, Union[float, List[dict]]] = {
    "florida-01": 1.0, "florida-02": 1.0, "florida-03": 1.0,
    "florida-04": 3.0,
    "florida-05": [
        {"start": 0, "speed": 3.0},
        {"start": 515, "speed": 1.5},
        {"start": 1060, "speed": 2.0},
    ],
    "florida-06": 1.0, "florida-07": 1.5, "florida-08": 1.5,
    "florida-09": 1.0, "texas-01": 1.0, "florida-u": 1.0,
}

DEFAULT_VARIANT = {
    "videos": {
        "florida-01": "test", "florida-02": "train", "florida-03": "val",
        "florida-04": "train", "florida-05": "train", "florida-06": "train",
        "florida-07": "train", "florida-08": "train", "florida-09": "train",
        "texas-01": "test2", "florida-u": "train",
    }
}

CSV_COLUMNS = ("label_path", "video_segment", "label_id", "video", "frame_id")


def get_global_frame_id(video: str, i: int, speeds=VIDEO_SPEED,
                        starts=VIDEO_SEGMENT_START_FRAME) -> int:
    """Label index (1-based, 1 fps) -> global frame id."""
    rel = (i - 1) * 25
    speed = speeds[video]
    if isinstance(speed, list):
        chapter = None
        for k in range(len(speed)):
            nxt = speed[k + 1]["start"] if k + 1 < len(speed) else None
            if rel >= speed[k]["start"] and (nxt is None or rel < nxt):
                chapter = k
                break
        if chapter is None:
            raise RuntimeError(f"no chapter for label {i} of {video}")
        frame_id = 0
        for p in range(chapter + 1):
            if p == chapter:
                frame_id += int(speed[p]["speed"] * (rel - speed[p]["start"]))
            else:
                frame_id += int(speed[p]["speed"] * (speed[p + 1]["start"] - speed[p]["start"]))
    else:
        frame_id = int(speed * rel)
    return frame_id + starts[video]


def write_dataset_csv(path: str, rows) -> None:
    """``rows`` under CSV_COLUMNS, as pandas' ``to_csv(index=False)``
    writes them: comma-separated, minimal quoting, "\\n" line ends."""
    with open(path, "w", newline="") as f:
        w = csv.writer(f, lineterminator="\n")
        w.writerow(CSV_COLUMNS)
        w.writerows(rows)


def build_lists(root: str, variant: str = "all", videos: Dict[str, str] = None,
                unsupervised_index: Dict[str, List[int]] = None, num_classes: int = 5,
                require_frames: bool = True, speeds=None, starts=None):
    """Scan ``masks/``, map each label to its global frame and write
    ``list/<variant>/*.txt`` and ``dataset.csv``. ``videos``: clip ->
    split (train, val, test, test2; anything else trains);
    ``unsupervised_index``: clip -> label indices listed in train_u.txt
    (training clips only). Returns (the lists, the class distribution of
    the masks' pixels)."""
    speeds = speeds or VIDEO_SPEED
    starts = starts or VIDEO_SEGMENT_START_FRAME
    videos = videos or DEFAULT_VARIANT["videos"]
    unsupervised_index = unsupervised_index or {}
    lists = {"train": [], "val": [], "test": [], "test2": [], "train_u": []}
    stats = np.zeros(num_classes)
    total = 0
    rows = []

    for video, split in videos.items():
        global_video = video.split("-")[0]
        mask_dir = os.path.join(root, "masks", video)
        items = []
        if os.path.isdir(mask_dir):
            for filename in sorted(os.listdir(mask_dir), key=lambda f: int(f.split(".")[0])):
                i = int(filename.split(".")[0])
                frame_id = get_global_frame_id(video, i, speeds, starts)
                label_file = os.path.join("masks", video, filename)
                frame_path = os.path.join(root, "frames", global_video, "images",
                                          f"{frame_id}.jpg")
                if require_frames and not os.path.exists(frame_path):
                    raise FileNotFoundError(frame_path)
                items.append((label_file, global_video, str(frame_id)))
                rows.append((label_file, video, i, global_video, frame_id))
                lab = imread(os.path.join(root, label_file))
                vals, counts = np.unique(lab, return_counts=True)
                for v, c in zip(vals, counts):
                    if v < num_classes:
                        stats[v] += c
                total += lab.size
        key = {"val": "val", "test": "test", "test2": "test2"}.get(split, "train")
        lists[key] += items
        if split not in ("val", "test", "test2", "valtest"):
            for i in unsupervised_index.get(video, []):
                frame_id = get_global_frame_id(video, i, speeds, starts)
                lists["train_u"].append(("invalid", global_video, str(frame_id)))

    out_dir = os.path.join(root, "list", variant)
    os.makedirs(out_dir, exist_ok=True)
    for name, data in lists.items():
        with open(os.path.join(out_dir, f"{name}.txt"), "w") as f:
            for item in data:
                f.write(" ".join(item) + "\n")
    write_dataset_csv(os.path.join(out_dir, "dataset.csv"), rows)
    dist = stats / max(total, 1)
    print({k: len(v) for k, v in lists.items()},
          "class distribution:", [f"{x:.4f}" for x in dist])
    return lists, dist


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--root", default=".")
    p.add_argument("--variant", default="all")
    p.add_argument("--no-require-frames", action="store_true")
    args = p.parse_args(argv)
    build_lists(args.root, args.variant, require_frames=not args.no_require_frames)


if __name__ == "__main__":
    main()
