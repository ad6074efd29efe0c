"""Datasets over the reference's on-disk layout (counterpart of
floodseg_tpu/data/dataset.py).

Layout:
  <root>/frames/<video>/images/<frame_id>.jpg
  <root>/frames/<video>/{grids,inv_grids}/<frame_id>.npy   (block MV grids)
  <root>/masks/<clip>/<k>.png                              (label masks)
  <root>/list/<variant>/{train,val,test,test2,train_u}.txt (3-field lines)

Images are read with the port's own codec (data/image.py), not PIL.
"""

import bisect
import os
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from floodseg_tpu_torch.data.image import imread
from floodseg_tpu_torch.video.grid import default_grid


def parse_list(list_path: str, min_frame_id: Optional[int] = None) -> List[Tuple[str, str, int]]:
    """Read (label_path, video_id, frame_id) triples from a list file
    (3- or 4-field lines)."""
    items = []
    with open(list_path) as f:
        for line in f:
            parts = line.strip().split(" ")
            if not parts or parts == [""]:
                continue
            if len(parts) not in (3, 4):
                raise RuntimeError(f"Image list file read line error: {line!r}")
            label_name, video_id, frame_id = parts[0], parts[1], int(parts[2])
            if min_frame_id is not None and frame_id < min_frame_id:
                continue
            items.append((label_name, video_id, frame_id))
    return items


class SemDataset:
    """Single-frame dataset (reference util/dataset.py SemData).

    split:
      train/val: image + label
      test:      image + an all-zero uint8 label (the unlabeled streams)
    """

    def __init__(self, split: str, data_root: str, list_path: str,
                 transform: Optional[Callable] = None):
        self.split = split
        self.data_root = data_root
        self.items = parse_list(list_path)
        self.transform = transform

    def __len__(self):
        return len(self.items)

    def frame_path(self, video_id: str, frame_id: int) -> str:
        return os.path.join(self.data_root, "frames", video_id, "images", f"{frame_id}.jpg")

    def get(self, index: int, rng: np.random.Generator) -> Dict:
        label_name, video_id, frame_id = self.items[index]
        image = imread(self.frame_path(video_id, frame_id))
        if self.split == "test":
            label = np.zeros(image.shape[:2], dtype=np.uint8)
        else:
            label = imread(os.path.join(self.data_root, label_name))
        sample = {"frame_current": image, "label": label}
        if self.transform is not None:
            sample = self.transform(sample, rng)
        sample["label"] = np.asarray(sample["label"], dtype=np.int32)
        return sample


class FlowDataset:
    """Keyframe-pair dataset (reference flow/dataset.py FlowData).

    type: "l" labeled (frames+grids+label) / "u" unlabeled (frames+grids) /
          "gt" ground-truth-only (current frame + label).
    split "predict": item i is the key-frame window [i*delta, (i+1)*delta]
    with all delta-1 grids; there are ``len(images) // frame_delta`` items.

    The left/right key-frame distance is random in train, index-seeded in
    val/test; missing frames fall back to the nearest existing neighbors,
    and the grid chains are padded to a fixed delta-1 with identity grids
    sized like the dataset's own grids (probed from the first grid file).
    Predict items carry the RESOLVED key ids (after the fallback), on which
    the predict key-feature cache keys.
    """

    def __init__(self, split: str, data_root: str,
                 list_path: Optional[str] = None,
                 type: str = "l",
                 transform: Optional[Callable] = None,
                 frame_delta: int = 25,
                 no_warp: bool = False,
                 predict_v_id: str = "florida-01",
                 no_random_frame_delta: bool = False):
        self.split = split
        self.data_root = data_root
        self.type = type
        self.transform = transform
        self.frame_delta = frame_delta
        self.no_warp = no_warp
        self.no_random_frame_delta = no_random_frame_delta
        if split != "predict":
            self.items = parse_list(list_path, min_frame_id=frame_delta // 2)
            self.length = len(self.items)
        else:
            self.video_id = predict_v_id
            frames = os.listdir(os.path.join(data_root, "frames", predict_v_id, "images"))
            self.length = len(frames) // frame_delta
        self.default_grid = default_grid().astype(np.float32)
        probe = self._find_any_grid()
        if probe is not None and probe.shape != self.default_grid.shape:
            bh, bw = probe.shape[:2]
            self.default_grid = default_grid(bh * 16, bw * 16).astype(np.float32)

    def _find_any_grid(self):
        frames_root = os.path.join(self.data_root, "frames")
        if not os.path.isdir(frames_root):
            return None
        for v in sorted(os.listdir(frames_root)):
            gdir = os.path.join(frames_root, v, "grids")
            if os.path.isdir(gdir):
                for f in sorted(os.listdir(gdir))[:1]:
                    try:
                        return np.load(os.path.join(gdir, f))
                    except (OSError, ValueError):
                        return None
        return None

    def __len__(self):
        return self.length

    # ---- paths / io ----

    def frame_path(self, v, i):
        return os.path.join(self.data_root, "frames", v, "images", f"{i}.jpg")

    def grid_path(self, v, i, name):
        return os.path.join(self.data_root, "frames", v, name, f"{i}.npy")

    def _frame_exists(self, v, i):
        return (os.path.exists(self.frame_path(v, i))
                and os.path.exists(self.grid_path(v, i, "grids"))
                and os.path.exists(self.grid_path(v, i, "inv_grids")))

    def _load_grid(self, v, i, name):
        return np.load(self.grid_path(v, i, name)).astype(np.float32)

    # ---- item assembly ----

    def get(self, index: int, rng: np.random.Generator) -> Dict:
        if self.split != "predict":
            label_path, v_id, f_index = self.items[index]
        else:
            label_path, v_id, f_index = None, self.video_id, index * self.frame_delta

        if self.split in ("val", "test"):
            delta_l = np.random.default_rng(index).integers(1, self.frame_delta)
        elif self.no_random_frame_delta:
            delta_l = self.frame_delta // 2
        else:
            delta_l = rng.integers(1, self.frame_delta)
        delta_l = int(delta_l)
        delta_r = self.frame_delta - delta_l
        if self.no_random_frame_delta and self.split not in ("val", "test"):
            # the reference's non-val/test branch covers train AND predict:
            # both deltas become frame_delta // 2
            delta_r = self.frame_delta // 2

        sample: Dict = {}
        if self.split == "train":
            sample["frame_current"] = imread(self.frame_path(v_id, f_index))

        if self.type != "gt":
            if self.split == "predict":
                f_prev, f_next = f_index, f_index + self.frame_delta
            else:
                f_prev, f_next = f_index - delta_l, f_index + delta_r
            # nearest-existing fallback
            while not self._frame_exists(v_id, f_prev):
                f_prev += 1
            while not self._frame_exists(v_id, f_next):
                f_next -= 1
            sample["frame_prev"] = imread(self.frame_path(v_id, f_prev))
            sample["frame_next"] = imread(self.frame_path(v_id, f_next))

            if not self.no_warp:
                mvs_left, mvs_right = [], []
                if self.split == "predict":
                    for i in range(self.frame_delta - 1):
                        mvs_left.append(self._load_grid(v_id, f_index + i + 1, "grids"))
                        mvs_right.append(self._load_grid(v_id, f_index + i + 1, "inv_grids"))
                    mvs_right.reverse()
                else:
                    for i in range(delta_l):
                        gi = f_index - delta_l + i + 1
                        mvs_left.append(self._load_grid(v_id, gi, "grids")
                                        if gi > f_prev else self.default_grid)
                    while len(mvs_left) < self.frame_delta - 1:
                        mvs_left.append(self.default_grid)
                    for i in range(delta_r):
                        gi = f_index + i + 1
                        mvs_right.append(self._load_grid(v_id, gi, "inv_grids")
                                         if gi <= f_next else self.default_grid)
                    mvs_right.reverse()
                    while len(mvs_right) < self.frame_delta - 1:
                        mvs_right.append(self.default_grid)
                sample["mvs_left"] = mvs_left
                sample["mvs_right"] = mvs_right

        if self.type != "u" and self.split != "predict":
            sample["label"] = imread(os.path.join(self.data_root, label_path))

        if self.transform is not None:
            sample = self.transform(sample, rng)

        if sample.get("label") is not None:
            sample["label"] = np.asarray(sample["label"], dtype=np.int32)
        if self.split == "predict":
            sample["frame_id"] = f_index
            sample["prev_frame_id"] = f_prev
            sample["next_frame_id"] = f_next
        sample["left_index"] = delta_l
        sample["right_index"] = delta_r
        return sample


_INT_KEYS = ("left_index", "right_index", "frame_id", "prev_frame_id", "next_frame_id",
             "target", "dataset_idx")


def collate(samples: List[Dict]) -> Dict[str, np.ndarray]:
    """Stack a list of samples into batched numpy arrays: grid lists
    TIME-MAJOR (T, B, gh, gw, 2) float32, ids int32, labels int32, every
    other array float32."""
    out: Dict[str, np.ndarray] = {}
    for k in samples[0].keys():
        vals = [s[k] for s in samples]
        if k in ("mvs_left", "mvs_right"):
            per = [np.stack(v, axis=0) for v in vals]
            out[k] = np.stack(per, axis=1).astype(np.float32)
        elif k in _INT_KEYS or k == "label":
            out[k] = np.asarray(vals if k in _INT_KEYS else np.stack(vals), dtype=np.int32)
        else:
            out[k] = np.stack(vals).astype(np.float32)
    return out


class ConcatDataset:
    """Concatenation that also reports which sub-dataset an item came from
    (``dataset_idx``)."""

    def __init__(self, datasets):
        self.datasets = list(datasets)
        self.cumulative = []
        total = 0
        for d in self.datasets:
            total += len(d)
            self.cumulative.append(total)

    def __len__(self):
        return self.cumulative[-1] if self.cumulative else 0

    def get(self, index: int, rng) -> Dict:
        if index < 0:
            index += len(self)
        di = bisect.bisect_right(self.cumulative, index)
        si = index - (self.cumulative[di - 1] if di > 0 else 0)
        sample = self.datasets[di].get(si, rng)
        sample["dataset_idx"] = di
        return sample
