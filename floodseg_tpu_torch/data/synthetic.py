"""Synthetic flood-UAV-like clips, in memory and as a dataset tree.

Counterpart of floodseg_tpu/data/synthetic.py: the same drifting
class-colored blobs over a textured background with a smooth global motion
field, and per-frame block-MV grids derived from that analytic motion
through the same MV -> grid construction used for real H.264 vectors.
``generate_synthetic_dataset`` writes the JAX package's tree (JPEG frames
at quality 92 and PNG masks with the port's own codec, data/image.py);
``synthetic_clip`` renders a clip in memory.

``predict_windows`` cuts a clip into predict windows as
floodseg_tpu/data/dataset.py does for the predict split: key frames at
``i*n`` and ``(i+1)*n``, ``mvs_left`` = grids ``i*n+1 .. i*n+n-1``,
``mvs_right`` = the matching inv_grids reversed, time-major
``(T, 1, gh, gw, 2)``.
"""

from typing import Dict, List, Sequence, Tuple

import os
from collections import deque
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from floodseg_tpu_torch.data.image import write_jpeg, write_png
from floodseg_tpu_torch.video.grid import BLOCK_SIZE, grids_from_motion_vectors

_WRITERS = min(8, os.cpu_count() or 1)  # threads writing a tree's frames
PALETTE = np.array(
    [[0, 0, 0], [30, 95, 170], [65, 117, 5], [212, 98, 1], [255, 244, 1]],
    dtype=np.uint8,
)


def _motion(t: float, rng_amp: np.ndarray) -> Tuple[float, float]:
    """Smooth global translation (pixels/frame) at time t."""
    dx = rng_amp[0] * np.sin(0.1 * t) + rng_amp[1]
    dy = rng_amp[2] * np.cos(0.07 * t) + rng_amp[3]
    return float(dx), float(dy)


def _render(size, offset, noise) -> Tuple[np.ndarray, np.ndarray]:
    """Frame + label at accumulated offset; ``noise`` is the frame's draw of
    rng.normal(0, 3, (h, w, 3)), taken in frame order by the caller."""
    h, w = size
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    ox, oy = offset
    tex = (np.sin((xx + ox) * 0.11) + np.cos((yy + oy) * 0.13)) * 0.5
    label = np.zeros((h, w), dtype=np.uint8)
    img = np.stack([80 + 40 * tex, 90 + 30 * tex, 70 + 20 * tex], axis=-1)

    # moving class blobs (water 1, tree 2, building 3, street 4)
    blobs = [
        (1, 0.30 * w, 0.60 * h, 0.22 * min(h, w)),
        (2, 0.70 * w, 0.30 * h, 0.15 * min(h, w)),
        (3, 0.55 * w, 0.75 * h, 0.12 * min(h, w)),
        (4, 0.15 * w, 0.20 * h, 0.10 * min(h, w)),
    ]
    for cls, cx, cy, r in blobs:
        cx = (cx + ox) % w
        cy = (cy + oy) % h
        d2 = (xx - cx) ** 2 + (yy - cy) ** 2
        mask = d2 < r * r
        label[mask] = cls
        img[mask] = PALETTE[cls].astype(np.float32) * 0.7 + img[mask] * 0.3
    img = np.clip(img + noise, 0, 255).astype(np.uint8)
    return img, label


def _analytic_mvs(dx, dy, cxx, cyy) -> np.ndarray:
    """Every dst block's content came from (dst - motion), as mvextractor
    rows (source at columns 3, 4; destination at 5, 6)."""
    mv = np.zeros((cxx.size, 7))
    mv[:, 0] = -1
    mv[:, 1] = mv[:, 2] = BLOCK_SIZE
    mv[:, 3] = (cxx - dx).ravel()
    mv[:, 4] = (cyy - dy).ravel()
    mv[:, 5] = cxx.ravel()
    mv[:, 6] = cyy.ravel()
    return mv


def _block_centres(h, w):
    cy = (np.arange(h // BLOCK_SIZE) * BLOCK_SIZE + BLOCK_SIZE // 2).astype(np.float64)
    cx = (np.arange(w // BLOCK_SIZE) * BLOCK_SIZE + BLOCK_SIZE // 2).astype(np.float64)
    return np.meshgrid(cx, cy)


def generate_synthetic_dataset(
    root: str,
    video_id: str = "synth",
    num_frames: int = 60,
    size: Tuple[int, int] = (192, 256),
    frame_delta: int = 5,
    num_labeled: int = 8,
    seed: int = 0,
) -> str:
    """Write a dataset tree under ``root`` and return ``root``: frames,
    grids and inv_grids, masks of the labeled frames, the train, val, test,
    test2 and train_u lists, names.txt and colors.txt, as the JAX package's
    generator writes them for the same arguments (threads render and
    write the frames)."""
    h, w = size
    if h % BLOCK_SIZE or w % BLOCK_SIZE:
        raise ValueError(f"frame size {size} must be a multiple of {BLOCK_SIZE}")
    rng = np.random.default_rng(seed)
    amp = rng.uniform(-2, 2, size=4)

    img_dir = os.path.join(root, "frames", video_id, "images")
    grid_dir = os.path.join(root, "frames", video_id, "grids")
    inv_dir = os.path.join(root, "frames", video_id, "inv_grids")
    mask_dir = os.path.join(root, "masks", video_id)
    list_dir = os.path.join(root, "list", "all")
    for d in (img_dir, grid_dir, inv_dir, mask_dir, list_dir):
        os.makedirs(d, exist_ok=True)

    cxx, cyy = _block_centres(h, w)

    def write(t, offset, noise, dx, dy):
        img, label = _render(size, offset, noise)
        write_jpeg(os.path.join(img_dir, f"{t}.jpg"), img, quality=92)
        grid, inv_grid = grids_from_motion_vectors(_analytic_mvs(dx, dy, cxx, cyy), h, w)
        np.save(os.path.join(grid_dir, f"{t}.npy"), grid)
        np.save(os.path.join(inv_dir, f"{t}.npy"), inv_grid)
        return label

    # the noise is drawn here, in frame order; the frames render and write
    # in threads (numpy and the JPEG encoder release the GIL)
    offset = np.zeros(2)
    labels, pending = {}, deque()
    with ThreadPoolExecutor(max_workers=_WRITERS) as pool:
        for t in range(num_frames):
            dx, dy = _motion(t, amp)
            offset += (dx, dy)
            noise = rng.normal(0, 3, (h, w, 3))
            pending.append((t, pool.submit(write, t, offset.copy(), noise, dx, dy)))
            while len(pending) > 2 * _WRITERS or (t == num_frames - 1 and pending):
                done_t, fut = pending.popleft()
                labels[done_t] = fut.result()

    # labeled frames spread over the valid range [frame_delta, end-frame_delta]
    lo, hi = frame_delta, num_frames - frame_delta - 1
    lab_ids = np.unique(np.linspace(lo, hi, num_labeled).astype(int))
    for fid in lab_ids:
        write_png(os.path.join(mask_dir, f"{fid}.png"), labels[int(fid)])

    def write_list(name, ids, label_fmt="masks/{v}/{fid}.png"):
        with open(os.path.join(list_dir, name), "w") as f:
            for fid in ids:
                label = label_fmt.format(v=video_id, fid=fid)
                f.write(f"{label} {video_id} {fid}\n")

    k = len(lab_ids)
    n_val = max(1, int(round(0.15 * k)))
    n_test = max(1, int(round(0.15 * k)))
    n_train = max(1, k - n_val - n_test)
    train_ids = lab_ids[:n_train]
    val_ids = lab_ids[n_train:n_train + n_val]
    test_ids = lab_ids[n_train + n_val:]
    write_list("train.txt", train_ids)
    write_list("val.txt", val_ids if len(val_ids) else lab_ids[:1])
    write_list("test.txt", test_ids if len(test_ids) else lab_ids[:1])
    write_list("test2.txt", lab_ids[:1])
    # unlabeled list: frames without masks (label path "invalid")
    unlab = [t for t in range(lo, hi) if t not in set(int(i) for i in lab_ids)][::3]
    write_list("train_u.txt", unlab, label_fmt="invalid")

    with open(os.path.join(root, "list", "names.txt"), "w") as f:
        f.write("Background\nWater\nTree\nBuilding\nStreet\n")
    with open(os.path.join(root, "list", "colors.txt"), "w") as f:
        for c in PALETTE:
            f.write(f"{c[0]} {c[1]} {c[2]}\n")
    return root


def synthetic_clip(num_frames: int, size: Tuple[int, int] = (512, 512),
                   frame_ids: Sequence[int] = None, seed: int = 0) -> Dict:
    """A clip of ``num_frames`` frames, in memory.

    Returns {"frames": {id: (H, W, 3) uint8} for ``frame_ids`` (default: all
    frames), "grids" and "inv_grids": (num_frames, H/16, W/16, 2) float32}.
    Only the requested frames are rendered (their labels are dropped); the
    motion, and so every grid, covers the whole clip.
    """
    h, w = size
    if h % BLOCK_SIZE or w % BLOCK_SIZE:
        raise ValueError(f"frame size {size} must be a multiple of {BLOCK_SIZE}")
    wanted = set(range(num_frames) if frame_ids is None else frame_ids)
    rng = np.random.default_rng(seed)
    amp = rng.uniform(-2, 2, size=4)

    cxx, cyy = _block_centres(h, w)

    frames = {}
    grids = np.empty((num_frames, h // BLOCK_SIZE, w // BLOCK_SIZE, 2), np.float32)
    inv_grids = np.empty_like(grids)
    offset = np.zeros(2)
    for t in range(num_frames):
        dx, dy = _motion(t, amp)
        offset += (dx, dy)
        if t in wanted:
            frames[t], _ = _render(size, offset, rng.normal(0, 3, (h, w, 3)))
        grids[t], inv_grids[t] = grids_from_motion_vectors(
            _analytic_mvs(dx, dy, cxx, cyy), h, w)
    return {"frames": frames, "grids": grids, "inv_grids": inv_grids}


def predict_windows(clip: Dict, frame_delta: int) -> List[Dict]:
    """Predict windows of a clip (the predict split of the JAX package's
    FlowDataset): frame_prev/frame_next (1, H, W, 3) uint8, mvs_left and
    mvs_right (n-1, 1, gh, gw, 2) float32, and the key frame ids. Every key
    frame ``i*n`` must have been rendered."""
    n = frame_delta
    num_frames = clip["grids"].shape[0]
    windows = []
    for i in range((num_frames - 1) // n):
        a, b = i * n, (i + 1) * n
        left = clip["grids"][a + 1:a + n]
        right = clip["inv_grids"][a + 1:a + n][::-1]
        windows.append({
            "frame_prev": clip["frames"][a][None],
            "frame_next": clip["frames"][b][None],
            "mvs_left": np.ascontiguousarray(left[:, None]),
            "mvs_right": np.ascontiguousarray(right[:, None]),
            "prev_frame_id": a,
            "next_frame_id": b,
        })
    return windows
