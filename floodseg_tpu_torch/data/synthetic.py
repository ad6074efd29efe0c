"""Synthetic flood-UAV-like clips, in memory.

Counterpart of floodseg_tpu/data/synthetic.py without the file tree: no
JPEG, no PIL, no file IO. The same drifting class-colored blobs over a
textured background with a smooth global motion field, and per-frame
block-MV grids derived from that analytic motion through the same
MV -> grid construction used for real H.264 vectors.

``predict_windows`` cuts a clip into predict windows as
floodseg_tpu/data/dataset.py does for the predict split: key frames at
``i*n`` and ``(i+1)*n``, ``mvs_left`` = grids ``i*n+1 .. i*n+n-1``,
``mvs_right`` = the matching inv_grids reversed, time-major
``(T, 1, gh, gw, 2)``.
"""

from typing import Dict, List, Sequence, Tuple

import numpy as np

from floodseg_tpu_torch.video.grid import BLOCK_SIZE, grids_from_motion_vectors

PALETTE = np.array(
    [[0, 0, 0], [30, 95, 170], [65, 117, 5], [212, 98, 1], [255, 244, 1]],
    dtype=np.uint8,
)


def _motion(t: float, rng_amp: np.ndarray) -> Tuple[float, float]:
    """Smooth global translation (pixels/frame) at time t."""
    dx = rng_amp[0] * np.sin(0.1 * t) + rng_amp[1]
    dy = rng_amp[2] * np.cos(0.07 * t) + rng_amp[3]
    return float(dx), float(dy)


def _render(size, t, offset, rng) -> Tuple[np.ndarray, np.ndarray]:
    """Frame + label at accumulated offset."""
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
    img = np.clip(img + rng.normal(0, 3, img.shape), 0, 255).astype(np.uint8)
    return img, label


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

    bh, bw = h // BLOCK_SIZE, w // BLOCK_SIZE
    cy = (np.arange(bh) * BLOCK_SIZE + BLOCK_SIZE // 2).astype(np.float64)
    cx = (np.arange(bw) * BLOCK_SIZE + BLOCK_SIZE // 2).astype(np.float64)
    cxx, cyy = np.meshgrid(cx, cy)

    frames = {}
    grids = np.empty((num_frames, bh, bw, 2), np.float32)
    inv_grids = np.empty_like(grids)
    offset = np.zeros(2)
    for t in range(num_frames):
        dx, dy = _motion(t, amp)
        offset += (dx, dy)
        if t in wanted:
            frames[t], _ = _render(size, t, offset, rng)
        # analytic MVs: every dst block's content came from (dst - motion)
        mv = np.zeros((bh * bw, 7))
        mv[:, 0] = -1
        mv[:, 1] = mv[:, 2] = BLOCK_SIZE
        mv[:, 3] = (cxx - dx).ravel()
        mv[:, 4] = (cyy - dy).ravel()
        mv[:, 5] = cxx.ravel()
        mv[:, 6] = cyy.ravel()
        grids[t], inv_grids[t] = grids_from_motion_vectors(mv, h, w)
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
