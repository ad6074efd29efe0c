"""H.264 block-motion-vector grid algebra (numpy, host side).

A "grid" is a (block_h, block_w, 2) array of normalized [-1, 1] (x, y)
sampling coordinates, one per 16 px macroblock, consumed by the bilinear
warps. This is the port's own copy of the predict path's part of
floodseg_tpu/video/grid.py, with the crop renormalisation of the
sliding-window predict and the flip. Where the JAX package resizes a grid
with cv2.INTER_LINEAR (``crop_motion_vectors_np``, the train crop), the
port repeats cv2's float32 arithmetic; where it resizes a stacked chain
with a matrix (``crop_motion_vectors_stack_np``, the sliding window), the
port uses the same half-pixel matrix (ops/resize.py's, align_corners=False).
"""

from functools import lru_cache

import numpy as np

from floodseg_tpu_torch.ops.cv2_compat import cv2_resize_linear
from floodseg_tpu_torch.ops.resize import _interp_matrix

BLOCK_SIZE = 16
FRAME_W, FRAME_H = 1920, 1072


def default_grid(height: int = FRAME_H, width: int = FRAME_W,
                 block: int = BLOCK_SIZE) -> np.ndarray:
    """Identity grid: each block samples its own center."""
    bh, bw = height // block, width // block
    xs = (np.arange(bw) * block + block // 2) / width * 2 - 1
    ys = (np.arange(bh) * block + block // 2) / height * 2 - 1
    grid = np.empty((bh, bw, 2), dtype=np.float32)
    grid[..., 0] = xs[None, :]
    grid[..., 1] = ys[:, None]
    return grid


def grids_from_motion_vectors(
    motion_vectors: np.ndarray,
    height: int = FRAME_H,
    width: int = FRAME_W,
    block: int = BLOCK_SIZE,
):
    """Decoder MVs -> (grid, inv_grid), both identity where no MV lands.

    ``motion_vectors``: (N, >=7) rows in mvextractor layout: src pixel at
    columns (3, 4), dst pixel at (5, 6). For each MV the normalized center of
    the source block is written at the dst block of ``grid`` (warping the
    previous frame with ``grid`` moves content forward); symmetrically the
    dst block center lands at the src block of ``inv_grid`` (backward warp).
    Out-of-frame blocks are skipped.
    """
    grid = default_grid(height, width, block).copy()
    inv_grid = default_grid(height, width, block).copy()
    bh, bw = grid.shape[:2]
    if motion_vectors is None or len(motion_vectors) == 0:
        return grid, inv_grid

    def center_x(b):
        return (b * block + block // 2) / width * 2 - 1

    def center_y(b):
        return (b * block + block // 2) / height * 2 - 1

    mv = np.asarray(motion_vectors, dtype=np.float64)
    src_bx = (mv[:, 3] // block).astype(np.int64)
    src_by = (mv[:, 4] // block).astype(np.int64)
    dst_bx = (mv[:, 5] // block).astype(np.int64)
    dst_by = (mv[:, 6] // block).astype(np.int64)

    ok = (0 <= dst_bx) & (dst_bx < bw) & (0 <= dst_by) & (dst_by < bh)
    grid[dst_by[ok], dst_bx[ok], 0] = center_x(src_bx[ok])
    grid[dst_by[ok], dst_bx[ok], 1] = center_y(src_by[ok])
    ok = (0 <= src_bx) & (src_bx < bw) & (0 <= src_by) & (src_by < bh)
    inv_grid[src_by[ok], src_bx[ok], 0] = center_x(dst_bx[ok])
    inv_grid[src_by[ok], src_bx[ok], 1] = center_y(dst_by[ok])
    return grid.astype(np.float32), inv_grid.astype(np.float32)


def crop_motion_vectors_np(grids, height: int, width: int, crop_h: int, crop_w: int,
                           h_off: int, w_off: int):
    """Renormalize a list of grids to a crop window: crop each grid to the
    blocks covering the window, remap the coordinates from full-frame
    [-1, 1] to crop-window [-1, 1], and resize to (crop_h//16, crop_w//16)
    blocks as the JAX package's cv2.INTER_LINEAR does, to the bit."""
    if not grids:
        return grids
    fin_bh, fin_bw = crop_h // BLOCK_SIZE, crop_w // BLOCK_SIZE
    ppb_h, ppb_w = height / grids[0].shape[-3], width / grids[0].shape[-2]
    bh_off, bw_off = round(h_off / ppb_h), round(w_off / ppb_w)
    bh = round((h_off + crop_h) / ppb_h) - bh_off
    bw = round((w_off + crop_w) / ppb_w) - bw_off
    out = []
    for g in grids:
        m = np.array(g[bh_off:bh_off + bh, bw_off:bw_off + bw], dtype=np.float32)
        m[..., 0] = ((((m[..., 0] + 1) / 2) * width - w_off) / (bw * ppb_w)) * 2 - 1
        m[..., 1] = ((((m[..., 1] + 1) / 2) * height - h_off) / (bh * ppb_h)) * 2 - 1
        out.append(cv2_resize_linear(m, (fin_bh, fin_bw)))
    return out


@lru_cache(maxsize=64)
def _linear_resize_matrix(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) half-pixel bilinear interpolation matrix (cv2
    INTER_LINEAR's convention), float32."""
    return _interp_matrix(n_in, n_out, align_corners=False).astype(np.float32)


def crop_motion_vectors_stack_np(grids: np.ndarray, height: int, width: int, crop_h: int,
                                 crop_w: int, h_off: int, w_off: int) -> np.ndarray:
    """``crop_motion_vectors_np`` over a stacked (T, bh, bw, 2) chain: one
    slice, one coordinate remap and one matrix resize for all T grids."""
    fin_bh, fin_bw = crop_h // BLOCK_SIZE, crop_w // BLOCK_SIZE
    ppb_h, ppb_w = height / grids.shape[1], width / grids.shape[2]
    bh_off, bw_off = round(h_off / ppb_h), round(w_off / ppb_w)
    bh = round((h_off + crop_h) / ppb_h) - bh_off
    bw = round((w_off + crop_w) / ppb_w) - bw_off
    m = np.array(grids[:, bh_off:bh_off + bh, bw_off:bw_off + bw], dtype=np.float32)
    # full-frame [-1, 1] coordinates -> the crop window's
    m[..., 0] = ((((m[..., 0] + 1) / 2) * width - w_off) / (bw * ppb_w)) * 2 - 1
    m[..., 1] = ((((m[..., 1] + 1) / 2) * height - h_off) / (bh * ppb_h)) * 2 - 1
    tmp = np.tensordot(_linear_resize_matrix(bh, fin_bh), m, axes=(1, 1))  # (fin_bh, T, bw, 2)
    out = np.tensordot(tmp, _linear_resize_matrix(bw, fin_bw), axes=(2, 1))  # (fin_bh, T, 2, fin_bw)
    return np.ascontiguousarray(out.transpose(1, 0, 3, 2))


def flip_grid_np(grid: np.ndarray) -> np.ndarray:
    """Horizontal-flip a grid: mirror the block layout and negate x."""
    g = grid[:, ::-1].copy()
    g[..., 0] = -g[..., 0]
    return g
