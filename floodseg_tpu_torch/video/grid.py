"""H.264 block-motion-vector grid algebra (numpy, host side).

A "grid" is a (block_h, block_w, 2) array of normalized [-1, 1] (x, y)
sampling coordinates, one per 16 px macroblock, consumed by the bilinear
warps. This is the port's own copy of the predict path's part of
floodseg_tpu/video/grid.py; the crop renormalisation helpers come with the
crop-predict path.
"""

import numpy as np

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
