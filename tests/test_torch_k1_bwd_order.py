"""The order contract K1-bwd's gather relies on, held on the CPU.

K1-bwd (floodseg_tpu_torch/csrc/warp.cu) sums, for each source pixel, the
products w_k(p) * grad_out[p] of its entries e = k * P + p in ascending
order, from +0.0, one rounding a multiply and one an add, in float32, and
rounds the float32 sum once for bf16. That is bit-equal to its plain
version, ``ops/grid_sample.py::grid_sample_backward``, only because the
plain version's ``index_add_`` on the CPU adds tap 0, 1, 2 and 3 in turn,
each over the points in order. This file holds a plain-torch mirror of the
kernel's design (the entries ordered by (source pixel, e) into CSR
offsets, then one gather step a rank: every pixel adds its r-th entry)
against the plain version by integer view, in float32 and bf16, both align
modes, on random, up-sampling (13x13 -> 26x26: about 16 points on a
pixel), corner-clamped (every tap on one pixel), identity and the
reference's full-frame 67x120 grids (onto 134x240: the shape at which the
kernel's index build keeps its arrays in a device workspace), with C = 5
and C = 72. If a later torch sums ``index_add_`` in another order,
this test fails here, and it says why the card's bit-equality check in
chip_smoke.py broke.
"""

import numpy as np
import pytest
import torch

from floodseg_tpu_torch.ops.grid_sample import grid_sample_backward, tap_indices_weights

B = 2
KINDS = ("random", "upsample", "corner", "identity", "wide")


def gather_mirror(grad_out, grid, x_shape, align_corners):
    """K1-bwd's algorithm in plain torch: the index build (entries ordered
    by (source pixel, e), CSR offsets), then the gather, rank by rank."""
    b, h, w, c = x_shape
    _, gh, gw, _ = grid.shape
    points, pixels = gh * gw, h * w
    idx, wgt = tap_indices_weights(h, w, grid.reshape(b, points, 2), align_corners)
    g = grad_out.reshape(b, points, c).float()
    out = torch.empty((b, pixels, c), dtype=torch.float32)
    e = torch.arange(4 * points)
    for i in range(b):
        source = idx[i].T.reshape(-1)  # entry e = k * P + p
        weight = wgt[i].T.reshape(-1)
        order = torch.argsort(source * (4 * points) + e)
        counts = torch.bincount(source, minlength=pixels)
        offsets = torch.cumsum(counts, 0) - counts
        s_sorted = source[order]
        rank = torch.arange(4 * points) - offsets[s_sorted]
        acc = torch.zeros((pixels, c), dtype=torch.float32)  # from +0.0
        for r in range(int(counts.max())):
            pick = rank == r  # at most one entry of a pixel
            ent = order[pick]
            acc[s_sorted[pick]] = acc[s_sorted[pick]] + g[i, ent % points] * weight[ent, None]
        out[i] = acc
    return out.reshape(x_shape).to(grad_out.dtype)


def _identity(gh, gw, align_corners):
    """Each point on a pixel centre of a (gh, gw) map."""
    if align_corners:
        xs, ys = np.linspace(-1, 1, gw), np.linspace(-1, 1, gh)
    else:
        xs, ys = (2 * np.arange(gw) + 1) / gw - 1, (2 * np.arange(gh) + 1) / gh - 1
    g = np.stack(np.meshgrid(xs, ys), -1)
    return np.broadcast_to(g, (B, gh, gw, 2))


def _case(kind, align_corners, rng):
    """(x's (H, W), the grid (B, gh, gw, 2) float32)."""
    if kind == "random":
        hw, grid = (13, 17), rng.uniform(-1.2, 1.2, (B, 5, 6, 2))
    elif kind == "upsample":  # the ViT head's 13x13 token map under a 26x26 grid
        hw = (13, 13)
        grid = _identity(26, 26, align_corners) + rng.uniform(-0.05, 0.05, (B, 26, 26, 2))
    elif kind == "corner":
        hw, grid = (13, 17), np.full((B, 5, 6, 2), -1.5)
    elif kind == "identity":
        hw, grid = (9, 11), _identity(9, 11, align_corners)
    else:  # the reference's full-frame grid, whose index build takes a workspace
        hw, grid = (134, 240), rng.uniform(-1.1, 1.1, (B, 67, 120, 2))
    return hw, torch.from_numpy(np.ascontiguousarray(grid, np.float32))


def _bits(t):
    return t.view(torch.int32 if t.dtype == torch.float32 else torch.int16)


@pytest.mark.parametrize("c", [5, 72])
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("align_corners", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gather_in_entry_order_is_bit_equal_to_plain(dtype, align_corners, kind, c):
    rng = np.random.default_rng((KINDS.index(kind), c, int(align_corners)))
    hw, grid = _case(kind, align_corners, rng)
    x_shape = (B,) + hw + (c,)
    g = torch.from_numpy(rng.standard_normal((B,) + tuple(grid.shape[1:3]) + (c,))
                         .astype(np.float32)).to(dtype)
    got = gather_mirror(g, grid, x_shape, align_corners)
    want = grid_sample_backward(g, grid, x_shape, align_corners)
    assert got.dtype == want.dtype == dtype
    assert torch.equal(_bits(got), _bits(want))


def test_sums_start_from_plus_zero():
    """A pixel whose every product is -0.0 comes out +0.0 in both: the sum
    starts from +0.0, not from the first product. The point (0, 0) on a
    1x3 map has fx = 1.0: tap 0 on pixel 1 with weight 1, taps 1 and 3 on
    pixel 2 with weight 0, so a negative gradient gives pixel 2 two -0.0
    products."""
    grid = torch.zeros((1, 1, 1, 2))
    g = torch.full((1, 1, 1, 4), -1.0)
    for dtype in (torch.float32, torch.bfloat16):
        got = gather_mirror(g.to(dtype), grid, (1, 1, 3, 4), False)
        want = grid_sample_backward(g.to(dtype), grid, (1, 1, 3, 4), False)
        assert torch.equal(_bits(got), _bits(want))
        assert torch.equal(want[0, 0, 1].float(), g[0, 0, 0])
        assert (want[0, 0, 2] == 0).all() and not torch.signbit(want[0, 0, 2]).any()
