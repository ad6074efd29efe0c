"""The kernels' wrappers (floodseg_tpu_torch/ops/warp_kernels.py and
ops/resize_kernels.py).

On the CPU: the wrappers check what their kernels take and then compute
the plain versions; K1's and K2's launch geometry, K1's replayed block by
block; K3's instantiation choice; and the identities K3's quantize rests
on (csrc/resize.cu's note), replayed in exact arithmetic. On the card
(``cuda`` marker; skipped without one): K1, K2 and K3 against their plain
versions, K1 and K2 also at the ViT path's shapes, K1 at its ragged tile
edges. This file
imports no JAX, so the card-only tests run on a machine without it:

    python -m pytest --noconftest tests/test_torch_kernels.py -q -m cuda

(the repository's conftest files set JAX up; ``--noconftest`` skips them).
"""

import numpy as np
import pytest
import torch

from floodseg_tpu_torch.ops import (
    grid_sample,
    grid_sample_autograd,
    grid_sample_backward,
    grid_sample_backward_cuda,
    grid_sample_cuda,
    launch_counts,
    quantize_with_scale,
    reset_launch_counts,
    resize_quantize_int8_cuda,
    resize_quantize_int8_plain,
    warp_chain_cuda,
    warp_chain_plain,
)
from floodseg_tpu_torch.ops.resize_kernels import vector_path
from floodseg_tpu_torch.ops.warp_kernels import (
    _SAMPLE_THREADS,
    ChainGeometry,
    SampleGeometry,
    _chain_geometry,
    _library,
    _sample_geometry,
)

F32_TOL = dict(rtol=1e-5, atol=1e-5)
# the kernels and the plain versions round the same float32 arithmetic in
# the same order, so they agree to the bit; allow one bf16 ulp all the same
BF16_TOL = dict(rtol=2 ** -8, atol=1e-6)


def _inputs(seed, dtype, device="cpu"):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((2, 13, 17, 72)).astype(np.float32))
    grid = torch.from_numpy(rng.uniform(-1.2, 1.2, (2, 5, 6, 2)).astype(np.float32))
    grids = torch.from_numpy(rng.uniform(-1.1, 1.1, (6, 1, 5, 6, 2)).astype(np.float32))
    return x.to(device, dtype), grid.to(device), grids.to(device)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand-written kernels have no CPU mode")
    return torch.device("cuda")


def test_wrappers_route_cpu_tensors_to_plain():
    reset_launch_counts()
    x, grid, grids = _inputs(7, torch.float32)
    for align in (False, True):
        np.testing.assert_array_equal(grid_sample_cuda(x, grid, align).numpy(),
                                      grid_sample(x, grid, align).numpy())
    y0 = x[:1, :5, :6].to(torch.bfloat16).contiguous()
    np.testing.assert_array_equal(warp_chain_cuda(y0, grids).float().numpy(),
                                  warp_chain_plain(y0, grids).float().numpy())
    # the plain route is not a kernel launch
    assert launch_counts() == {"grid_sample_cuda": 0, "grid_sample_backward_cuda": 0,
                               "warp_chain_cuda": 0, "resize_quantize_int8_cuda": 0}


def test_wrappers_reject_what_the_kernels_do_not_take():
    x, grid, grids = _inputs(8, torch.float32)
    with pytest.raises(ValueError, match="contiguous"):
        grid_sample_cuda(x.transpose(1, 2), grid.transpose(1, 2))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        grid_sample_cuda(x.double(), grid)
    with pytest.raises(TypeError, match="grids must be float32"):
        grid_sample_cuda(x, grid.double())
    with pytest.raises(ValueError, match="batch mismatch"):
        grid_sample_cuda(x, grid[:1].contiguous())
    y0 = x[:1, :5, :6].contiguous()
    with pytest.raises(ValueError, match="contiguous"):
        warp_chain_cuda(y0, grids.transpose(2, 3).contiguous().transpose(2, 3))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        warp_chain_cuda(y0.half(), grids)
    with pytest.raises(ValueError, match="grids must be"):
        warp_chain_cuda(y0, grids[:, :, :4])
    with pytest.raises(ValueError, match="y0 must be"):
        warp_chain_cuda(x, grids)


# (c_tile, threads, table_points, smem): table_points 0 is the
# single-buffer design; smem = 2 carries + 2 tap tables in the ping-pong one
@pytest.mark.parametrize("points,c,itemsize,vec,expect", [
    # the flow-predict chain: 128 blocks, 2 x 64 KB carries + 2 x 16 KB tables
    (32 * 32, 4096, 2, 8, (32, 1024, 1, 2 * 1024 * (64 + 16))),
    (32 * 32, 4096, 4, 4, (16, 1024, 1, 2 * 1024 * (64 + 24))),
    # the ViT-B/32 chain (C = 768): the same tile, 24 blocks
    (32 * 32, 768, 2, 8, (32, 1024, 1, 2 * 1024 * (64 + 16))),
    # the reference's 1072x1920 grid: one carry of the narrowest tile
    (67 * 120, 256, 2, 8, (8, 1024, 0, 8040 * 16)),
    (67 * 120, 256, 4, 4, (4, 1024, 0, 8040 * 16)),
    # segmentation mode (5 logit channels, one element a vector): 204 points
    # a pass of 1020 threads
    (4 * 4, 5, 4, 1, (5, 1020, 1, 2 * 16 * (20 + 24))),
    (32 * 32, 5, 4, 1, (5, 1020, 2, 2 * 1024 * (20 + 24))),
    (32 * 32, 5, 2, 1, (5, 1020, 2, 2 * 1024 * (10 + 16))),
])
def test_chain_tile_fits_one_block(points, c, itemsize, vec, expect):
    """K2's geometry: the channel tile is at most 64 bytes a point and a
    multiple of the vector width dividing C; the ping-pong design wherever
    two carries and two tap tables fit 227 KB of shared memory, else the
    single-buffer design."""
    geo = _chain_geometry(points, c, itemsize, vec)
    assert geo == ChainGeometry(*expect)
    assert geo.smem <= 232448


@pytest.mark.parametrize("itemsize,vec", [(2, 8), (4, 4), (2, 1), (4, 1)],
                         ids=["bf16", "float32", "bf16-one-element", "float32-one-element"])
def test_chain_geometry_is_launchable(itemsize, vec):
    """Every geometry the wrapper picks is one csrc/warp.cu launches: a
    tile that divides C into whole vectors, at most 1024 threads and a
    whole number of a point's vectors a pass, 227 KB of shared memory; in
    the ping-pong design also a compiled table size that covers every
    point and uint16 tap indices."""
    for points in (1, 30, 1024, 2000, 3600, 5000, 8040, 20000):
        for c in (vec, 3 * vec, 5 * vec, 256, 4096):
            try:
                geo = _chain_geometry(points, c, itemsize, vec)
            except ValueError:
                assert points * vec * itemsize > 232448
                continue
            nv = geo.c_tile // vec
            assert c % geo.c_tile == 0 and geo.c_tile % vec == 0
            assert geo.c_tile * itemsize <= max(64, vec * itemsize)
            assert 0 < geo.threads <= 1024 and geo.threads % nv == 0
            assert geo.smem <= 232448
            if geo.table_points:
                assert geo.table_points in (1, 2, 4, 8) and points < 1 << 16
                assert geo.table_points * geo.threads >= points
                assert geo.smem == 2 * points * (geo.c_tile * itemsize + 8 + 4 * itemsize)
            else:
                assert geo.smem == points * geo.c_tile * itemsize
                # the single-buffer design only where no tile fits two carries
                assert 2 * points * (vec * itemsize + 8 + 4 * itemsize) > 232448


def test_chain_tile_raises_on_a_grid_too_large():
    with pytest.raises(ValueError, match="does not fit one block"):
        _chain_geometry(135 * 240, 4096, 2, 8)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernels_match_plain_on_card(dtype):
    dev = _card()
    x, grid, grids = _inputs(9, dtype, dev)
    tol = BF16_TOL if dtype == torch.bfloat16 else F32_TOL
    reset_launch_counts()
    for align in (False, True):
        np.testing.assert_allclose(grid_sample_cuda(x, grid, align).float().cpu(),
                                   grid_sample(x, grid, align).float().cpu(), **tol)
    y0 = x[:1, :5, :6].contiguous()
    np.testing.assert_allclose(warp_chain_cuda(y0, grids).float().cpu(),
                               warp_chain_plain(y0, grids).float().cpu(), **tol)
    torch.cuda.synchronize()
    assert launch_counts() == {"grid_sample_cuda": 2, "grid_sample_backward_cuda": 0,
                               "warp_chain_cuda": 1, "resize_quantize_int8_cuda": 0}


def _bits(t):
    return t.view(torch.int32 if t.dtype == torch.float32 else torch.int16)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k1_backward_matches_plain_on_card(dtype):
    """K1-bwd bit-equal to its plain version computed on the CPU (whose
    index_add_ sums in the order the kernel keeps; on the card it is
    atomic), by integer view: random, corner-clamped (every point's taps on
    one pixel) and unaligned (C = 5) cases in both align modes, and the
    index build's workspace route at a (1, 67, 120) grid onto (1, 134, 240,
    16); two launches on one input bit-equal; the autograd wrapper
    launches K1 forward and K1-bwd backward once each."""
    dev = _card()
    rng = np.random.default_rng(17)
    cases = [((2, 13, 17, 72), rng.uniform(-1.2, 1.2, (2, 5, 6, 2))),
             ((2, 13, 17, 72), np.full((2, 5, 6, 2), -1.5)),
             ((2, 13, 17, 5), rng.uniform(-1, 1, (2, 5, 6, 2))),
             ((1, 134, 240, 16), rng.uniform(-1.1, 1.1, (1, 67, 120, 2)))]
    # the workspace route there, shared memory at the others
    assert _library().floodseg_grid_sample_backward_workspace(1, 134, 240, 67, 120) > 0
    assert _library().floodseg_grid_sample_backward_workspace(2, 55, 55, 27, 27) == 0
    for x_shape, grid in cases:
        g = rng.standard_normal(x_shape[:1] + grid.shape[1:3] + x_shape[3:])
        g = torch.from_numpy(g.astype(np.float32)).to(dtype)
        grid = torch.from_numpy(grid.astype(np.float32))
        for align in (False, True):
            want = grid_sample_backward(g, grid, x_shape, align)
            got = grid_sample_backward_cuda(g.to(dev), grid.to(dev), x_shape, align)
            again = grid_sample_backward_cuda(g.to(dev), grid.to(dev), x_shape, align)
            assert torch.equal(_bits(got.cpu()), _bits(want)), (x_shape, align)
            assert torch.equal(_bits(again.cpu()), _bits(got.cpu())), (x_shape, align)
    x = torch.from_numpy(rng.standard_normal((2, 13, 17, 72)).astype(np.float32)).to(dev, dtype)
    x.requires_grad_(True)
    reset_launch_counts()
    grid = torch.from_numpy(rng.uniform(-1, 1, (2, 5, 1, 2)).astype(np.float32)).to(dev)
    grid_sample_autograd(x, grid).float().sum().backward()
    torch.cuda.synchronize()
    assert launch_counts()["grid_sample_cuda"] == 1
    assert launch_counts()["grid_sample_backward_cuda"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k1_backward_takes_grad_out_at_an_odd_offset_on_card(dtype):
    """K1-bwd on a C = 5 grad_out that is a contiguous view at an odd
    element offset (as the backward of a stack or an unbind may hand it
    over; not 16-byte aligned), on both index routes: bit-equal to its
    plain version on the CPU."""
    dev = _card()
    rng = np.random.default_rng(18)
    for x_shape, gh, gw in (((2, 13, 17, 5), 5, 6), ((1, 134, 240, 5), 67, 120)):
        b = x_shape[0]
        flat = torch.from_numpy(rng.standard_normal(1 + b * gh * gw * 5).astype(np.float32))
        g = flat.to(dev, dtype)[1:].view(b, gh, gw, 5)
        assert g.is_contiguous() and g.data_ptr() % 16 != 0
        grid = torch.from_numpy(rng.uniform(-1.1, 1.1, (b, gh, gw, 2)).astype(np.float32))
        for align in (False, True):
            want = grid_sample_backward(g.cpu(), grid, x_shape, align)
            got = grid_sample_backward_cuda(g, grid.to(dev), x_shape, align)
            assert torch.equal(_bits(got.cpu()), _bits(want)), (x_shape, align)


@pytest.mark.cuda
def test_kernels_take_unaligned_channel_counts_on_card():
    """C = 5 (segmentation mode warps logits): no 16-byte vectors, one
    element at a time."""
    dev = _card()
    x, grid, grids = _inputs(10, torch.float32, dev)
    x5 = x[..., :5].contiguous()
    np.testing.assert_allclose(grid_sample_cuda(x5, grid, True).cpu(),
                               grid_sample(x5, grid, True).cpu(), **F32_TOL)
    y0 = x5[:1, :5, :6].contiguous()
    np.testing.assert_allclose(warp_chain_cuda(y0, grids).cpu(),
                               warp_chain_plain(y0, grids).cpu(), **F32_TOL)


def _corner_grids(steps, gh, gw):
    """Every point clamped to the top-left corner: its four taps coincide."""
    return torch.full((steps, 1, gh, gw, 2), -1.1)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k2_both_designs_match_plain_on_card(dtype):
    """K2 equals its plain version to the bit in both designs: the ping-pong
    one on a 5x6 grid, the single-buffer one on the reference's 67x120
    grid; each on random grids at +-1.1 and on the corner grid."""
    dev = _card()
    rng = np.random.default_rng(16)
    for (gh, gw, c), pingpong in (((5, 6, 72), True), ((67, 120, 16), False)):
        y0 = torch.from_numpy(rng.standard_normal((1, gh, gw, c)).astype(np.float32))
        rand = torch.from_numpy(rng.uniform(-1.1, 1.1, (4, 1, gh, gw, 2)).astype(np.float32))
        itemsize = torch.empty((), dtype=dtype).element_size()
        geo = _chain_geometry(gh * gw, c, itemsize, 16 // itemsize)
        assert bool(geo.table_points) is pingpong
        for grids in (rand, _corner_grids(4, gh, gw)):
            y, g = y0.to(dev, dtype), grids.to(dev)
            np.testing.assert_array_equal(warp_chain_cuda(y, g).float().cpu().numpy(),
                                          warp_chain_plain(y, g).float().cpu().numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernels_at_the_vit_shapes_match_plain_on_card(dtype):
    """The ViT-B/32 path's shapes: K1 up-samples a (1, 16, 16, 768) token
    map to a 32x32 grid in both align modes; K2 chains 23 warps on (1, 32,
    32, 768), 24 blocks of a 32-channel tile. Both bit-equal to their plain
    versions."""
    dev = _card()
    rng = np.random.default_rng(17)
    x = torch.from_numpy(rng.standard_normal((1, 16, 16, 768)).astype(np.float32))
    grid = torch.from_numpy(rng.uniform(-1.1, 1.1, (1, 32, 32, 2)).astype(np.float32))
    grids = torch.from_numpy(rng.uniform(-1.1, 1.1, (23, 1, 32, 32, 2)).astype(np.float32))
    x, grid, grids = x.to(dev, dtype), grid.to(dev), grids.to(dev)
    for align in (False, True):
        np.testing.assert_array_equal(grid_sample_cuda(x, grid, align).float().cpu().numpy(),
                                      grid_sample(x, grid, align).float().cpu().numpy())
    y0 = grid_sample(x, grid, False)
    np.testing.assert_array_equal(warp_chain_cuda(y0, grids).float().cpu().numpy(),
                                  warp_chain_plain(y0, grids).float().cpu().numpy())


@pytest.mark.cuda
def test_card_wrappers_raise_and_never_reroute():
    dev = _card()
    x, grid, grids = _inputs(11, torch.float32, dev)
    with pytest.raises(ValueError, match="both must be on one CUDA device"):
        grid_sample_cuda(x, grid.cpu())
    big = torch.zeros((1, 135, 240, 4096), dtype=torch.bfloat16, device=dev)
    big_grids = torch.zeros((2, 1, 135, 240, 2), device=dev)
    with pytest.raises(ValueError, match="does not fit one block"):
        warp_chain_cuda(big, big_grids)


# ------------------------------------------------------------------- K1

# every shape the paths give K1: (name, B * gh * gw points, C, B * H * W pixels of x)
_K1_PATHS = [
    ("pspnet-predict", 32 * 32, 4096, 65 * 65),
    ("deeplabv3-predict", 32 * 32, 2048, 64 * 64),
    ("vit-predict", 32 * 32, 768, 16 * 16),
    ("crop-head", 27 * 27, 4096, 55 * 55),
    ("crop-key-resample", 67 * 120, 4096, 55 * 55),
    ("train-head", 2 * 27 * 27, 4096, 2 * 55 * 55),
    ("train-step", 2 * 27 * 27, 4096, 2 * 27 * 27),
    ("deeplabv3-train-head", 2 * 27 * 27, 2048, 2 * 55 * 55),
    ("deeplabv3-train-step", 2 * 27 * 27, 2048, 2 * 27 * 27),
    ("vit-train-head", 2 * 26 * 26, 768, 2 * 13 * 13),
    ("vit-train-step", 2 * 26 * 26, 768, 2 * 26 * 26),
    ("segmentation-logits", 2 * 27 * 27, 5, 2 * 55 * 55),
]
# (itemsize, elements a vector): bf16 and float32 vectors, and the
# one-element route (C * itemsize no multiple of 16, or an unaligned x)
_K1_ROUTES = {"bf16": (2, 8), "float32": (4, 4), "bf16-one-element": (2, 1),
              "float32-one-element": (4, 1)}


def _k1_cover(geo: SampleGeometry, points: int, nv: int):
    """Replay csrc/warp.cu::grid_sample_kernel's index arithmetic for every
    thread of every block: how many times each (point, vector) is written,
    and how many times each point's tap-table entry is built for each
    channel chunk. Also checks that a thread reads only a table entry its
    block built."""
    rows = geo.threads // geo.lanes
    bid = np.arange(geo.tiles * geo.chunks)[:, None]
    t = np.arange(geo.threads)[None, :]
    tile = bid // geo.chunks
    chunk = np.broadcast_to(bid - tile * geo.chunks, (bid.shape[0], geo.threads))
    row, lane = t // geo.lanes, t % geo.lanes
    q0 = tile * rows
    built = t < np.minimum(rows, points - q0)
    table = np.zeros((points, geo.chunks), np.int64)
    np.add.at(table, ((q0 + t)[built], chunk[built]), 1)
    v = chunk * geo.lanes + lane
    live = (v < nv) & (row < points - q0)
    assert (row < np.minimum(rows, points - q0))[live].all()
    writes = np.zeros((points, nv), np.int64)
    np.add.at(writes, (np.broadcast_to(q0 + row, live.shape)[live], v[live]), 1)
    return writes, table


# every path's shape at its batch and at twice it, on every route it can take
_K1_CASES = [(path, batch, route) for path in _K1_PATHS for batch in (1, 2)
             for route, (itemsize, v) in _K1_ROUTES.items()
             if v == 1 or (path[2] * itemsize) % 16 == 0]


@pytest.mark.parametrize("path,batch,route", _K1_CASES,
                         ids=[f"{p[0]}-b{b}-{r}" for p, b, r in _K1_CASES])
def test_k1_geometry_covers_every_point_and_channel_once(path, batch, route):
    """K1's geometry at every path's shape (and at twice its batch), in both
    dtypes and on the one-element route: a block's threads and its tap
    table within the card's limits, the grid within 2**31 - 1 blocks, and
    every output point and channel vector written exactly once, each
    point's table entry built once for each chunk."""
    _, points, c, pixels = path
    itemsize, v = _K1_ROUTES[route]
    points, pixels = points * batch, pixels * batch
    nv = c // v
    geo = _sample_geometry(points, nv, pixels)
    rows = geo.threads // geo.lanes
    assert 0 < geo.lanes <= geo.threads <= _SAMPLE_THREADS <= 1024
    assert geo.threads % geo.lanes == 0 and geo.lanes <= 32
    assert geo.chunks == -(-nv // geo.lanes) and geo.chunks * geo.lanes - nv < geo.chunks
    assert geo.tiles == -(-points // rows) and geo.tiles * geo.chunks < 2 ** 31
    assert rows * 32 <= 48 * 1024  # the tap table: an int4 and a float4 a point
    assert geo.stream == (points <= pixels)
    writes, table = _k1_cover(geo, points, nv)
    assert (writes == 1).all() and (table == 1).all()


@pytest.mark.parametrize("name,points,c,pixels,itemsize,expect", [
    # predict, bf16: a warp on 32 vectors (512 bytes) of a point, 8 points a block
    ("pspnet-predict", 32 * 32, 4096, 65 * 65, 2, SampleGeometry(32, 256, 16, 128, True)),
    ("deeplabv3-predict", 32 * 32, 2048, 64 * 64, 2, SampleGeometry(32, 256, 8, 128, True)),
    ("vit-predict", 32 * 32, 768, 16 * 16, 2, SampleGeometry(32, 256, 3, 128, False)),
    ("crop-head", 27 * 27, 4096, 55 * 55, 2, SampleGeometry(32, 256, 16, 92, True)),
    ("crop-key-resample", 67 * 120, 4096, 55 * 55, 2, SampleGeometry(32, 256, 16, 1005, False)),
    # training, float32
    ("train-head", 2 * 27 * 27, 4096, 2 * 55 * 55, 4, SampleGeometry(32, 256, 32, 183, True)),
    ("train-step", 2 * 27 * 27, 4096, 2 * 27 * 27, 4, SampleGeometry(32, 256, 32, 183, True)),
    ("vit-train-head", 2 * 26 * 26, 768, 2 * 13 * 13, 4,
     SampleGeometry(32, 256, 6, 169, False)),
    # segmentation logits, C = 5: the one-element route, 51 points a block
    ("segmentation-logits", 2 * 27 * 27, 5, 2 * 55 * 55, 4,
     SampleGeometry(5, 255, 1, 29, True)),
])
def test_k1_geometry_at_the_path_shapes(name, points, c, pixels, itemsize, expect):
    """The geometry K1 takes at the paths' shapes: up-sampling grids (more
    points than x has pixels) read x with the default policy, since each
    pixel is read by several points."""
    v = 16 // itemsize if (c * itemsize) % 16 == 0 else 1
    assert _sample_geometry(points, c // v, pixels) == expect


def test_k1_geometry_raises_past_int32():
    with pytest.raises(ValueError, match="nothing to sample"):
        _sample_geometry(0, 8, 1)
    with pytest.raises(ValueError, match="more than 2147483647"):
        _sample_geometry(2 ** 31, 512, 1)
    with pytest.raises(ValueError, match="more than 2147483647"):
        _sample_geometry(8, 512, 2 ** 31)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k1_tile_edges_match_plain_on_card(dtype):
    """K1 bit-equal, by integer view, to its plain version on the CPU where
    its tiles and chunks are ragged: 27x27 (729 points) at batch 1 and 2
    (a tile crosses the first image's end), the 67x120 grid (8040 points),
    13x13 onto (2, 26, 26, 768) (C = 768: 96 bf16 or 192 float32 vectors, not
    a multiple of the chunk), C = 72, and C = 5 at an odd element offset
    (the one-element route); random grids and the corner grid (a point's
    four taps on one pixel), both align modes."""
    dev = _card()
    rng = np.random.default_rng(19)
    cases = [((1, 55, 55, 128), (27, 27)), ((2, 55, 55, 128), (27, 27)),
             ((1, 55, 55, 16), (67, 120)), ((2, 26, 26, 768), (13, 13)),
             ((2, 13, 13, 72), (26, 26)), ((2, 13, 13, 5), (26, 26))]
    for x_shape, hw in cases:
        b = x_shape[0]
        flat = torch.from_numpy(rng.standard_normal(1 + int(np.prod(x_shape))).astype(np.float32))
        x = flat[1:].view(x_shape) if x_shape[-1] == 5 else flat[:-1].view(x_shape)
        x = x.to(dtype)
        rand = rng.uniform(-1.2, 1.2, (b,) + hw + (2,))
        for grid in (rand, np.full((b,) + hw + (2,), -1.5)):
            grid = torch.from_numpy(grid.astype(np.float32))
            for align in (False, True):
                xd = x.to(dev) if x_shape[-1] != 5 else torch.cat(
                    [x.new_zeros(1).to(dev), x.reshape(-1).to(dev)])[1:].view(x_shape)
                assert (xd.data_ptr() % 16 != 0) == (x_shape[-1] == 5)
                got = grid_sample_cuda(xd, grid.to(dev), align)
                want = grid_sample(x.contiguous(), grid, align)
                assert torch.equal(_bits(got.cpu()), _bits(want)), (x_shape, hw, align)


# ------------------------------------------------------------------- K3

def _k3_inputs(seed, dtype, device="cpu", shape=(2, 7, 9, 48)):
    """x (B, h, w, C) and a float32 scale from its absmax, as the
    flow-predict path makes it."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32) * 3)
    x = x.to(device, dtype)
    return x, (x.float().abs().amax() / 127).to(device)


def test_k3_wrapper_routes_cpu_tensors_to_plain():
    reset_launch_counts()
    for dtype in (torch.float32, torch.bfloat16):
        x, s = _k3_inputs(12, dtype)
        for align in (True, False):
            got = resize_quantize_int8_cuda(x, s, (13, 5), align)
            assert got.dtype == torch.int8 and got.shape == (2, 13, 5, 48)
            np.testing.assert_array_equal(
                got.numpy(), resize_quantize_int8_plain(x, s, (13, 5), align).numpy())
    assert launch_counts()["resize_quantize_int8_cuda"] == 0


def test_k3_wrapper_rejects_what_the_kernel_does_not_take():
    x, s = _k3_inputs(13, torch.float32)
    with pytest.raises(ValueError, match="must be \\(B, h, w, C\\)"):
        resize_quantize_int8_cuda(x[0], s, (9, 9))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        resize_quantize_int8_cuda(x.half(), s, (9, 9))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        resize_quantize_int8_cuda(x.double(), s, (9, 9))
    for bad in (s.double(), torch.stack([s, s]), 0.5):
        with pytest.raises(TypeError, match="scale must be a float32 tensor"):
            resize_quantize_int8_cuda(x, bad, (9, 9))
    with pytest.raises(ValueError, match="bad output size"):
        resize_quantize_int8_cuda(x, s, (0, 9))
    with pytest.raises(ValueError, match="contiguous"):
        resize_quantize_int8_cuda(x.transpose(1, 2), s, (9, 9))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k3_matches_plain_on_card(dtype):
    """Equal int8 outputs: 16-channel vectors (C = 48) and one channel a
    thread (C = 37), up- and downsampling, both align modes, and values far
    past the clip range."""
    dev = _card()
    reset_launch_counts()
    launches = 0
    for shape, out_hw in (((2, 7, 9, 48), (13, 17)), ((1, 16, 16, 48), (5, 31)),
                          ((3, 6, 5, 37), (11, 9))):
        x, s = _k3_inputs(14, dtype, dev, shape)
        for align in (True, False):
            for scale in (s, s / 50):  # s / 50 saturates most lanes
                got = resize_quantize_int8_cuda(x, scale, out_hw, align)
                np.testing.assert_array_equal(
                    got.cpu().numpy(),
                    resize_quantize_int8_plain(x, scale, out_hw, align).cpu().numpy())
                launches += 1
    torch.cuda.synchronize()
    assert launch_counts()["resize_quantize_int8_cuda"] == launches


@pytest.mark.cuda
def test_k3_wrapper_raises_and_never_reroutes_on_card():
    dev = _card()
    x, s = _k3_inputs(15, torch.bfloat16, dev)
    with pytest.raises(ValueError, match="both must be on one CUDA device"):
        resize_quantize_int8_cuda(x, s.cpu(), (9, 9))
    with pytest.raises(ValueError, match="both must be on one CUDA device"):
        resize_quantize_int8_cuda(x.cpu(), s, (9, 9))


def _finite_bf16_values() -> np.ndarray:
    """Every finite bf16 value (65,280), as float32."""
    v = (np.arange(1 << 16, dtype=np.uint32) << 16).view(np.float32)
    return v[np.isfinite(v)]


def _fma32(a, b, c) -> np.ndarray:
    """float32 fma(a, b, c), rounded once: a * b is exact in float64, the
    sum and its error are exact as a float64 pair (TwoSum), and a float64
    sum that lands on a float32 midpoint is resolved by the error's sign."""
    p = a.astype(np.float64) * b.astype(np.float64)
    c = c.astype(np.float64)
    s = p + c
    t = s - c
    err = (p - (s - t)) + (c - t)
    f = s.astype(np.float32)
    up, down = np.nextafter(f, np.float32(np.inf)), np.nextafter(f, np.float32(-np.inf))
    d = s - f.astype(np.float64)
    f = np.where((d > 0) & (2 * d == up - f.astype(np.float64)) & (err > 0), up, f)
    return np.where((d < 0) & (-2 * d == f.astype(np.float64) - down) & (err < 0), down, f)


def _kernel_quantize(v: np.ndarray, s: np.float32) -> np.ndarray:
    """csrc/resize.cu's Quantizer, step by step in float32."""
    r = np.float32(1.0 / np.float64(s))           # __frcp_rn
    b = np.minimum(np.float32(127) * s, np.finfo(np.float32).max)
    v = np.minimum(np.maximum(v, -b), b)
    q0 = v * r
    q = _fma32(_fma32(-q0, np.full_like(v, s), v), np.full_like(v, r), q0)
    bits = (q + np.float32(1.5 * 2 ** 23)).view(np.uint32)
    return (bits & 0xFF).astype(np.uint8).view(np.int8)  # the low byte


# scales: a flow-predict stack's and a fiftieth of it, the smallest the
# quantizer allows, one that puts many values on half-integers, far ends of
# the range, and two at which v * (1 / s) alone misrounds a bf16 value (a
# seeded search found them), so the correction step is needed
_SCALES = {"stack": 3.1e-2, "stack/50": 6.2e-4, "FLT_MIN": float(np.finfo(np.float32).tiny),
           "2**-7": 2.0 ** -7, "1e-30": 1e-30, "3e30": 3e30,
           "0x3e57e753": 0.21084336936473846, "0x4215e50e": 37.47368621826172}


@pytest.mark.parametrize("scale", list(_SCALES.values()), ids=list(_SCALES))
def test_k3_quantize_identity(scale):
    """K3's quantize (reciprocal once, Markstein's correction step, clamp
    to +-127 * s before it, rint by adding 1.5 * 2**23, the low byte)
    equals clip(rint(v / s), +-127) with IEEE division on every finite bf16
    value, as quant.quantize_with_scale computes it."""
    v = _finite_bf16_values()
    s = np.float32(scale)
    ref = quantize_with_scale(torch.from_numpy(v), torch.tensor(s)).numpy()
    with np.errstate(over="ignore"):
        got = _kernel_quantize(v, s)
    np.testing.assert_array_equal(got, ref)


def test_k3_bf16_round_identity():
    """The kernel's bf16 round, (u + 0x7fff + ((u >> 16) & 1)) & 0xffff0000
    on the float's bits, equals the cast to bf16 on every non-NaN float32
    here: seeded bit patterns of every exponent, the bf16 midpoints and
    their neighbours, and the largest finite values."""
    rng = np.random.default_rng(1)
    mids = (rng.integers(0, 1 << 16, 4096, dtype=np.uint32) << 16) | 0x8000
    u = np.concatenate([rng.integers(0, 1 << 32, 1 << 18, dtype=np.uint64).astype(np.uint32),
                        mids, mids - 1, mids + 1,
                        np.array([0x7F7FFFFF, 0x7F7F8000, 0xFF7FFFFF, 0x7F800000],
                                 dtype=np.uint32)])
    u = u[~np.isnan(u.view(np.float32))]
    got = ((u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000).view(np.float32)
    ref = torch.from_numpy(u.view(np.float32)).to(torch.bfloat16).float().numpy()
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("make,vec", [
    (lambda: torch.zeros((24, 32, 32, 4096), dtype=torch.bfloat16), True),  # main path
    (lambda: torch.zeros((3, 6, 5, 37), dtype=torch.bfloat16), False),       # C = 37
    (lambda: torch.zeros(2 * 7 * 9 * 48 + 1)[1:].view(2, 7, 9, 48), False),  # 4-byte offset
], ids=["main-path", "c37", "unaligned-view"])
def test_k3_vector_path(make, vec):
    """Which instantiation a shape takes: 16 channels a thread only for C a
    multiple of 16 at a 16-byte aligned address."""
    assert vector_path(make()) is vec


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k3_every_bf16_value_on_card(dtype):
    """Every finite bf16 value through an identity resize, so each value's
    quantize is checked on its own, at the scales of
    test_k3_quantize_identity: equal int8 outputs."""
    dev = _card()
    x = torch.from_numpy(_finite_bf16_values()).reshape(1, 1, -1, 16).to(dev, dtype)
    hw = tuple(x.shape[1:3])
    for scale in _SCALES.values():
        s = torch.tensor(scale, dtype=torch.float32, device=dev)
        np.testing.assert_array_equal(
            resize_quantize_int8_cuda(x, s, hw, True).cpu().numpy(),
            resize_quantize_int8_plain(x, s, hw, True).cpu().numpy())
