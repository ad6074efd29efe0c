"""The kernels' wrappers (floodseg_tpu_torch/ops/warp_kernels.py and
ops/resize_kernels.py).

On the CPU: the wrappers check what their kernels take and then compute
the plain versions. On the card (``cuda`` marker; skipped without one):
K1, K2 and K3 against their plain versions. This file imports no JAX, so the
card-only tests run on a machine without it:

    python -m pytest --noconftest tests/test_torch_kernels.py -q -m cuda

(the repository's conftest files set JAX up; ``--noconftest`` skips them).
"""

import numpy as np
import pytest
import torch

from floodseg_tpu_torch.ops import (
    grid_sample,
    grid_sample_cuda,
    launch_counts,
    reset_launch_counts,
    resize_quantize_int8_cuda,
    resize_quantize_int8_plain,
    warp_chain_cuda,
    warp_chain_plain,
)
from floodseg_tpu_torch.ops.warp_kernels import _chain_tile

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
    assert launch_counts() == {"grid_sample_cuda": 0, "warp_chain_cuda": 0,
                               "resize_quantize_int8_cuda": 0}


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


@pytest.mark.parametrize("points,c,itemsize,vec,expect", [
    (32 * 32, 4096, 2, 8, (32, 8)),     # the flow-predict chain: 128 blocks
    (32 * 32, 4096, 4, 4, (16, 8)),
    (67 * 120, 256, 2, 8, (8, 16)),     # the reference's 1072x1920 grid
    (67 * 120, 256, 4, 4, (4, 16)),
    (4 * 4, 5, 4, 1, (5, 1)),           # segmentation mode: 5 logit channels
])
def test_chain_tile_fits_one_block(points, c, itemsize, vec, expect):
    """K2's channel tile: at most 64 bytes a point, a multiple of the vector
    width dividing C, small enough for 227 KB of shared memory and the
    register staging."""
    ct, items = _chain_tile(points, c, itemsize, vec)
    assert (ct, items) == expect
    assert points * ct * itemsize <= 232448


def test_chain_tile_raises_on_a_grid_too_large():
    with pytest.raises(ValueError, match="does not fit one block"):
        _chain_tile(135 * 240, 4096, 2, 8)


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
    assert launch_counts() == {"grid_sample_cuda": 2, "warp_chain_cuda": 1,
                               "resize_quantize_int8_cuda": 0}


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
