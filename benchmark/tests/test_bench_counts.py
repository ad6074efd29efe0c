"""The yardstick's counters against values worked by hand."""

import torch

from benchmark.core import counts
from benchmark.reference.ops import FlopCounter, Params, conv


def test_conv_flops_by_hand():
    # one 3x3 convolution 8 -> 16 channels on a 2x10x12 map, padding 1:
    # 2 * (2 * 10 * 12 outputs) * 16 * 8 * 9 multiply-adds = 552960
    counter = FlopCounter()
    w = torch.empty((16, 8, 3, 3), device="meta", requires_grad=True)
    x = torch.empty((2, 8, 10, 12), device="meta")
    conv(Params({"c.weight": w}, counter), "c", x, padding=1)
    assert counter.forward == 552960
    assert counter.backward == 552960      # the weight's gradient; x needs none
    y = torch.empty((2, 8, 10, 12), device="meta", requires_grad=True)
    counter2 = FlopCounter()
    conv(Params({"c.weight": w}, counter2), "c", y, padding=1, stride=2)
    # stride 2: 5x6 outputs
    assert counter2.forward == 2 * 2 * 5 * 6 * 16 * 8 * 9
    assert counter2.step == 3 * counter2.forward


def test_warp_bytes_by_hand():
    # a 4x4 map of 8 bf16 channels, one output point at the exact centre of
    # pixel (1, 2) with align_corners=True: x = 2 -> gx = 2/3*2-1, y = 1 ->
    # gy = 1/3*2-1. Taps (1,2), (1,3), (2,2), (2,3): 4 pixels touched.
    grid = torch.tensor([[[[2 / 3 * 2 - 1, 1 / 3 * 2 - 1]]]])
    b = counts.warp_bytes((1, 4, 4, 8), 2, grid, align_corners=True)
    assert b == 4 * 8 * 2 + 2 * 4 + 1 * 8 * 2
    # the same point at the bottom-right corner clamps: every tap is (3, 3)
    corner = torch.tensor([[[[1.0, 1.0]]]])
    assert counts.warp_bytes((1, 4, 4, 8), 2, corner, True) == 1 * 8 * 2 + 8 + 16


def test_chain_bytes_by_hand():
    # a 2x3 grid of 4 float32 channels, 5 steps: first map read (96 B), 5
    # grids (5 * 6 * 2 * 4 = 240 B), 6 maps written (576 B)
    assert counts.chain_bytes(2, 3, 4, 4, 5) == 96 + 240 + 576
