"""Dilated ResNet trunks (He et al., arXiv:1512.03385), output stride 8.

Two published layouts:

- the deep-base trunk of PSPNet's ``model/resnet.py`` (``deep_base``): a
  stem of three 3x3 convolutions (64, 64, 128 channels, the first at
  stride 2) as ``layer0.{0,3,6}`` with BN at ``layer0.{1,4,7}``, every block
  of layer3 at dilation 2 and of layer4 at dilation 4;
- torchvision's trunk under ``replace_stride_with_dilation=[False, True,
  True]``: a 7x7 stride-2 stem ``conv1``/``bn1``, the first block of a
  dilated stage at the previous stage's dilation (layer3 [1, 2, 2, ...],
  layer4 [2, 4, 4]).

Both max-pool 3/2/1 after the stem; layer2 has stride 2, layer3 and layer4
stride 1 with a 1x1 downsample on the first block.
"""

from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from benchmark.reference.ops import Params, bn, conv, conv_bn_relu

DEPTH_BLOCKS = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3), 152: (3, 8, 36, 3)}
EXPANSION = 4


def stage_plan(depth: int, deep_base: bool) -> List[Tuple[int, int, List[int]]]:
    """(planes, stride of the first block, dilation of each block) a stage."""
    blocks = DEPTH_BLOCKS[depth]
    if deep_base:
        d3, d4 = [2] * blocks[2], [4] * blocks[3]
    else:
        d3 = [1] + [2] * (blocks[2] - 1)
        d4 = [2] + [4] * (blocks[3] - 1)
    return [(64, 1, [1] * blocks[0]), (128, 2, [1] * blocks[1]), (256, 1, d3), (512, 1, d4)]


def spec(prefix: str, depth: int, deep_base: bool) -> List[Tuple[str, tuple, str]]:
    """(name, shape, kind) of every tensor of the trunk; kinds: conv, bn,
    bn_last (a residual branch's last BN)."""
    out = []

    def add_conv(name, cout, cin, k):
        out.append((f"{prefix}{name}.weight", (cout, cin, k, k), "conv"))

    def add_bn(name, c, kind="bn"):
        out.append((f"{prefix}{name}", (c,), kind))

    if deep_base:
        for i, (cout, cin) in enumerate(((64, 3), (64, 64), (128, 64))):
            add_conv(f"layer0.{3 * i}", cout, cin, 3)
            add_bn(f"layer0.{3 * i + 1}", cout)
        inplanes = 128
    else:
        add_conv("conv1", 64, 3, 7)
        add_bn("bn1", 64)
        inplanes = 64
    for li, (planes, stride, dilations) in enumerate(stage_plan(depth, deep_base), 1):
        for bi in range(len(dilations)):
            name = f"layer{li}.{bi}"
            add_conv(f"{name}.conv1", planes, inplanes, 1)
            add_bn(f"{name}.bn1", planes)
            add_conv(f"{name}.conv2", planes, planes, 3)
            add_bn(f"{name}.bn2", planes)
            add_conv(f"{name}.conv3", planes * EXPANSION, planes, 1)
            add_bn(f"{name}.bn3", planes * EXPANSION, "bn_last")
            if bi == 0 and (stride != 1 or inplanes != planes * EXPANSION):
                add_conv(f"{name}.downsample.0", planes * EXPANSION, inplanes, 1)
                add_bn(f"{name}.downsample.1", planes * EXPANSION)
            inplanes = planes * EXPANSION
    return out


def bottleneck(p: Params, name: str, x: torch.Tensor, stride: int, dilation: int,
               train: bool) -> torch.Tensor:
    y = conv_bn_relu(p, f"{name}.conv1", f"{name}.bn1", x, train)
    y = conv_bn_relu(p, f"{name}.conv2", f"{name}.bn2", y, train, stride=stride,
                     padding=dilation, dilation=dilation)
    y = bn(p, f"{name}.bn3", conv(p, f"{name}.conv3", y), train)
    if f"{name}.downsample.0.weight" in p:
        x = bn(p, f"{name}.downsample.1", conv(p, f"{name}.downsample.0", x, stride=stride),
               train)
    return F.relu(y + x)


def features(p: Params, prefix: str, x: torch.Tensor, depth: int, deep_base: bool,
             train: bool) -> Dict[str, torch.Tensor]:
    """NCHW images -> {"c2", "c3", "c4"} (layer2, layer3 and layer4
    outputs)."""
    if deep_base:
        for i in range(3):
            x = conv_bn_relu(p, f"{prefix}layer0.{3 * i}", f"{prefix}layer0.{3 * i + 1}", x,
                             train, stride=2 if i == 0 else 1, padding=1)
    else:
        x = conv_bn_relu(p, f"{prefix}conv1", f"{prefix}bn1", x, train, stride=2, padding=3)
    x = F.max_pool2d(x, 3, 2, 1)
    out = {}
    for li, (_, stride, dilations) in enumerate(stage_plan(depth, deep_base), 1):
        for bi, dilation in enumerate(dilations):
            x = bottleneck(p, f"{prefix}layer{li}.{bi}", x, stride if bi == 0 else 1,
                           dilation, train)
        if li > 1:
            out[f"c{li}"] = x
    return out
