"""Deep-base ResNet trunk with semseg dilation (NCHW inside).

Counterpart of floodseg_tpu/models/resnet.py for the PSPNet backbone
(``deep_base=True``, ``semseg_dilation=True``): a three-conv stem, then
max-pool 3/2/1; every block of layer3 at dilation 2 and of layer4 at
dilation 4, both at stride 1. Module names are the reference's torch names
(``layer0`` Sequential for the stem, ``layerX.Y.convZ/bnZ/downsample``).
"""

from typing import Dict

import torch
import torch.nn as nn

from floodseg_tpu_torch.models.layers import BatchNorm2d, Conv2d, MaxPool

DEPTH_BLOCKS = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3), 152: (3, 8, 36, 3)}


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 dilation: int = 1, has_downsample: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        out = planes * self.expansion
        self.conv1 = Conv2d(inplanes, planes, 1, bias=False, dtype=dtype)
        self.bn1 = BatchNorm2d(planes, dtype)
        self.conv2 = Conv2d(planes, planes, 3, stride=stride, padding=dilation,
                            dilation=dilation, bias=False, dtype=dtype)
        self.bn2 = BatchNorm2d(planes, dtype)
        self.conv3 = Conv2d(planes, out, 1, bias=False, dtype=dtype)
        self.bn3 = BatchNorm2d(out, dtype)
        self.relu = nn.ReLU(inplace=True)
        self.downsample = None
        if has_downsample:
            self.downsample = nn.Sequential(
                Conv2d(inplanes, out, 1, stride=stride, bias=False, dtype=dtype),
                BatchNorm2d(out, dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.relu(self.bn1(self.conv1(x)))
        y = self.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        residual = x if self.downsample is None else self.downsample(x)
        return self.relu(y + residual)


class ResNetFeatures(nn.Module):
    """Stem + layer1..4 -> {"c2", "c3", "c4"} (layer2/3/4 outputs, NCHW)."""

    def __init__(self, depth: int = 50, dtype: torch.dtype = torch.float32):
        super().__init__()
        blocks = DEPTH_BLOCKS[depth]
        self.layer0 = nn.Sequential(
            Conv2d(3, 64, 3, stride=2, padding=1, bias=False, dtype=dtype),
            BatchNorm2d(64, dtype), nn.ReLU(inplace=True),
            Conv2d(64, 64, 3, padding=1, bias=False, dtype=dtype),
            BatchNorm2d(64, dtype), nn.ReLU(inplace=True),
            Conv2d(64, 128, 3, padding=1, bias=False, dtype=dtype),
            BatchNorm2d(128, dtype), nn.ReLU(inplace=True),
            MaxPool(3, 2, 1))
        inplanes = 128
        stages = ((64, 1, 1), (128, 2, 1), (256, 1, 2), (512, 1, 4))
        for li, ((planes, stride, dilation), n) in enumerate(zip(stages, blocks), 1):
            layer = []
            for i in range(n):
                layer.append(Bottleneck(
                    inplanes, planes, stride=stride if i == 0 else 1,
                    dilation=dilation,
                    has_downsample=(i == 0 and (stride != 1
                                                or inplanes != planes * 4)),
                    dtype=dtype))
                inplanes = planes * 4
            setattr(self, f"layer{li}", nn.Sequential(*layer))

    def features(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        x = self.layer1(self.layer0(x))
        c2 = self.layer2(x)
        c3 = self.layer3(c2)
        return {"c2": c2, "c3": c3, "c4": self.layer4(c3)}

    forward = features
