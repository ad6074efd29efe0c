"""DeepLabV3 (ResNet + ASPP).

Counterpart of floodseg_tpu/models/deeplabv3.py: the torchvision-style
trunk (7x7 stem, layer3 and layer4 dilated torchvision's way, stride 8),
the DeepLabHead (ASPP with rates 12, 24, 36 and an image-pooling branch,
projected 1280 -> 256, then a 3x3 256 -> 256, BN, ReLU and a 1x1 to the
classes) and, with ``with_aux``, the FCNHead on layer3 (1024 -> 256 ->
classes). ``encode`` returns the trunk's 2048-channel c4 and ``decode``
runs the DeepLabHead, the flow path's split; ``forward`` upsamples with
align_corners=False, as torchvision does, and in training mode also
returns the FCNHead's logits on layer3 (``aux``), resized the same way, as
the JAX module's ``__call__(train=True)`` does.

The module tree carries torchvision's ``deeplabv3_resnet50`` key names
(``backbone.{conv1,bn1,layerX.Y.*}``, ``classifier.0.convs.{0..4}``,
``classifier.0.project``, ``classifier.{1,2,4}``, ``aux_classifier.{0,1,4}``),
so ``models/convert.py``'s output strict-loads into it. The ASPP
projection's dropout (0.5) and the FCNHead's (0.1) are the port's element
``Dropout`` (flax's ``nn.Dropout`` without broadcast dims), which draws
only from an explicit generator; the identity in eval.

Public methods take and return NHWC tensors, as the JAX package does.
"""

from typing import Sequence

import torch
import torch.nn as nn

from floodseg_tpu_torch.models.layers import BatchNorm2d, Conv2d, Dropout
from floodseg_tpu_torch.models.pspnet import _nchw, _nhwc
from floodseg_tpu_torch.models.resnet import ResNetFeatures
from floodseg_tpu_torch.ops.pool import global_avg_pool
from floodseg_tpu_torch.ops.resize import resize_bilinear


class GlobalAvgPool(nn.Module):
    """``nn.AdaptiveAvgPool2d(1)`` through ops.pool (NCHW in and out)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _nchw(global_avg_pool(_nhwc(x)))


class ASPPPooling(nn.Sequential):
    """Mean over H and W, 1x1 conv, BN, ReLU (indices 0-3), resized back to
    the input's size with align_corners=False."""

    def __init__(self, in_ch: int, out_ch: int, dtype: torch.dtype):
        super().__init__(GlobalAvgPool(),
                         Conv2d(in_ch, out_ch, 1, bias=False, dtype=dtype),
                         BatchNorm2d(out_ch, dtype), nn.ReLU(inplace=True))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, w = x.shape[-2:]
        y = super().forward(x)
        return _nchw(resize_bilinear(_nhwc(y), (h, w), align_corners=False))


def _conv_bn_relu(in_ch: int, out_ch: int, k: int, dilation: int,
                  dtype: torch.dtype) -> nn.Sequential:
    return nn.Sequential(
        Conv2d(in_ch, out_ch, k, padding=dilation if k == 3 else 0,
               dilation=dilation, bias=False, dtype=dtype),
        BatchNorm2d(out_ch, dtype), nn.ReLU(inplace=True))


class ASPP(nn.Module):
    """``convs``: the 1x1 branch, one dilated 3x3 branch a rate, the pooling
    branch; ``project``: 1x1 over their concat, BN, ReLU, Dropout."""

    def __init__(self, in_ch: int = 2048, rates: Sequence[int] = (12, 24, 36),
                 out_ch: int = 256, dropout: float = 0.5,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.convs = nn.ModuleList(
            [_conv_bn_relu(in_ch, out_ch, 1, 1, dtype)]
            + [_conv_bn_relu(in_ch, out_ch, 3, r, dtype) for r in rates]
            + [ASPPPooling(in_ch, out_ch, dtype)])
        self.project = nn.Sequential(
            Conv2d((len(rates) + 2) * out_ch, out_ch, 1, bias=False, dtype=dtype),
            BatchNorm2d(out_ch, dtype), nn.ReLU(inplace=True), Dropout(dropout))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.project(torch.cat([branch(x) for branch in self.convs], dim=1))


def deeplab_head(in_ch: int, classes: int, dropout: float = 0.5,
                 dtype: torch.dtype = torch.float32) -> nn.Sequential:
    """ASPP -> conv3x3 256 -> 256 -> BN -> ReLU -> conv1x1 (Sequential 0/1/2/3/4)."""
    return nn.Sequential(
        ASPP(in_ch, dropout=dropout, dtype=dtype),
        Conv2d(256, 256, 3, padding=1, bias=False, dtype=dtype),
        BatchNorm2d(256, dtype), nn.ReLU(inplace=True),
        Conv2d(256, classes, 1, dtype=dtype))


def fcn_head(in_ch: int, classes: int, dropout: float = 0.1,
             dtype: torch.dtype = torch.float32) -> nn.Sequential:
    """conv3x3 in -> in/4 -> BN -> ReLU -> Dropout -> conv1x1 (Sequential 0/1/4)."""
    mid = in_ch // 4
    return nn.Sequential(
        Conv2d(in_ch, mid, 3, padding=1, bias=False, dtype=dtype),
        BatchNorm2d(mid, dtype), nn.ReLU(inplace=True), Dropout(dropout),
        Conv2d(mid, classes, 1, dtype=dtype))


class DeepLabV3(nn.Module):
    """``backbone`` (the torchvision-style trunk), ``classifier`` and, with
    ``with_aux``, ``aux_classifier``."""

    def __init__(self, classes: int = 5, layers: int = 50, with_aux: bool = True,
                 dtype: torch.dtype = torch.float32, remat: bool = False):
        super().__init__()
        self.backbone = ResNetFeatures(depth=layers, deep_base=False,
                                       semseg_dilation=False, dtype=dtype, remat=remat)
        self.classifier = deeplab_head(2048, classes, dtype=dtype)
        if with_aux:
            self.aux_classifier = fcn_head(1024, classes, dtype=dtype)

    def encode(self, x: torch.Tensor):
        """Trunk: NHWC images -> (NHWC 2048-channel c4 at stride 8, the
        trunk's NHWC {"c2", "c3", "c4"})."""
        feats = self.backbone.features(_nchw(x))
        return _nhwc(feats["c4"]).contiguous(), {k: _nhwc(v) for k, v in feats.items()}

    def decode(self, f: torch.Tensor) -> torch.Tensor:
        """DeepLabHead only (the flow path's decoder), NHWC; no upsampling."""
        return _nhwc(self.classifier(_nchw(f))).contiguous()

    def forward(self, x: torch.Tensor, with_feature: bool = False):
        """NHWC images -> {"pred"} (and "aux" in training); with
        ``with_feature`` also the trunk's c4 that the U2PL rep head reads,
        as (out, f)."""
        h, w = x.shape[1], x.shape[2]
        f, feats = self.encode(x)
        out = {"pred": resize_bilinear(self.decode(f), (h, w), align_corners=False)}
        if self.training and hasattr(self, "aux_classifier"):
            aux = _nhwc(self.aux_classifier(_nchw(feats["c3"])))
            out["aux"] = resize_bilinear(aux, (h, w), align_corners=False)
        return (out, f) if with_feature else out
