"""PSPNet (deep-base ResNet + pyramid pooling).

Counterpart of floodseg_tpu/models/pspnet.py: PPM bins (1, 2, 3, 6) with
2048 -> 512 1x1 conv branches upsampled with align_corners=True; cls head
3x3 4096 -> 512, BN, ReLU, dropout, 1x1 -> classes; optional aux head on
layer3 (1024 -> 256 -> classes). ``encode`` returns the 4096-channel map at
stride 8 and ``decode`` runs the cls head, the flow path's split. In
training mode ``forward`` also returns the aux head's logits on layer3, as
the JAX module's ``__call__(train=True)`` does; the heads' dropout is the
port's ``Dropout`` broadcast over H and W (flax's channel dropout), which
draws only from an explicit generator.

The module tree carries the reference's torch key names (``layer0.{0,1,3,
4,6,7}``, ``layerX.Y.*``, ``ppm.features.i.{1,2}``, ``cls.{0,1,4}``,
``aux.{0,1,4}``), so a reference Lightning checkpoint's PSPNet state_dict,
and ``models/convert.py``'s output, strict-load into it.

Public methods take and return NHWC tensors, as the JAX package does.
"""

from typing import Sequence

import torch
import torch.nn as nn

from floodseg_tpu_torch.models.layers import BatchNorm2d, Conv2d, Dropout
from floodseg_tpu_torch.models.resnet import ResNetFeatures
from floodseg_tpu_torch.ops.pool import adaptive_avg_pool
from floodseg_tpu_torch.ops.resize import resize_bilinear


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


class AdaptiveAvgPool(nn.Module):
    """``nn.AdaptiveAvgPool2d(bin)`` through ops.pool (NCHW in and out)."""

    def __init__(self, bin_size: int):
        super().__init__()
        self.bin_size = bin_size

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _nchw(adaptive_avg_pool(_nhwc(x), self.bin_size))


class PPM(nn.Module):
    def __init__(self, in_dim: int = 2048, reduction_dim: int = 512,
                 bins: Sequence[int] = (1, 2, 3, 6),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.features = nn.ModuleList(
            nn.Sequential(AdaptiveAvgPool(b),
                          Conv2d(in_dim, reduction_dim, 1, bias=False, dtype=dtype),
                          BatchNorm2d(reduction_dim, dtype),
                          nn.ReLU(inplace=True))
            for b in bins)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, w = x.shape[-2:]
        out = [x]
        for branch in self.features:
            y = _nhwc(branch(x))
            out.append(_nchw(resize_bilinear(y, (h, w), align_corners=True)))
        return torch.cat(out, dim=1)


def seg_head(in_dim: int, mid: int, out: int, dropout: float = 0.1,
             dtype: torch.dtype = torch.float32) -> nn.Sequential:
    """conv3x3 -> BN -> ReLU -> channel dropout -> conv1x1 (Sequential
    0/1/2/3/4; the reference's keys 0, 1 and 4)."""
    return nn.Sequential(
        Conv2d(in_dim, mid, 3, padding=1, bias=False, dtype=dtype),
        BatchNorm2d(mid, dtype),
        nn.ReLU(inplace=True),
        Dropout(dropout, broadcast_dims=(2, 3)),
        Conv2d(mid, out, 1, dtype=dtype))


class PSPNet(ResNetFeatures):
    """The dilated deep-base trunk (``layer0..layer4``) plus ``ppm``,
    ``cls`` and, with ``with_aux``, ``aux``."""

    def __init__(self, classes: int = 5, layers: int = 50,
                 bins: Sequence[int] = (1, 2, 3, 6), dropout: float = 0.1,
                 zoom_factor: int = 8, with_aux: bool = True,
                 dtype: torch.dtype = torch.float32, remat: bool = False):
        super().__init__(depth=layers, dtype=dtype, remat=remat)
        self.zoom_factor = zoom_factor
        self.ppm = PPM(2048, 2048 // len(bins), bins, dtype)
        self.cls = seg_head(4096, 512, classes, dropout, dtype)
        if with_aux:
            self.aux = seg_head(1024, 256, classes, dropout, dtype)

    def encode(self, x: torch.Tensor):
        """Backbone + PPM: NHWC images -> (NHWC 4096-channel map at stride 8,
        the trunk's NHWC {"c2", "c3", "c4"})."""
        feats = self.features(_nchw(x))
        f = _nhwc(self.ppm(feats["c4"])).contiguous()
        return f, {k: _nhwc(v) for k, v in feats.items()}

    def decode(self, f: torch.Tensor) -> torch.Tensor:
        """cls head only (the flow path's decoder), NHWC; no upsampling."""
        return _nhwc(self.cls(_nchw(f))).contiguous()

    def forward(self, x: torch.Tensor, with_feature: bool = False):
        """NHWC images -> {"pred"} (and "aux" in training); with
        ``with_feature`` also the PPM output that the U2PL rep head reads,
        as (out, f)."""
        h, w = x.shape[1], x.shape[2]
        if (h - 1) % 8 or (w - 1) % 8:
            raise ValueError(f"PSPNet input must be 8k+1, got {(h, w)}")
        f, feats = self.encode(x)
        pred = self.decode(f)
        if self.zoom_factor != 1:
            pred = resize_bilinear(pred, (h, w), align_corners=True)
        out = {"pred": pred}
        if self.training and hasattr(self, "aux"):
            aux = _nhwc(self.aux(_nchw(feats["c3"])))
            if self.zoom_factor != 1:
                aux = resize_bilinear(aux, (h, w), align_corners=True)
            out["aux"] = aux
        return (out, f) if with_feature else out
