"""ResNet trunks with dilated layer3 and layer4 (NCHW inside).

Counterpart of floodseg_tpu/models/resnet.py, in its two styles:

- ``deep_base=True``, ``semseg_dilation=True`` (PSPNet): a three-conv stem,
  then max-pool 3/2/1; every block of layer3 at dilation 2 and of layer4 at
  dilation 4. Module names are the reference's torch names (``layer0``
  Sequential for the stem, ``layerX.Y.convZ/bnZ/downsample``).
- ``deep_base=False``, ``semseg_dilation=False`` (DeepLabV3): torchvision's
  7x7/2 stem as ``conv1``/``bn1``, then max-pool 3/2/1; torchvision's
  ``replace_stride_with_dilation=[False, True, True]``, where the first
  block of a dilated stage keeps the previous stage's dilation, so layer3
  runs at [1, 2, 2, ...] and layer4 at [2, 4, 4].

layer3 and layer4 run at stride 1 in both, with a downsample on each
first block.

``remat=True`` is the JAX package's ``nn.remat(Bottleneck)``: in training
with gradients on, each bottleneck keeps only its input and recomputes its
activations in the backward (non-reentrant ``torch.utils.checkpoint``). The
recompute runs each BN with the world and the float flags of its forward
and without moving the running statistics again, so a step's values,
gradients and statistics equal the plain step's bit for bit; over ranks it
repeats BN's all-reduce inside the backward. Eval, ``no_grad`` (the U2PL
teacher) and the state_dict keys are as without it.
"""

import contextlib
from functools import partial
from typing import Dict, List

import torch
import torch.nn as nn
from torch.utils.checkpoint import checkpoint

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
        self.remat = False

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.remat and self.training and torch.is_grad_enabled():
            return checkpoint(self._forward, x, use_reentrant=False,
                              context_fn=partial(_remat_contexts, self))
        return self._forward(x)

    def _forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.relu(self.bn1(self.conv1(x)))
        y = self.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        residual = x if self.downsample is None else self.downsample(x)
        return self.relu(y + residual)


def _remat_contexts(block: nn.Module):
    """``checkpoint``'s (forward, recompute) contexts for ``block``, made at
    its forward: the recompute sets each BN's world (``data_parallel``'s,
    which the backward runs outside of) and the TF32 / bf16-reduction flags
    to their values at the forward, and leaves the running statistics."""
    bns = [m for m in block.modules() if isinstance(m, BatchNorm2d)]
    worlds = [m.world for m in bns]
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    flags = (cudnn.allow_tf32, matmul.allow_tf32,
             matmul.allow_bf16_reduced_precision_reduction)

    @contextlib.contextmanager
    def recompute():
        prev = [(m.world, m.update_running) for m in bns]
        prev_flags = (cudnn.allow_tf32, matmul.allow_tf32,
                      matmul.allow_bf16_reduced_precision_reduction)
        for m, w in zip(bns, worlds):
            m.world, m.update_running = w, False
        (cudnn.allow_tf32, matmul.allow_tf32,
         matmul.allow_bf16_reduced_precision_reduction) = flags
        try:
            yield
        finally:
            for m, (w, u) in zip(bns, prev):
                m.world, m.update_running = w, u
            (cudnn.allow_tf32, matmul.allow_tf32,
             matmul.allow_bf16_reduced_precision_reduction) = prev_flags

    return contextlib.nullcontext(), recompute()


def stage_dilations(n_blocks: int, new: int, prev: int, semseg: bool) -> List[int]:
    """Each block's dilation in a stage dilated to ``new`` (the JAX
    package's ``stage_dilations``)."""
    if new == 1:
        return [1] * n_blocks
    if semseg:
        return [new] * n_blocks
    return [prev] + [new] * (n_blocks - 1)


class ResNetFeatures(nn.Module):
    """Stem + layer1..4 -> {"c2", "c3", "c4"} (layer2/3/4 outputs, NCHW);
    ``remat``: every bottleneck rematerialised (module note)."""

    def __init__(self, depth: int = 50, deep_base: bool = True,
                 semseg_dilation: bool = True, dtype: torch.dtype = torch.float32,
                 remat: bool = False):
        super().__init__()
        blocks = DEPTH_BLOCKS[depth]
        self.depth = depth
        self.deep_base = deep_base
        self.semseg_dilation = semseg_dilation
        if deep_base:
            self.layer0 = nn.Sequential(
                Conv2d(3, 64, 3, stride=2, padding=1, bias=False, dtype=dtype),
                BatchNorm2d(64, dtype), nn.ReLU(inplace=True),
                Conv2d(64, 64, 3, padding=1, bias=False, dtype=dtype),
                BatchNorm2d(64, dtype), nn.ReLU(inplace=True),
                Conv2d(64, 128, 3, padding=1, bias=False, dtype=dtype),
                BatchNorm2d(128, dtype), nn.ReLU(inplace=True),
                MaxPool(3, 2, 1))
            inplanes = 128
        else:
            self.conv1 = Conv2d(3, 64, 7, stride=2, padding=3, bias=False, dtype=dtype)
            self.bn1 = BatchNorm2d(64, dtype)
            self.relu = nn.ReLU(inplace=True)
            self.maxpool = MaxPool(3, 2, 1)
            inplanes = 64
        stages = ((64, 1, [1] * blocks[0]), (128, 2, [1] * blocks[1]),
                  (256, 1, stage_dilations(blocks[2], 2, 1, semseg_dilation)),
                  (512, 1, stage_dilations(blocks[3], 4, 2, semseg_dilation)))
        for li, (planes, stride, dilations) in enumerate(stages, 1):
            layer = []
            for i, dilation in enumerate(dilations):
                layer.append(Bottleneck(
                    inplanes, planes, stride=stride if i == 0 else 1,
                    dilation=dilation,
                    has_downsample=(i == 0 and (stride != 1
                                                or inplanes != planes * 4)),
                    dtype=dtype))
                layer[-1].remat = remat
                inplanes = planes * 4
            setattr(self, f"layer{li}", nn.Sequential(*layer))

    def stem(self, x: torch.Tensor) -> torch.Tensor:
        if self.deep_base:
            return self.layer0(x)
        return self.maxpool(self.relu(self.bn1(self.conv1(x))))

    def features(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        x = self.layer1(self.stem(x))
        c2 = self.layer2(x)
        c3 = self.layer3(c2)
        return {"c2": c2, "c3": c3, "c4": self.layer4(c3)}

    forward = features
