"""PSPNet (Zhao et al., arXiv:1612.01105) as the published repository's
``model/pspnet.py`` builds it: the deep-base dilated ResNet, the pyramid
pooling module (bins 1, 2, 3, 6; 2048 -> 512 each, upsampled with
align_corners=True, concatenated with the trunk's map to 4096 channels),
the classifier ``cls`` (3x3 4096 -> 512, BN, ReLU, channel dropout 0.1,
1x1 -> classes) and the aux head on layer3 (1024 -> 256 -> classes).

``encode`` gives the 4096-channel map at stride 8 and ``decode`` the
classifier, the flow path's split of the model.
"""

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from benchmark.reference import resnet
from benchmark.reference.ops import Params, conv, conv_bn_relu, dropout, resize

BINS = (1, 2, 3, 6)
DROPOUT = 0.1


def _head_spec(prefix: str, cin: int, mid: int, classes: int) -> List[Tuple[str, tuple, str]]:
    return [(f"{prefix}.0.weight", (mid, cin, 3, 3), "conv"), (f"{prefix}.1", (mid,), "bn"),
            (f"{prefix}.4.weight", (classes, mid, 1, 1), "conv"),
            (f"{prefix}.4.bias", (classes,), "bias")]


def spec(cfg: dict) -> List[Tuple[str, tuple, str]]:
    out = resnet.spec("", cfg["layers"], deep_base=True)
    red = 2048 // len(BINS)
    for i in range(len(BINS)):
        out += [(f"ppm.features.{i}.1.weight", (red, 2048, 1, 1), "conv"),
                (f"ppm.features.{i}.2", (red,), "bn")]
    out += _head_spec("cls", 4096, 512, cfg["classes"])
    if cfg.get("aux", True):
        out += _head_spec("aux", 1024, 256, cfg["classes"])
    return out


def encode(p: Params, x: torch.Tensor, cfg: dict, train: bool = False
           ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    feats = resnet.features(p, "", x, cfg["layers"], True, train)
    c4 = feats["c4"]
    h, w = c4.shape[-2:]
    out = [c4]
    for i, b in enumerate(BINS):
        y = F.adaptive_avg_pool2d(c4, b)
        y = conv_bn_relu(p, f"ppm.features.{i}.1", f"ppm.features.{i}.2", y, train)
        out.append(resize(y, (h, w), align_corners=True))
    return torch.cat(out, dim=1), feats


def _head(p: Params, prefix: str, x: torch.Tensor, train: bool,
          keep: Optional[torch.Tensor]) -> torch.Tensor:
    y = conv_bn_relu(p, f"{prefix}.0", f"{prefix}.1", x, train, padding=1)
    return conv(p, f"{prefix}.4", dropout(y, keep, DROPOUT))


def decode(p: Params, f: torch.Tensor, cfg: dict, train: bool = False,
           keep: Optional[torch.Tensor] = None) -> torch.Tensor:
    return _head(p, "cls", f, train, keep)


def dropout_masks(cfg: dict, batch: int, hw: Tuple[int, int]) -> List[Tuple[tuple, float]]:
    """(shape, rate) of each dropout mask of a training forward, in the
    order the forward draws them: the classifier's, then the aux head's;
    channel dropout, one draw per (sample, channel)."""
    masks = [((batch, 512, 1, 1), DROPOUT)]
    if cfg.get("aux", True):
        masks.append(((batch, 256, 1, 1), DROPOUT))
    return masks


def forward(p: Params, x: torch.Tensor, cfg: dict, train: bool,
            keeps: Optional[List[torch.Tensor]] = None) -> Dict[str, torch.Tensor]:
    """NCHW images -> {"pred"} (and "aux" in training), resized to the
    input with align_corners=True."""
    keeps = keeps or [None, None]
    h, w = x.shape[-2:]
    f, feats = encode(p, x, cfg, train)
    out = {"pred": resize(decode(p, f, cfg, train, keeps[0]), (h, w), True)}
    if train and cfg.get("aux", True):
        out["aux"] = resize(_head(p, "aux", feats["c3"], train, keeps[1]), (h, w), True)
    return out


HEADS = ("ppm", "cls", "aux")
DECODE_BIAS = "cls.4.bias"  # the classifier's last bias
