"""DeepLabV3 (Chen et al., arXiv:1706.05587) in torchvision's
``deeplabv3_resnet101`` layout: the trunk ``backbone`` (torchvision's
ResNet, output stride 8), the DeepLabHead ``classifier`` (ASPP: a 1x1
branch, 3x3 branches at rates 12, 24, 36 and an image-pooling branch, 256
channels each, projected 1280 -> 256 with BN, ReLU and dropout 0.5; then a
3x3 256 -> 256, BN, ReLU and a 1x1 to the classes) and the FCNHead
``aux_classifier`` on layer3 (3x3 1024 -> 256, BN, ReLU, dropout 0.1, 1x1).
Logits are resized to the input with align_corners=False.

``encode`` gives the trunk's 2048-channel map and ``decode`` the
DeepLabHead, the flow path's split of the model.
"""

from typing import Dict, List, Optional, Tuple

import torch

from benchmark.reference import resnet
from benchmark.reference.ops import Params, conv, conv_bn_relu, dropout, resize

RATES = (12, 24, 36)
ASPP_DROPOUT = 0.5
AUX_DROPOUT = 0.1


def spec(cfg: dict) -> List[Tuple[str, tuple, str]]:
    classes = cfg["classes"]
    out = resnet.spec("backbone.", cfg["layers"], deep_base=False)
    a = "classifier.0"
    out += [(f"{a}.convs.0.0.weight", (256, 2048, 1, 1), "conv"), (f"{a}.convs.0.1", (256,), "bn")]
    for i in range(1, len(RATES) + 1):
        out += [(f"{a}.convs.{i}.0.weight", (256, 2048, 3, 3), "conv"),
                (f"{a}.convs.{i}.1", (256,), "bn")]
    n = len(RATES) + 1
    out += [(f"{a}.convs.{n}.1.weight", (256, 2048, 1, 1), "conv"),
            (f"{a}.convs.{n}.2", (256,), "bn"),
            (f"{a}.project.0.weight", (256, 256 * (n + 1), 1, 1), "conv"),
            (f"{a}.project.1", (256,), "bn"),
            ("classifier.1.weight", (256, 256, 3, 3), "conv"), ("classifier.2", (256,), "bn"),
            ("classifier.4.weight", (classes, 256, 1, 1), "conv"),
            ("classifier.4.bias", (classes,), "bias")]
    if cfg.get("aux", True):
        out += [("aux_classifier.0.weight", (256, 1024, 3, 3), "conv"),
                ("aux_classifier.1", (256,), "bn"),
                ("aux_classifier.4.weight", (classes, 256, 1, 1), "conv"),
                ("aux_classifier.4.bias", (classes,), "bias")]
    return out


def encode(p: Params, x: torch.Tensor, cfg: dict, train: bool = False
           ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    feats = resnet.features(p, "backbone.", x, cfg["layers"], False, train)
    return feats["c4"], feats


def decode(p: Params, f: torch.Tensor, cfg: dict, train: bool = False,
           keep: Optional[torch.Tensor] = None) -> torch.Tensor:
    a = "classifier.0"
    h, w = f.shape[-2:]
    branches = [conv_bn_relu(p, f"{a}.convs.0.0", f"{a}.convs.0.1", f, train)]
    for i, r in enumerate(RATES, 1):
        branches.append(conv_bn_relu(p, f"{a}.convs.{i}.0", f"{a}.convs.{i}.1", f, train,
                                     padding=r, dilation=r))
    n = len(RATES) + 1
    pooled = f.mean(dim=(2, 3), keepdim=True)
    pooled = conv_bn_relu(p, f"{a}.convs.{n}.1", f"{a}.convs.{n}.2", pooled, train)
    branches.append(resize(pooled.expand(-1, -1, h, w), (h, w), align_corners=False))
    y = conv_bn_relu(p, f"{a}.project.0", f"{a}.project.1", torch.cat(branches, dim=1), train)
    y = dropout(y, keep, ASPP_DROPOUT)
    y = conv_bn_relu(p, "classifier.1", "classifier.2", y, train, padding=1)
    return conv(p, "classifier.4", y)


def dropout_masks(cfg: dict, batch: int, hw: Tuple[int, int]) -> List[Tuple[tuple, float]]:
    """(shape, rate) of each dropout mask of a training forward, in the
    order the forward draws them: the ASPP projection's, then the aux
    head's; element dropout over (B, 256, H/8, W/8)."""
    fh, fw = (hw[0] - 1) // 8 + 1, (hw[1] - 1) // 8 + 1
    masks = [((batch, 256, fh, fw), ASPP_DROPOUT)]
    if cfg.get("aux", True):
        masks.append(((batch, 256, fh, fw), AUX_DROPOUT))
    return masks


def forward(p: Params, x: torch.Tensor, cfg: dict, train: bool,
            keeps: Optional[List[torch.Tensor]] = None) -> Dict[str, torch.Tensor]:
    """NCHW images -> {"pred"} (and "aux" in training), resized to the
    input with align_corners=False."""
    keeps = keeps or [None, None]
    h, w = x.shape[-2:]
    f, feats = encode(p, x, cfg, train)
    out = {"pred": resize(decode(p, f, cfg, train, keeps[0]), (h, w), False)}
    if train and cfg.get("aux", True):
        y = conv_bn_relu(p, "aux_classifier.0", "aux_classifier.1", feats["c3"], train,
                         padding=1)
        y = conv(p, "aux_classifier.4", dropout(y, keeps[1], AUX_DROPOUT))
        out["aux"] = resize(y, (h, w), False)
    return out


HEADS = ("classifier", "aux_classifier")
DECODE_BIAS = "classifier.4.bias"  # the classifier's last bias
