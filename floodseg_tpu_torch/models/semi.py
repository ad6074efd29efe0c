"""The U2PL representation heads and the reference's wrapper around a
segmentation model (counterpart of the ``with_rep`` variants of
floodseg_tpu/models/pspnet.py, deeplabv3.py and vit.py).

``ModelRepresentation`` holds the segmentation model under ``model`` and
the rep head under ``rep``, so its state_dict keys are the reference's
ModelRepresentation layout (floodseg_tpu/models/lightning_export.py,
``_export_role``): PSPNet ``model.*`` + ``rep.{0,1,4}``; DeepLabV3
``model.model.*`` + ``rep.{0,1,4}`` (the reference wraps torchvision's model
once more, ``ArchWrapper`` here); the Segmenter ViT ``model.model.*`` +
``rep.rep_model.*``.

The heads:

- PSPNet: ``SegHead(256, 256)`` (conv3x3 -> BN -> ReLU -> channel dropout
  0.1 -> conv1x1) on the PPM output, the map resized to the input with
  align_corners=True where it differs;
- DeepLabV3: the same head on the trunk's c4, always resized so;
- ViT: a 1-layer ``MaskTransformer`` with 256 classes on the patch tokens
  of the padded frame, its (h/P, w/P) map resized with align_corners=True
  first to (1 + N, D), the token tensor's own shape (the reference reads
  "h, w" from it), then to the input: bilinear resizes do not compose, so
  the extra hop is kept.

``out["rep"]`` exists in training mode only; in eval the wrapper is its
model.
"""

import torch
import torch.nn as nn

from floodseg_tpu_torch.models.deeplabv3 import DeepLabV3
from floodseg_tpu_torch.models.pspnet import PSPNet, seg_head
from floodseg_tpu_torch.models.vit import MaskTransformer, SegmenterViT
from floodseg_tpu_torch.ops.resize import resize_bilinear


class RepHead(nn.Sequential):
    """The CNNs' rep head, ``seg_head(in_dim, 256, 256)`` (keys 0, 1, 4):
    NHWC features -> the (B, h, w, 256) map at the input's size."""

    def __init__(self, in_dim: int, dropout: float = 0.1, dtype: torch.dtype = torch.float32):
        super().__init__(*seg_head(in_dim, 256, 256, dropout, dtype))

    def forward(self, f: torch.Tensor, hw) -> torch.Tensor:
        rep = super().forward(f.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        if tuple(rep.shape[1:3]) != tuple(hw):
            rep = resize_bilinear(rep, hw, align_corners=True)
        return rep


class VITRep(nn.Module):
    """The ViT's rep head: ``rep_model``, a 1-layer MaskTransformer with 256
    classes, on the encoder's tokens of the padded frame."""

    def __init__(self, patch_size: int = 32, d_model: int = 768, n_heads: int = 12,
                 dtype: torch.dtype = torch.float32, dropout: float = 0.1):
        super().__init__()
        self.patch_size = patch_size
        self.rep_model = MaskTransformer(256, patch_size, d_model, 1, n_heads, dtype, dropout)

    def forward(self, tokens: torch.Tensor, hw) -> torch.Tensor:
        ps = self.patch_size
        padded = tuple(-(-int(s) // ps) * ps for s in hw)
        rep = self.rep_model(tokens[:, 1:], padded)
        rep = resize_bilinear(rep, tuple(tokens.shape[1:3]), align_corners=True)
        return resize_bilinear(rep, hw, align_corners=True)


class ArchWrapper(nn.Module):
    """The reference's module around torchvision's DeepLabV3 and around the
    Segmenter (its only child is ``model``)."""

    def __init__(self, model: nn.Module):
        super().__init__()
        self.model = model

    def forward(self, x: torch.Tensor, with_feature: bool = False):
        return self.model(x, with_feature=with_feature)


class ModelRepresentation(nn.Module):
    """``model`` (a PSPNet, or an ``ArchWrapper`` of a DeepLabV3 or a
    SegmenterViT) and its rep head ``rep``. In training mode the output
    also holds "rep", the (B, H, W, 256) representation map."""

    def __init__(self, model: nn.Module, rep: nn.Module):
        super().__init__()
        self.model = model
        self.rep = rep

    def forward(self, x: torch.Tensor) -> dict:
        if not self.training:
            return self.model(x)
        out, feature = self.model(x, with_feature=True)
        out["rep"] = self.rep(feature, tuple(x.shape[1:3]))
        return out


def unwrap(model: nn.Module) -> nn.Module:
    """The segmentation model inside ``ModelRepresentation`` and
    ``ArchWrapper`` (``model`` itself when it is not wrapped)."""
    while isinstance(model, (ModelRepresentation, ArchWrapper)):
        model = model.model
    return model


def with_rep(model: nn.Module, dtype: torch.dtype = torch.float32) -> ModelRepresentation:
    """``model`` (a port PSPNet, DeepLabV3 or SegmenterViT) with its U2PL rep
    head, in the reference's layout."""
    if isinstance(model, PSPNet):
        return ModelRepresentation(model, RepHead(4096, 0.1, dtype))
    if isinstance(model, DeepLabV3):
        return ModelRepresentation(ArchWrapper(model), RepHead(2048, 0.1, dtype))
    if isinstance(model, SegmenterViT):
        enc = model.encoder
        d = enc.norm.weight.shape[0]
        rep = VITRep(model.patch_size, d, enc.blocks[0].attn.heads, dtype,
                     enc.pos_drop.rate)
        return ModelRepresentation(ArchWrapper(model), rep)
    raise ValueError(f"no rep head for {type(model).__name__}")
