"""Attention maps of the Segmenter ViT (counterpart of
floodseg_tpu/segm/attn.py).

``attention_maps`` runs one forward in eval mode with every ``Attention``
keeping its probabilities (models/vit.py::capture_attention: after the
float32 softmax and its cast, before dropout, the tensor the JAX package
``sow``s) and returns them by layer; ``head_maps`` cuts one layer's
tensor into per-head spatial maps.
"""

from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn as nn

from floodseg_tpu_torch.core.device import full_precision_f32
from floodseg_tpu_torch.models.vit import capture_attention


@torch.no_grad()
def attention_maps(model: nn.Module, image: torch.Tensor) -> Dict[str, list]:
    """All attention tensors of one forward pass of a SegmenterViT.

    image: (1, H, W, 3) normalized, on the model's device. Returns
    {"encoder": [L x (1, heads, N, N)], "decoder": [...]} as float32
    numpy arrays, ordered by layer (the linear decoder has none)."""
    with capture_attention(model), full_precision_f32():
        model.eval()
        model(image)

        def collect(part) -> list:
            return [blk.attn.attn_map.float().cpu().numpy()
                    for blk in getattr(part, "blocks", [])]

        return {"encoder": collect(model.encoder), "decoder": collect(model.decoder)}


def head_maps(attn: np.ndarray, grid: Tuple[int, int], patch_size: int, query: str = "cls",
              xy_patch: Tuple[int, int] = (0, 0), n_cls: int = 0,
              is_decoder: bool = False) -> np.ndarray:
    """Per-head spatial maps from one layer's attention tensor.

    attn: (1, heads, N, N). Encoder tokens are [cls, patches...]; decoder
    tokens [patches..., class embeddings...] (the MaskTransformer appends
    its n_cls class tokens at the end).

    query="cls": the class token(s) attending over the patches ->
      encoder (heads, 1, gh, gw); decoder (heads, n_cls, gh, gw).
    query="patch": patch (x, y) attending over the patches -> (heads, 1, gh, gw).
    Maps are nearest-upsampled by patch_size.
    """
    gh, gw = grid
    a = attn[0]
    if is_decoder:
        if query == "cls":
            maps = a[:, -n_cls:, :-n_cls]
        else:
            x, y = xy_patch
            maps = a[:, gw * y + x: gw * y + x + 1, :-n_cls]
    else:
        if query == "cls":
            maps = a[:, 0:1, 1:]
        else:
            x, y = xy_patch
            q = 1 + gw * y + x
            maps = a[:, q:q + 1, 1:]
    heads, nq, _ = maps.shape
    maps = maps.reshape(heads, nq, gh, gw)
    return np.repeat(np.repeat(maps, patch_size, axis=2), patch_size, axis=3)
