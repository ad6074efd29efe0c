"""Segmenter ViT: the patch-embed encoder and the MaskTransformer decoder,
and the ViT image classifier.

Counterpart of floodseg_tpu/models/vit.py: by default ViT-B/32 (d = 768,
12 layers, 12 heads, MLP 3072) and a 2-layer MaskTransformer, or the linear
decoder (``decoder_type="linear"``). ``ViTClassifier`` is the encoder and a
Linear head over its cls token (ViT-B/16 by default), the model of the
classification-accuracy eval. ``encode`` returns the spatial
patch-token map (the cls token dropped) and ``decode`` runs the decoder
over such a map, the flow path's split; ``forward`` pads the frame to a
patch multiple, upsamples the mask logits with align_corners=False and
crops the padding away.

Rounding follows the JAX package in ``dtype``: each Linear rounds its
product and then its bias add (layers.Linear); attention rounds q.k^T, then
multiplies by hd**-0.5 (a value of ``dtype``) and rounds again; the softmax
runs in float32 and is cast to ``dtype`` before the product with v;
LayerNorm takes flax's fast variance (layers.LayerNorm). Plain
``torch.matmul`` and ``torch.softmax`` throughout: the JAX package leaves
this einsum chain to XLA, and ``scaled_dot_product_attention`` rounds the
probabilities otherwise.

The module tree carries the reference's (timm / Segmenter) key names:
``encoder.{patch_embed.proj, cls_token, pos_embed, blocks.I.{norm1,
attn.qkv, attn.proj, norm2, mlp.fc1, mlp.fc2}, norm}`` and
``decoder.{proj_dec, cls_emb, blocks.I.*, decoder_norm, proj_patch,
proj_classes, mask_norm}`` (the linear decoder: ``decoder.head``), so
``models/convert.py``'s output strict-loads into it. The patch embedding
keeps the reference's stride-P conv weight (D, 3, P, P) and computes
patchify and a product with it laid out as the JAX package's (P*P*3, D)
kernel, rows in (py, px, c) order.

Training mode runs the JAX package's dropout (rate ``dropout``, 0.1 by
default) at flax's sites and in flax's order: on the attention
probabilities after the float32 softmax and its cast (``attn_drop``), after
the attention's ``proj`` (``proj_drop``), after each of the FeedForward's
two Linear layers (``drop1``, ``drop2``), on the tokens after the position
embedding (``pos_drop``), and in every MaskTransformer block. Each is the
port's element ``Dropout``, which holds no parameters and draws only from
an explicit generator. DropPath is not ported: ``SegmenterViT`` never sets
a drop-path rate, so every DropPath of the JAX package runs at rate 0. The
U2PL rep head is ``models/semi.py``'s. Public methods take and return NHWC.

Attention maps: ``capture_attention(model)`` makes every ``Attention`` of
``model`` keep its probabilities (after the float32 softmax and its cast,
before ``attn_drop``: the tensor the JAX package ``sow``s) in
``attn_map`` for the block's duration. Off by default: outside the block
no tensor is kept and nothing is read back (segm/attn.py reads them).
"""

import contextlib
from typing import Iterator, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from floodseg_tpu_torch.models.layers import Dropout, LayerNorm, Linear
from floodseg_tpu_torch.ops.resize import resize_bilinear


def patchify(x: torch.Tensor, patch: int) -> torch.Tensor:
    """NHWC image -> (B, h*w, patch*patch*C) token sequence."""
    b, h, w, c = x.shape
    gh, gw = h // patch, w // patch
    x = x.reshape(b, gh, patch, gw, patch, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, gh * gw, patch * patch * c)


class PatchEmbed(nn.Module):
    """The reference's ``patch_embed`` of RGB frames: its conv's weight (D,
    3, P, P) and bias, applied as patchify, a product in ``dtype`` and the
    bias add."""

    def __init__(self, patch: int, d_model: int, dtype: torch.dtype):
        super().__init__()
        self.patch = patch
        self.proj = nn.Conv2d(3, d_model, patch, stride=patch)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        w = self.proj.weight.permute(2, 3, 1, 0).reshape(-1, self.proj.out_channels)
        return torch.matmul(patchify(x.to(dt), self.patch), w.to(dt)) + self.proj.bias.to(dt)


class Attention(nn.Module):
    def __init__(self, d_model: int, heads: int, dtype: torch.dtype = torch.float32,
                 dropout: float = 0.0):
        super().__init__()
        self.heads = heads
        self.qkv = Linear(d_model, 3 * d_model, dtype=dtype)
        self.attn_drop = Dropout(dropout)
        self.proj = Linear(d_model, d_model, dtype=dtype)
        self.proj_drop = Dropout(dropout)
        # the JAX package multiplies dtype-valued scores by hd**-0.5, a
        # weakly typed scalar that is first rounded to dtype
        self.scale = float(torch.tensor((d_model // heads) ** -0.5, dtype=dtype))
        self.keep_attn = False
        self.attn_map: Optional[torch.Tensor] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, d = x.shape
        qkv = self.qkv(x).reshape(b, n, 3, self.heads, d // self.heads)
        q, k, v = qkv.permute(2, 0, 3, 1, 4)
        attn = torch.matmul(q, k.transpose(-2, -1)) * self.scale
        sdt = torch.promote_types(x.dtype, torch.float32)
        attn = torch.softmax(attn.to(sdt), dim=-1).to(x.dtype)
        if self.keep_attn:
            self.attn_map = attn
        attn = self.attn_drop(attn)
        y = torch.matmul(attn, v).transpose(1, 2).reshape(b, n, d)
        return self.proj_drop(self.proj(y))


@contextlib.contextmanager
def capture_attention(model: nn.Module) -> Iterator[None]:
    """Every ``Attention`` of ``model`` keeps its probabilities in
    ``attn_map`` inside the block; on exit they are dropped and capture is
    off again."""
    mods = [m for m in model.modules() if isinstance(m, Attention)]
    for m in mods:
        m.keep_attn = True
    try:
        yield
    finally:
        for m in mods:
            m.keep_attn, m.attn_map = False, None


class FeedForward(nn.Module):
    def __init__(self, d_model: int, hidden: int, dtype: torch.dtype = torch.float32,
                 dropout: float = 0.0):
        super().__init__()
        self.fc1 = Linear(d_model, hidden, dtype=dtype)
        self.drop1 = Dropout(dropout)
        self.fc2 = Linear(hidden, d_model, dtype=dtype)
        self.drop2 = Dropout(dropout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.drop1(F.gelu(self.fc1(x), approximate="none"))
        return self.drop2(self.fc2(x))


class Block(nn.Module):
    """Pre-norm residual block: x + attn(norm1(x)), then + mlp(norm2(x))."""

    def __init__(self, d_model: int, heads: int, mlp_dim: int,
                 dtype: torch.dtype = torch.float32, dropout: float = 0.0):
        super().__init__()
        self.norm1 = LayerNorm(d_model, dtype)
        self.attn = Attention(d_model, heads, dtype, dropout)
        self.norm2 = LayerNorm(d_model, dtype)
        self.mlp = FeedForward(d_model, mlp_dim, dtype, dropout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.norm1(x))
        return x + self.mlp(self.norm2(x))


def resize_pos_embed(pos_embed: torch.Tensor, grid_old: Tuple[int, int],
                     grid_new: Tuple[int, int], num_extra_tokens: int = 1) -> torch.Tensor:
    """Bilinearly interpolate the 2D patch position grid (align_corners=False)."""
    extra = pos_embed[:, :num_extra_tokens]
    grid = pos_embed[:, num_extra_tokens:]
    d = grid.shape[-1]
    grid = grid.reshape(1, grid_old[0], grid_old[1], d)
    grid = resize_bilinear(grid, grid_new, align_corners=False)
    return torch.cat([extra, grid.reshape(1, -1, d)], dim=1)


class VisionTransformer(nn.Module):
    def __init__(self, image_size: int = 768, patch_size: int = 32, n_layers: int = 12,
                 d_model: int = 768, n_heads: int = 12, dtype: torch.dtype = torch.float32,
                 dropout: float = 0.1):
        super().__init__()
        self.image_size, self.patch_size = image_size, patch_size
        grid0 = image_size // patch_size
        self.patch_embed = PatchEmbed(patch_size, d_model, dtype)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, d_model))
        self.pos_embed = nn.Parameter(torch.zeros(1, grid0 * grid0 + 1, d_model))
        self.pos_drop = Dropout(dropout)
        self.blocks = nn.ModuleList(
            [Block(d_model, n_heads, 4 * d_model, dtype, dropout) for _ in range(n_layers)])
        self.norm = LayerNorm(d_model, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """NHWC image (H, W divisible by the patch) -> (B, 1 + h*w, D)."""
        b, h, w, _ = x.shape
        ps = self.patch_size
        grid0 = self.image_size // ps
        tokens = self.patch_embed(x)
        cls = self.cls_token.expand(b, -1, -1).to(tokens.dtype)
        tokens = torch.cat([cls, tokens], dim=1)
        pos = self.pos_embed
        if tokens.shape[1] != pos.shape[1]:
            pos = resize_pos_embed(pos, (grid0, grid0), (h // ps, w // ps))
        tokens = self.pos_drop(tokens + pos.to(tokens.dtype))
        for block in self.blocks:
            tokens = block(tokens)
        return self.norm(tokens)


def _l2_normalize(x: torch.Tensor) -> torch.Tensor:
    """x / ||x|| over the last axis: the norm in promote_types(dtype,
    float32), cast to x's dtype before the divide."""
    xs = x.to(torch.promote_types(x.dtype, torch.float32))
    return x / torch.sqrt((xs * xs).sum(-1, keepdim=True)).to(x.dtype)


class MaskTransformer(nn.Module):
    def __init__(self, n_cls: int, patch_size: int = 32, d_model: int = 768,
                 n_layers: int = 2, n_heads: int = 12, dtype: torch.dtype = torch.float32,
                 dropout: float = 0.1):
        super().__init__()
        self.n_cls, self.patch_size = n_cls, patch_size
        self.proj_dec = Linear(d_model, d_model, dtype=dtype)
        self.cls_emb = nn.Parameter(torch.zeros(1, n_cls, d_model))
        self.blocks = nn.ModuleList(
            [Block(d_model, n_heads, 4 * d_model, dtype, dropout) for _ in range(n_layers)])
        self.decoder_norm = LayerNorm(d_model, dtype)
        self.proj_patch = nn.Parameter(torch.zeros(d_model, d_model))
        self.proj_classes = nn.Parameter(torch.zeros(d_model, d_model))
        self.mask_norm = LayerNorm(n_cls, dtype)

    def forward(self, x: torch.Tensor, im_size: Tuple[int, int]) -> torch.Tensor:
        """(B, N, D) patch tokens -> (B, H/P, W/P, n_cls) mask logits."""
        gs = im_size[0] // self.patch_size
        b = x.shape[0]
        x = self.proj_dec(x)
        x = torch.cat([x, self.cls_emb.expand(b, -1, -1).to(x.dtype)], dim=1)
        for block in self.blocks:
            x = block(x)
        x = self.decoder_norm(x)
        patches, cls_feat = x[:, :-self.n_cls], x[:, -self.n_cls:]
        patches = _l2_normalize(patches @ self.proj_patch.to(patches.dtype))
        cls_feat = _l2_normalize(cls_feat @ self.proj_classes.to(cls_feat.dtype))
        masks = self.mask_norm(patches @ cls_feat.transpose(1, 2))
        return masks.reshape(b, gs, masks.shape[1] // gs, self.n_cls)


class DecoderLinear(nn.Module):
    """Linear patch classifier: one Linear over the encoder's tokens,
    reshaped to the patch grid."""

    def __init__(self, n_cls: int, patch_size: int = 32, d_model: int = 768,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.patch_size = patch_size
        self.head = Linear(d_model, n_cls, dtype=dtype)

    def forward(self, x: torch.Tensor, im_size: Tuple[int, int]) -> torch.Tensor:
        """(B, N, D) patch tokens -> (B, H/P, W/P, n_cls) logits."""
        gs = im_size[0] // self.patch_size
        x = self.head(x)
        b, n, c = x.shape
        return x.reshape(b, gs, n // gs, c)


class SegmenterViT(nn.Module):
    """``encoder`` (VisionTransformer) and ``decoder`` (MaskTransformer, or
    DecoderLinear). It has no ``cls`` submodule, so the predict builders
    decode a window as one call (train/flow.py::decode_split_ok)."""

    def __init__(self, classes: int = 5, image_size: int = 768, patch_size: int = 32,
                 d_model: int = 768, n_layers: int = 12, dec_layers: int = 2,
                 n_heads: Optional[int] = None, decoder_type: str = "mask_transformer",
                 dtype: torch.dtype = torch.float32, dropout: float = 0.1):
        super().__init__()
        heads = n_heads or d_model // 64
        self.patch_size = patch_size
        self.encoder = VisionTransformer(image_size, patch_size, n_layers, d_model,
                                         heads, dtype, dropout)
        if decoder_type == "linear":
            self.decoder = DecoderLinear(classes, patch_size, d_model, dtype)
        else:
            self.decoder = MaskTransformer(classes, patch_size, d_model, dec_layers,
                                           heads, dtype, dropout)

    def _pad(self, x: torch.Tensor) -> torch.Tensor:
        ps = self.patch_size
        pad_h = (ps - x.shape[1] % ps) % ps
        pad_w = (ps - x.shape[2] % ps) % ps
        if pad_h or pad_w:
            x = F.pad(x, (0, 0, 0, pad_w, 0, pad_h))
        return x

    def encode(self, x: torch.Tensor):
        """NHWC frames (H, W multiples of the patch) -> (the (B, H/P, W/P,
        D) patch-token map, None). Padding would misalign the block grids'
        [-1, 1] warp coordinates, so other sizes raise."""
        h, w = x.shape[1], x.shape[2]
        ps = self.patch_size
        if h % ps or w % ps:
            raise ValueError(f"vit flow input must be a multiple of {ps}, got {(h, w)}")
        feats = self.encoder(x)
        f = feats[:, 1:].reshape(feats.shape[0], h // ps, w // ps, feats.shape[-1])
        return f.contiguous(), None

    def decode(self, f: torch.Tensor) -> torch.Tensor:
        """(B, gh, gw, D) token map -> (B, gh, gw, classes) mask logits at
        token resolution."""
        b, gh, gw, d = f.shape
        return self.decoder(f.reshape(b, gh * gw, d),
                            (gh * self.patch_size, gw * self.patch_size))

    def forward(self, x: torch.Tensor, with_feature: bool = False):
        """NHWC images -> {"pred"}; with ``with_feature`` also the
        encoder's tokens (B, 1 + N, D) of the padded frame, which the U2PL
        rep head reads, as (out, tokens)."""
        h_ori, w_ori = x.shape[1], x.shape[2]
        x = self._pad(x)
        h, w = x.shape[1], x.shape[2]
        feats = self.encoder(x)
        masks = self.decoder(feats[:, 1:], (h, w))
        masks = resize_bilinear(masks, (h, w), align_corners=False)
        out = {"pred": masks[:, :h_ori, :w_ori]}
        return (out, feats) if with_feature else out


class ViTClassifier(nn.Module):
    """ViT image classifier: ``encoder`` (VisionTransformer, d_model // 64
    heads unless ``n_heads``) and a Linear ``head`` over the cls token's
    features; float32 parameters, computing in ``dtype``. NHWC images ->
    (B, n_cls) logits."""

    def __init__(self, n_cls: int = 1000, image_size: int = 224, patch_size: int = 16,
                 d_model: int = 768, n_layers: int = 12, n_heads: Optional[int] = None,
                 dropout: float = 0.0, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.encoder = VisionTransformer(image_size, patch_size, n_layers, d_model,
                                         n_heads or d_model // 64, dtype, dropout)
        self.head = Linear(d_model, n_cls, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.head(self.encoder(x)[:, 0])
