"""Post-training int8 quantization of the flow-predict decoders.

Counterpart of floodseg_tpu/ops/quant.py, for the PSPNet SegHead (conv3x3
-> BN -> ReLU -> Dropout -> conv1x1, ``models/pspnet.py::seg_head``) and
the DeepLabV3 DeepLabHead (``int8_deeplab_decode``: ASPP, projection and
the trailing 3x3 in int8, ``models/deeplabv3.py::deeplab_head``):

- eval-mode BN folds into the 3x3 conv: w' = w * gamma/sqrt(var+eps) per
  out-channel, b' = beta - mean * gamma/sqrt(var+eps);
- weights: symmetric per-out-channel int8 (absmax / 127);
- activations: symmetric per-tensor int8, the scale from a dynamic absmax
  or from a bound the caller already knows (the flow-predict absmax hint);
- the int32 accumulator dequantizes in the conv epilogue (sx * sw[c]), adds
  the folded bias, ReLU, then the 512 -> classes 1x1 conv runs in the
  compute dtype.

Layouts are the port's: activations NHWC, weights OIHW (so a weight's
per-channel absmax runs over dims 1-3). ``conv_int8`` is an int8 x int8 ->
int32 GEMM (``torch._int_mm``: cuBLASLt on the card) over an im2col of the
padded input, as the JAX package leaves its int8 convolution to XLA; it is
a library product, not one of the port's kernels. The integer sums are
exact, so the accumulator equals the JAX package's bit for bit.

The int8 encoder (``model.int8_encode``): ``int8_resnet_trunk`` runs the
ResNet trunk's bottleneck convolutions in int8 (W8A8, BN folded, each
block's input quantized once at a dynamic scale), the stem in the compute
dtype with float32 sums, the residual adds in float32; ``ppm_folded`` is
PSPNet's PPM with its BNs folded, in full precision. They read the
trunk's and the PPM's state by the port's (the reference's) key names.

Not here: ``int8_auto_default`` (the port's benchmark decides the H100
default).
"""

from typing import Mapping, Sequence, Tuple

import torch
import torch.nn.functional as F

from floodseg_tpu_torch.core.device import full_precision_f32
from floodseg_tpu_torch.ops.pool import adaptive_avg_pool, max_pool
from floodseg_tpu_torch.ops.resize import resize_bilinear

_TINY = torch.finfo(torch.float32).tiny

Pairs = Sequence[Tuple[int, int]]


def fold_bn(w: torch.Tensor, gamma, beta, mean, var, eps: float = 1e-5):
    """Fold eval-mode BN into a preceding bias-free conv. w: (cout, cin,
    kh, kw). Returns (w', b') in float32."""
    s = gamma.float() * torch.rsqrt(var.float() + eps)
    w_f = w.float() * s[:, None, None, None]
    b_f = beta.float() - mean.float() * s
    return w_f, b_f


def quantize_weight_per_channel(w: torch.Tensor):
    """Symmetric per-out-channel int8: absmax over (cin, kh, kw)."""
    scale = torch.amax(w.abs(), dim=(1, 2, 3)) / 127.0
    scale = torch.clamp_min(scale, _TINY)
    q = torch.clamp(torch.round(w / scale[:, None, None, None]), -127, 127)
    return q.to(torch.int8), scale


def scale_from_absmax(absmax) -> torch.Tensor:
    """Symmetric int8 scale from a bound on |x| (shared by every caller, so
    pre-quantized inputs and in-decode quantization agree bit for bit)."""
    scale = torch.as_tensor(absmax).float() / 127.0
    return torch.clamp_min(scale, _TINY)


def quantize_with_scale(x: torch.Tensor, scale) -> torch.Tensor:
    """int8 at a fixed scale: quantizing pieces and concatenating equals
    quantizing the concatenation. ``torch.round`` rounds half to even, as
    ``jnp.round`` does."""
    q = torch.clamp(torch.round(x.float() / scale), -127, 127)
    return q.to(torch.int8)


def quantize_activation_dynamic(x: torch.Tensor, absmax=None):
    """Symmetric per-tensor int8 with an absmax scale -> (x_q, scale).

    ``absmax``: a bound on max|x| the caller already knows (a device
    scalar). An int8 ``x`` was quantized with ``quantize_with_scale`` at
    that bound's scale and passes through untouched."""
    if x.dtype == torch.int8:
        if absmax is None:
            raise ValueError("a pre-quantized input needs its absmax")
        return x, scale_from_absmax(absmax)
    if absmax is None:
        absmax = torch.amax(x.float().abs())
    scale = scale_from_absmax(absmax)
    return quantize_with_scale(x, scale), scale


def im2col_nhwc(x: torch.Tensor, kh: int, kw: int, padding: Pairs,
                dilation=(1, 1), strides=(1, 1)):
    """(B, H, W, C) -> (the (B * Ho * Wo, kh * kw * C) patch matrix of a
    zero-padded convolution, columns ordered (i, j, c); (B, Ho, Wo)). One
    copy of the padded input through a strided view; where a pixel's
    channels fill whole 8-byte words, the copy moves words, not bytes."""
    (pt, pb), (pl, pr) = padding
    dh, dw = dilation
    sh, sw = strides
    xp = F.pad(x, (0, 0, pl, pr, pt, pb)).contiguous()
    b, hp, wp, c = xp.shape
    ho = (hp - dh * (kh - 1) - 1) // sh + 1
    wo = (wp - dw * (kw - 1) - 1) // sw + 1
    words = xp.view(torch.int64) if (c * xp.element_size()) % 8 == 0 else xp
    cw = words.shape[-1]
    s_b, s_h, s_w, _ = words.stride()
    view = words.as_strided((b, ho, wo, kh, kw, cw),
                            (s_b, s_h * sh, s_w * sw, s_h * dh, s_w * dw, 1))
    return view.reshape(b * ho * wo, kh * kw * cw).view(x.dtype), (b, ho, wo)


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


def conv_int8(x_q: torch.Tensor, w_q: torch.Tensor, padding: Pairs,
              dilation=(1, 1), strides=(1, 1)) -> torch.Tensor:
    """int8 x int8 -> int32 convolution. x_q (B, H, W, Cin) NHWC, w_q (Cout,
    Cin, kh, kw) OIHW -> (B, Ho, Wo, Cout) int32.

    im2col (M = B*Ho*Wo rows, K = kh*kw*Cin) times the weight as a
    column-major (K, Cout) matrix, through ``torch._int_mm``. The GEMM's
    size rules on CUDA (M > 16, K and N multiples of 8) are met on every
    device by zero rows up to M = 17 and zero columns up to the next
    multiples of 8, sliced off after: sums of zeros change no integer sum,
    so the result is exact at every shape. (On an H100, torch 2.11 / CUDA
    12.8, a row-major B raised CUBLAS_STATUS_NOT_SUPPORTED at M = 17; the
    column-major view works at every size tried.)"""
    if x_q.dtype != torch.int8 or w_q.dtype != torch.int8:
        raise TypeError(f"conv_int8: int8 operands, got {x_q.dtype} and {w_q.dtype}")
    cout, cin, kh, kw = w_q.shape
    if x_q.shape[-1] != cin:
        raise ValueError(f"conv_int8: input has {x_q.shape[-1]} channels, "
                         f"weight expects {cin}")
    cols, out_bhw = im2col_nhwc(x_q, kh, kw, padding, dilation, strides)
    m, k = cols.shape
    m_pad, k_pad, n_pad = max(m, 17), _round_up(k, 8), _round_up(cout, 8)
    if (m_pad, k_pad) != (m, k):
        cols = F.pad(cols, (0, k_pad - k, 0, m_pad - m))
    # (Cout, kh, kw, Cin) rows, transposed: a column-major (K, Cout) view
    w_rows = w_q.permute(0, 2, 3, 1).reshape(cout, k)
    if (n_pad, k_pad) != (cout, k):
        w_rows = F.pad(w_rows, (0, k_pad - k, 0, n_pad - cout))
    acc = torch._int_mm(cols, w_rows.t())
    if (m_pad, n_pad) != (m, cout):
        acc = acc[:m, :cout]
    return acc.reshape(*out_bhw, cout)


_SEGHEAD_KEYS = ("0.weight", "1.weight", "1.bias", "1.running_mean",
                 "1.running_var", "4.weight", "4.bias")


def _require(head: Mapping[str, torch.Tensor], key: str, shape: str = "SegHead"):
    if key not in head:
        raise ValueError(
            f"int8_decode requires a {shape}-shaped decoder (state_dict[{key}] "
            f"missing) — it supports the pspnet cls head and the deeplabv3 "
            f"classifier; use bf16 decode for other archs")
    return head[key]


def int8_seghead_decode(head: Mapping[str, torch.Tensor], f: torch.Tensor,
                        dtype: torch.dtype = torch.bfloat16, eps: float = 1e-5,
                        act_absmax=None) -> torch.Tensor:
    """SegHead eval forward with the 3x3 conv in int8 (BN folded).

    head: the head's state (``model.cls.state_dict()`` keys: ``0.weight``,
    ``1.{weight,bias,running_mean,running_var}``, ``4.{weight,bias}``).
    f: (B, H, W, 4096) NHWC features, or int8 features quantized at the
    scale of ``act_absmax``. Returns (B, H, W, classes) logits in ``dtype``;
    the epilogue rounds where the JAX package's does: f32 dequant + bias,
    ReLU, cast to ``dtype``, the 1x1 conv without bias, ``+ b2`` in
    ``dtype``."""
    w1, gamma, beta, mean, var, w2, b2 = (
        _require(head, k) for k in _SEGHEAD_KEYS)
    w_f, b_f = fold_bn(w1, gamma, beta, mean, var, eps)
    w_q, sw = quantize_weight_per_channel(w_f)
    x_q, sx = quantize_activation_dynamic(f, absmax=act_absmax)

    acc = conv_int8(x_q, w_q, padding=((1, 1), (1, 1)))
    y = acc.float() * (sx * sw) + b_f
    y = torch.relu(y).to(dtype)
    out = F.conv2d(y.permute(0, 3, 1, 2), w2.to(dtype))
    return out.permute(0, 2, 3, 1) + b2.to(dtype)


def _deeplab_param(head: Mapping[str, torch.Tensor], key: str):
    return _require(head, key, "DeepLabHead")


def _fold_quant(head: Mapping[str, torch.Tensor], conv: str, bn: str, eps: float):
    """Fold a conv + BN pair of ``head`` and quantize the folded weight:
    (w_q, sw, b_f)."""
    w_f, b_f = fold_bn(_deeplab_param(head, f"{conv}.weight"), *(
        _deeplab_param(head, f"{bn}.{k}")
        for k in ("weight", "bias", "running_mean", "running_var")), eps)
    w_q, sw = quantize_weight_per_channel(w_f)
    return w_q, sw, b_f


def int8_deeplab_decode(head: Mapping[str, torch.Tensor], f: torch.Tensor,
                        dtype: torch.dtype = torch.bfloat16, rates=(12, 24, 36),
                        eps: float = 1e-5, act_absmax=None) -> torch.Tensor:
    """DeepLabHead eval forward with its heavy convs in int8 (BN folded).

    head: the head's state (``model.classifier.state_dict()`` keys: ASPP
    ``0.convs.{0..3}.{0,1}``, pooling branch ``0.convs.4.{1,2}``,
    ``0.project.{0,1}``, then ``1``, ``2``, ``4``). f: (B, H, W, 2048) NHWC
    features, or int8 features quantized at the scale of ``act_absmax``.
    Returns (B, H, W, classes) logits in ``dtype``, rounded where the JAX
    package's are:

    - the ASPP 1x1 and the three dilated 3x3 convs share the input's scale;
      each is ``conv_int8``, then ``acc * (sx * sw) + b_f`` and ReLU in
      float32;
    - the pooling branch works on the dequantized input (``x_q * sx``): a
      float32 mean, a BN-folded float32 1x1 and ReLU, resized back with
      align_corners=False;
    - the 1280-channel concat and the projection's output are each
      quantized at a dynamic per-call scale, so a batch decodes as one call;
    - the trailing 3x3 is int8; the classifier 1x1 runs in ``dtype`` and
      adds its bias in ``dtype``.

    Each im2col is freed when its conv returns, so the branches' patch
    matrices do not add up."""
    h, w = f.shape[1], f.shape[2]
    x_q, sx = quantize_activation_dynamic(f, absmax=act_absmax)

    branches = []
    for i, r in enumerate((0,) + tuple(rates)):
        w_q, sw, b_f = _fold_quant(head, f"0.convs.{i}.0", f"0.convs.{i}.1", eps)
        dil = (r, r) if r else (1, 1)
        acc = conv_int8(x_q, w_q, padding=((r, r), (r, r)), dilation=dil)
        branches.append(torch.relu(acc.float() * (sx * sw) + b_f))

    # the image-pooling branch, full precision on the dequantized input
    f_real = x_q.float() * sx if f.dtype == torch.int8 else f.float()
    y = f_real.mean(dim=(1, 2), keepdim=True)
    del f_real
    wp, bp = fold_bn(*(_deeplab_param(head, k) for k in (
        "0.convs.4.1.weight", "0.convs.4.2.weight", "0.convs.4.2.bias",
        "0.convs.4.2.running_mean", "0.convs.4.2.running_var")), eps)
    y = torch.relu(torch.einsum("bhwi,oi->bhwo", y, wp[:, :, 0, 0]) + bp)
    branches.append(resize_bilinear(y, (h, w), align_corners=False))

    cat = torch.cat(branches, dim=-1)
    del branches
    c_q, sc = quantize_activation_dynamic(cat)
    del cat
    w_q, sw, b_f = _fold_quant(head, "0.project.0", "0.project.1", eps)
    acc = conv_int8(c_q, w_q, padding=((0, 0), (0, 0)))
    proj = torch.relu(acc.float() * (sc * sw) + b_f)

    p_q, sp = quantize_activation_dynamic(proj)
    w_q, sw, b_f = _fold_quant(head, "1", "2", eps)
    acc = conv_int8(p_q, w_q, padding=((1, 1), (1, 1)))
    y = torch.relu(acc.float() * (sp * sw) + b_f).to(dtype)
    out = F.conv2d(y.permute(0, 3, 1, 2), _deeplab_param(head, "4.weight").to(dtype))
    return out.permute(0, 2, 3, 1) + head["4.bias"].to(dtype)


def seghead_decode_folded_f32(head: Mapping[str, torch.Tensor], f: torch.Tensor,
                              eps: float = 1e-5) -> torch.Tensor:
    """Full-precision BN-folded SegHead eval forward: the oracle for the
    folding algebra (equals the unfolded head in float32 up to rounding)."""
    w_f, b_f = fold_bn(head["0.weight"], head["1.weight"], head["1.bias"],
                       head["1.running_mean"], head["1.running_var"], eps)
    y = F.conv2d(f.float().permute(0, 3, 1, 2), w_f, b_f, padding=1)
    y = torch.relu(y)
    out = F.conv2d(y, head["4.weight"].float(), head["4.bias"].float())
    return out.permute(0, 2, 3, 1)


# ------------------------------------------------------------ int8 encoder

# blocks a stage by depth (models/resnet.py::DEPTH_BLOCKS)
_TRUNK_BLOCKS = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3), 152: (3, 8, 36, 3)}


def _trunk_param(sd: Mapping[str, torch.Tensor], key: str):
    if key not in sd:
        raise ValueError(
            f"int8_encode requires a ResNet trunk (state_dict[{key}] missing) — it "
            f"supports the pspnet/deeplabv3 ResNet trunks; use the bf16 encoder for "
            f"other archs")
    return sd[key]


def _trunk_fold(sd: Mapping[str, torch.Tensor], conv: str, bn: str, eps: float):
    """The BN ``bn`` folded into the bias-free conv ``conv``: (w_f, b_f)."""
    return fold_bn(_trunk_param(sd, f"{conv}.weight"), *(
        _trunk_param(sd, f"{bn}.{k}")
        for k in ("weight", "bias", "running_mean", "running_var")), eps)


def _int8_conv_bn(sd, conv: str, bn: str, x_q: torch.Tensor, sx, *, strides=(1, 1),
                  padding: Pairs = ((0, 0), (0, 0)), dilation=(1, 1), eps: float = 1e-5,
                  relu: bool = True) -> torch.Tensor:
    """One quantized conv + folded BN (+ ReLU): int8 input at scale ``sx``
    -> float32, ``acc * (sx * sw) + b_f``."""
    w_f, b_f = _trunk_fold(sd, conv, bn, eps)
    w_q, sw = quantize_weight_per_channel(w_f)
    acc = conv_int8(x_q, w_q, padding=padding, dilation=dilation, strides=strides)
    y = acc.float() * (sx * sw) + b_f
    return torch.relu(y) if relu else y


def _conv_bn_relu_folded(sd, conv: str, bn: str, x: torch.Tensor, *, stride: int = 1,
                         padding: int = 1, dtype: torch.dtype = torch.bfloat16,
                         eps: float = 1e-5) -> torch.Tensor:
    """The stem: a conv with its BN folded on operands rounded to ``dtype``,
    summed in float32 (the JAX package's ``preferred_element_type=float32``:
    no rounding to ``dtype`` before the bias and the ReLU; TF32 off), then
    ``relu(y + b_f)`` cast to ``dtype``. NHWC in and out."""
    w_f, b_f = _trunk_fold(sd, conv, bn, eps)
    with full_precision_f32():
        y = F.conv2d(x.to(dtype).float().permute(0, 3, 1, 2), w_f.to(dtype).float(),
                     stride=stride, padding=padding)
    return torch.relu(y.permute(0, 2, 3, 1) + b_f).to(dtype)


def _int8_bottleneck(sd, p: str, x: torch.Tensor, stride: int, dilation: int,
                     dtype: torch.dtype, eps: float) -> torch.Tensor:
    """models/resnet.py::Bottleneck eval forward (block ``p``, e.g.
    "layer2.0"), the three bias-free convs and the downsample in int8 with
    their BNs folded. The block input is quantized once: conv1 and the
    downsample share its scale. The residual add and the ReLU are float32."""
    x_q, sx = quantize_activation_dynamic(x)
    y = _int8_conv_bn(sd, f"{p}.conv1", f"{p}.bn1", x_q, sx, eps=eps).to(dtype)
    y_q, sy = quantize_activation_dynamic(y)
    d = (dilation, dilation)
    y = _int8_conv_bn(sd, f"{p}.conv2", f"{p}.bn2", y_q, sy, strides=(stride, stride),
                      padding=(d, d), dilation=d, eps=eps).to(dtype)
    y_q, sy = quantize_activation_dynamic(y)
    y = _int8_conv_bn(sd, f"{p}.conv3", f"{p}.bn3", y_q, sy, relu=False, eps=eps)
    if f"{p}.downsample.0.weight" in sd:
        residual = _int8_conv_bn(sd, f"{p}.downsample.0", f"{p}.downsample.1", x_q, sx,
                                 strides=(stride, stride), relu=False, eps=eps)
    else:
        residual = x.float()
    return torch.relu(y + residual).to(dtype)


def _dilations(n: int, new: int, prev: int, semseg: bool):
    if new == 1:
        return [1] * n
    if semseg:
        return [new] * n
    return [prev] + [new] * (n - 1)


def int8_resnet_trunk(trunk: Mapping[str, torch.Tensor], x: torch.Tensor, *,
                      depth: int = 50, deep_base: bool = True,
                      semseg_dilation: bool = True, dtype: torch.dtype = torch.bfloat16,
                      eps: float = 1e-5) -> torch.Tensor:
    """models/resnet.py::ResNetFeatures eval forward (the dilated stride-8
    trunks of both flow backbones) with every bottleneck conv in int8.

    trunk: the trunk's state by the port's names: the PSPNet stem
    ``layer0.{0,1,3,4,6,7}`` (``deep_base``) or torchvision's
    ``conv1``/``bn1``, and ``layerX.Y.convZ/bnZ/downsample.{0,1}``; PSPNet's
    whole state_dict serves, DeepLabV3's ``backbone``'s. x: (B, H, W, 3)
    NHWC normalised frames. ``semseg_dilation``: every block of layer3 at
    dilation 2 and of layer4 at 4 (PSPNet), else the first block of each
    keeps the previous stage's (torchvision). Returns c4 (B, H/8, W/8, 2048)
    in ``dtype``. Every scale stays on the device (no read-back)."""
    blocks = _TRUNK_BLOCKS[depth]
    if deep_base:
        for conv, bn, stride in (("layer0.0", "layer0.1", 2), ("layer0.3", "layer0.4", 1),
                                 ("layer0.6", "layer0.7", 1)):
            x = _conv_bn_relu_folded(trunk, conv, bn, x, stride=stride, padding=1,
                                     dtype=dtype, eps=eps)
    else:
        x = _conv_bn_relu_folded(trunk, "conv1", "bn1", x, stride=2, padding=3, dtype=dtype,
                                 eps=eps)
    x = max_pool(x, 3, 2, 1)
    stages = (("layer1", 1, [1] * blocks[0]), ("layer2", 2, [1] * blocks[1]),
              ("layer3", 1, _dilations(blocks[2], 2, 1, semseg_dilation)),
              ("layer4", 1, _dilations(blocks[3], 4, 2, semseg_dilation)))
    for name, stride, dils in stages:
        for i, d in enumerate(dils):
            x = _int8_bottleneck(trunk, f"{name}.{i}", x, stride if i == 0 else 1, d, dtype,
                                 eps)
    return x


def ppm_folded(ppm: Mapping[str, torch.Tensor], f: torch.Tensor, bins=(1, 2, 3, 6),
               dtype: torch.dtype = torch.bfloat16, eps: float = 1e-5) -> torch.Tensor:
    """models/pspnet.py::PPM eval forward with each bin's BN folded into its
    1x1 conv, in float32 (the bin maps are at most 6x6): adaptive average
    pool of ``f`` in float32, the folded 1x1 and ReLU, cast to ``dtype`` and
    resized back (align_corners=True). ppm: the PPM's state
    (``features.i.1.weight``, ``features.i.2.*``). Returns (B, H, W, 2 C)."""
    h, w = f.shape[1], f.shape[2]
    out = [f]
    f32 = f.float()
    for i, b in enumerate(bins):
        y = adaptive_avg_pool(f32, b)
        wp, bp = _trunk_fold(ppm, f"features.{i}.1", f"features.{i}.2", eps)
        y = torch.relu(torch.einsum("bhwi,oi->bhwo", y, wp[:, :, 0, 0]) + bp)
        out.append(resize_bilinear(y.to(dtype), (h, w), align_corners=True))
    return torch.cat(out, dim=-1)
