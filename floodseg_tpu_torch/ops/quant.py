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

Not here yet: ``int8_resnet_trunk`` and ``ppm_folded`` (the int8 encoder),
``int8_auto_default`` (the port's benchmark decides the H100 default).
"""

from typing import Mapping, Sequence, Tuple

import torch
import torch.nn.functional as F

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
