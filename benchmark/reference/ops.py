"""The reference's layers, over a ``Params`` mapping of torch-named tensors.

Every convolution goes through ``conv``, which also counts its operations
when the mapping carries a ``FlopCounter``: the benchmark runs the
reference on the meta device to count a model's FLOPs from its shapes
alone, so the count does not depend on what implements the work.
"""

import contextlib
from typing import Dict, Iterator, Optional

import torch
import torch.nn.functional as F

# data/transforms.py's normalisation in the published repository: ImageNet's
# mean and standard deviation in pixel units
MEAN = (0.485 * 255, 0.456 * 255, 0.406 * 255)
STD = (0.229 * 255, 0.224 * 255, 0.225 * 255)


@contextlib.contextmanager
def full_float32() -> Iterator[None]:
    """TF32 off for cuDNN convolutions and CUDA matrix products inside the
    block (PyTorch lets cuDNN use TF32 by default), so that float32 means
    float32; the previous flags are restored after it."""
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    prev = (cudnn.allow_tf32, matmul.allow_tf32)
    cudnn.allow_tf32 = matmul.allow_tf32 = False
    try:
        yield
    finally:
        cudnn.allow_tf32, matmul.allow_tf32 = prev


class FlopCounter:
    """Operations of convolutions and matrix products, two to a
    multiply-add. ``forward`` counts every convolution; ``backward`` the
    weight gradient of each and the input gradient of each whose input
    needs one."""

    def __init__(self):
        self.forward = 0
        self.backward = 0

    def conv(self, x: torch.Tensor, w: torch.Tensor, out: torch.Tensor) -> None:
        cout, cin_g, kh, kw = w.shape
        flops = 2 * out.shape[0] * out.shape[2] * out.shape[3] * cout * cin_g * kh * kw
        self.forward += flops
        if w.requires_grad:
            self.backward += flops
        if x.requires_grad:
            self.backward += flops

    @property
    def step(self) -> int:
        return self.forward + self.backward


class Params(dict):
    """name -> tensor, with an optional ``FlopCounter``."""

    def __init__(self, tensors: Dict[str, torch.Tensor], counter: Optional[FlopCounter] = None,
                 tf32: bool = False):
        super().__init__(tensors)
        self.counter = counter
        # round every convolution's operands to TF32 (the control's precision)
        self.tf32 = tf32


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32's 10-bit mantissa (to nearest, ties away),
    kept in float32: a product of two such values is exact in float32, so
    a float32 convolution of rounded operands is a TF32 convolution."""
    bits = x.contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


class _TF32Conv(torch.autograd.Function):
    """A convolution whose operands, forward and backward, are rounded to
    TF32, with float32 sums: what cuDNN computes with TF32 on."""

    @staticmethod
    def forward(ctx, x, w, b, stride, padding, dilation):
        xr, wr = round_tf32(x), round_tf32(w)
        ctx.save_for_backward(xr, wr)
        ctx.conf = (stride, padding, dilation, b is not None)
        return F.conv2d(xr, wr, b, stride, padding, dilation)

    @staticmethod
    def backward(ctx, grad):
        xr, wr = ctx.saved_tensors
        stride, padding, dilation, has_bias = ctx.conf
        g = round_tf32(grad)
        gx = torch.nn.grad.conv2d_input(xr.shape, wr, g, stride, padding, dilation)
        gw = torch.nn.grad.conv2d_weight(xr, wr.shape, g, stride, padding, dilation)
        gb = grad.sum(dim=(0, 2, 3)) if has_bias else None
        return gx, gw, gb, None, None, None


def conv(p: Params, name: str, x: torch.Tensor, stride: int = 1, padding: int = 0,
         dilation: int = 1) -> torch.Tensor:
    w = p[name + ".weight"]
    b = p.get(name + ".bias")
    if p.tf32 and x.device.type != "meta":
        out = _TF32Conv.apply(x, w, b, stride, padding, dilation)
    else:
        out = F.conv2d(x, w, b, stride, padding, dilation)
    if p.counter is not None:
        p.counter.conv(x, w, out)
    return out


def bn(p: Params, name: str, x: torch.Tensor, train: bool) -> torch.Tensor:
    """BatchNorm, eps 1e-5: the running statistics in eval; in training the
    batch's (biased variance), running statistics left alone."""
    if train:
        return F.batch_norm(x, None, None, p[name + ".weight"], p[name + ".bias"],
                            training=True, eps=1e-5)
    return F.batch_norm(x, p[name + ".running_mean"], p[name + ".running_var"],
                        p[name + ".weight"], p[name + ".bias"], training=False, eps=1e-5)


def conv_bn_relu(p: Params, conv_name: str, bn_name: str, x: torch.Tensor, train: bool,
                 **kw) -> torch.Tensor:
    return F.relu(bn(p, bn_name, conv(p, conv_name, x, **kw), train))


def resize(x: torch.Tensor, size, align_corners: bool) -> torch.Tensor:
    """Bilinear resize of NCHW ``x`` to ``size`` (no antialiasing)."""
    if tuple(x.shape[-2:]) == tuple(size):
        return x
    return F.interpolate(x, size=tuple(size), mode="bilinear", align_corners=align_corners)


def dropout(x: torch.Tensor, keep: Optional[torch.Tensor], rate: float) -> torch.Tensor:
    """x / keep_prob where ``keep``, else 0; the identity without a mask.
    keep_prob is rounded to x's dtype first (flax's scalar divide)."""
    if keep is None:
        return x
    scale = float(torch.tensor(1.0 - rate, dtype=x.dtype))
    return torch.where(keep, x / scale, torch.zeros_like(x))


def normalize(frames: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 3) pixel values -> (B, 3, H, W) float32 normalised."""
    mean = torch.tensor(MEAN, dtype=torch.float32, device=frames.device)
    std = torch.tensor(STD, dtype=torch.float32, device=frames.device)
    return ((frames.to(torch.float32) - mean) / std).permute(0, 3, 1, 2)
