"""Building blocks with the JAX package's dtype semantics (NCHW inside).

Counterpart of floodseg_tpu/models/layers.py. A ``dtype`` argument behaves
like flax's ``dtype=..., param_dtype=float32`` pair: parameters and buffers
are held in float32 and the layer computes in ``dtype``.

The modules work on NCHW-shaped tensors, as PyTorch's convolutions do; on
the card they are channels-last in memory, so the permute to the NHWC
layout of the public functions costs nothing.
"""

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from floodseg_tpu_torch.ops.pool import max_pool


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` (explicit symmetric padding, dilation) whose float32
    parameters are cast to ``dtype`` for the product."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, padding: int = 0, dilation: int = 1,
                 bias: bool = True, dtype: torch.dtype = torch.float32):
        super().__init__(in_channels, out_channels, kernel_size, stride=stride,
                         padding=padding, dilation=dilation, bias=bias)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return F.conv2d(x.to(dt), self.weight.to(dt), bias, self.stride,
                        self.padding, self.dilation)


class BatchNorm2d(nn.BatchNorm2d):
    """Eval BatchNorm as floodseg_tpu's ``TorchBatchNorm``: the running
    statistics normalise, the affine runs in ``promote_types(dtype,
    float32)``, and the result is cast to ``dtype``. eps is 1e-5.

    This slice is inference only; the training-mode update of the running
    statistics (torch's unbiased running variance) comes with the training
    slice, and a module in training mode raises.
    """

    def __init__(self, num_features: int, dtype: torch.dtype = torch.float32):
        super().__init__(num_features, eps=1e-5, momentum=0.1)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            raise NotImplementedError(
                "BatchNorm2d in training mode belongs to the training slice "
                "of the port; call .eval() first")
        dt = torch.promote_types(self.compute_dtype, torch.float32)
        shape = (1, -1, 1, 1)
        mean = self.running_mean.to(dt).view(shape)
        inv = torch.rsqrt(self.running_var.to(dt) + self.eps).view(shape)
        y = (x.to(dt) - mean) * inv
        y = y * self.weight.to(dt).view(shape) + self.bias.to(dt).view(shape)
        return y.to(self.compute_dtype)


class MaxPool(nn.Module):
    """``nn.MaxPool2d`` through ops.pool.max_pool (NCHW in and out)."""

    def __init__(self, window: int = 3, stride: int = 2, padding: int = 1):
        super().__init__()
        self.window, self.stride, self.padding = window, stride, padding

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = max_pool(x.permute(0, 2, 3, 1), self.window, self.stride, self.padding)
        return y.permute(0, 3, 1, 2)


_BN_JITTER = 0.1


@torch.no_grad()
def init_from_generator_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Random weights drawn from ``generator`` alone, in module order.

    Convolutions get He-normal weights (fan-in) and small biases. Every
    BatchNorm gets its scale, bias, running mean and running variance
    perturbed by about 10% so that no BN is the identity; the last BN of
    each residual branch (``bn3``) is scaled down so that activations stay
    in range through the residual stack, as zero-init-residual schemes do.
    """
    for name, m in module.named_modules():
        if isinstance(m, nn.Conv2d):
            fan_in = m.in_channels * m.kernel_size[0] * m.kernel_size[1] // m.groups
            m.weight.normal_(0.0, math.sqrt(2.0 / fan_in), generator=generator)
            if m.bias is not None:
                m.bias.normal_(0.0, 0.01, generator=generator)
        elif isinstance(m, nn.BatchNorm2d):
            scale = 0.2 if name.endswith("bn3") else 1.0
            m.weight.normal_(1.0, _BN_JITTER, generator=generator).mul_(scale)
            m.bias.normal_(0.0, _BN_JITTER, generator=generator)
            m.running_mean.normal_(0.0, _BN_JITTER, generator=generator)
            m.running_var.uniform_(1.0 - _BN_JITTER, 1.0 + _BN_JITTER,
                                   generator=generator)
    return module
