"""Building blocks with the JAX package's dtype semantics (NCHW inside).

Counterpart of floodseg_tpu/models/layers.py. A ``dtype`` argument behaves
like flax's ``dtype=..., param_dtype=float32`` pair: parameters and buffers
are held in float32 and the layer computes in ``dtype``.

The convolution modules work on NCHW-shaped tensors, as PyTorch's
convolutions do; on the card they are channels-last in memory, so the
permute to the NHWC layout of the public functions costs nothing.
``Linear`` and ``LayerNorm`` (the ViT's) act on the last axis.
"""

import contextlib
import math
from typing import Iterator, Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from floodseg_tpu_torch.ops.pool import max_pool
from floodseg_tpu_torch.parallel.mesh import all_reduce_sum, shard


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
    """BatchNorm as floodseg_tpu's ``TorchBatchNorm``, eps 1e-5.

    Eval: the running statistics normalise, the affine runs in
    ``promote_types(dtype, float32)``, and the result is cast to ``dtype``.

    Training, in the JAX package's order rather than torch's two-pass
    variance: the batch mean and E[x^2] over (N, H, W) at >= float32, the
    variance max(E[x^2] - mean^2, 0), which normalises (biased); the running
    statistics become 0.9 * running + 0.1 * batch statistic in place and
    without a gradient, the variance's unbiased by n / (n - 1) with n the
    elements a channel (torch's rule). ``num_batches_tracked`` is not used.

    Synchronised over the ranks of ``world`` (set by ``data_parallel``)
    when it has more than one: the per-channel sums of x and x^2 and the
    element count are summed over the ranks (parallel/mesh.py::
    all_reduce_sum, whose backward sums the gradients too), and the mean,
    E[x^2] and n are the global batch's, in the same order.
    """

    def __init__(self, num_features: int, dtype: torch.dtype = torch.float32):
        super().__init__(num_features, eps=1e-5, momentum=0.1)
        self.compute_dtype = dtype
        self.world = None
        # False while a rematerialised block is recomputed (models/resnet.py):
        # the statistics moved once, in the forward
        self.update_running = True

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = torch.promote_types(self.compute_dtype, torch.float32)
        shape = (1, -1, 1, 1)
        xc = x.to(dt)
        if self.training and self.world is not None and self.world.parallel:
            # every rank holds an equal slice, so n is the local count times
            # the ranks (no read-back)
            c = x.shape[1]
            n = x.numel() / c * self.world.size
            sums = all_reduce_sum(torch.cat([xc.sum(dim=(0, 2, 3)), (xc * xc).sum(dim=(0, 2, 3))]),
                                  self.world)
            mean = sums[:c] / n
            var = torch.clamp_min(sums[c:] / n - mean * mean, 0.0)
            self._update_running(mean, var, n)
        elif self.training:
            mean = xc.mean(dim=(0, 2, 3))
            var = torch.clamp_min((xc * xc).mean(dim=(0, 2, 3)) - mean * mean, 0.0)
            self._update_running(mean, var, x.numel() / x.shape[1])
        else:
            mean = self.running_mean.to(dt)
            var = self.running_var.to(dt)
        y = (xc - mean.view(shape)) * torch.rsqrt(var + self.eps).view(shape)
        y = y * self.weight.to(dt).view(shape) + self.bias.to(dt).view(shape)
        return y.to(self.compute_dtype)

    @torch.no_grad()
    def _update_running(self, mean: torch.Tensor, var: torch.Tensor, n: float) -> None:
        if not self.update_running:
            return
        m = 0.9
        rm, rv = self.running_mean, self.running_var
        rm.copy_(m * rm + (1.0 - m) * mean.detach().to(rm.dtype))
        unbiased = var.detach() * (n / max(n - 1, 1))
        rv.copy_(m * rv + (1.0 - m) * unbiased.to(rv.dtype))


class Dropout(nn.Module):
    """flax's ``nn.Dropout(rate, broadcast_dims)``: in training each element
    (each slice along the axes not in ``broadcast_dims``) is kept with
    probability 1 - rate, ``where(keep, x / keep_prob, 0)`` with keep_prob
    rounded to x's dtype first, as flax divides by a weakly typed scalar
    (torch's ``x * mask / keep_prob`` rounds otherwise); in eval the
    identity. ``broadcast_dims`` are axes of the tensor the module is given:
    (2, 3) on an NCHW map is flax's channel dropout over NHWC's (1, 2) (the
    PSPNet SegHead's, the reference's ``nn.Dropout2d``); () is element
    dropout (DeepLabV3's heads, the ViT).

    The keep mask is ``keep`` when a caller has set it (a bool tensor that
    broadcasts to x; the tests inject flax's masks), else drawn with
    ``torch.rand(shape, generator=generator) < keep_prob`` on x's device.
    The training steps set ``generator`` for each call
    (``dropout_generator``); without either, training mode raises: the port
    never draws from torch's global generator.

    Under ``data_parallel`` with more than one rank, x is this rank's slice
    of the global batch: a mask with a batch axis (not in
    ``broadcast_dims``) is drawn at the global shape from the generator
    every rank shares, and this rank's rows are taken, so that each rank
    drops what the one-rank step on the global batch drops. A ``keep``
    of the global batch is sliced the same way.
    """

    def __init__(self, rate: float = 0.1, broadcast_dims: Sequence[int] = ()):
        super().__init__()
        self.rate = rate
        self.broadcast_dims = tuple(broadcast_dims)
        self.generator: Optional[torch.Generator] = None
        self.keep: Optional[torch.Tensor] = None
        self.world = None

    def extra_repr(self) -> str:
        return f"rate={self.rate}, broadcast_dims={self.broadcast_dims}"

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.rate == 0.0:
            return x
        if self.rate == 1.0:
            return torch.zeros_like(x)
        keep_prob = 1.0 - self.rate
        keep = self.keep
        world = self.world if self.world is not None and self.world.parallel else None
        sliced = world is not None and 0 not in self.broadcast_dims
        if keep is None:
            if self.generator is None:
                raise RuntimeError("Dropout in training mode needs a keep mask "
                                   "or a generator (dropout_generator)")
            shape = [1 if d in self.broadcast_dims else n for d, n in enumerate(x.shape)]
            if sliced:
                shape[0] *= world.size
            keep = torch.rand(shape, generator=self.generator, device=x.device) < keep_prob
        if sliced and keep.shape[0] == x.shape[0] * world.size:
            keep = shard(keep, world)
        scale = float(torch.tensor(keep_prob, dtype=x.dtype))
        return torch.where(keep.to(x.device), x / scale, torch.zeros_like(x))


@contextlib.contextmanager
def data_parallel(module: nn.Module, world) -> Iterator[None]:
    """Every ``BatchNorm2d`` and ``Dropout`` in ``module`` takes part in the
    global batch of ``world`` (parallel/mesh.py::World) inside the block:
    synchronised statistics, global-shape masks. Nothing is set for a
    world of one or None."""
    if world is None or not world.parallel:
        yield
        return
    mods = [m for m in module.modules() if isinstance(m, (BatchNorm2d, Dropout))]
    prev = [m.world for m in mods]
    for m in mods:
        m.world = world
    try:
        yield
    finally:
        for m, w in zip(mods, prev):
            m.world = w


@contextlib.contextmanager
def dropout_generator(module: nn.Module,
                      generator: Optional[torch.Generator]) -> Iterator[None]:
    """Every ``Dropout`` in ``module`` draws from ``generator`` inside the
    block; the previous generators are restored after it."""
    drops = [m for m in module.modules() if isinstance(m, Dropout)]
    prev = [m.generator for m in drops]
    for m in drops:
        m.generator = generator
    try:
        yield
    finally:
        for m, g in zip(drops, prev):
            m.generator = g


class Linear(nn.Linear):
    """flax's ``nn.Dense(dtype=..., param_dtype=float32,
    precision="highest")``: the float32 weight and bias are cast to
    ``dtype``, the product is rounded to ``dtype``, and the bias is added
    after it, a second rounding in bf16 as in the JAX package (a fused
    bias, as ``F.linear`` may take on the card, rounds once)."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__(in_features, out_features, bias=bias)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        y = torch.matmul(x.to(dt), self.weight.to(dt).t())
        return y if self.bias is None else y + self.bias.to(dt)


class LayerNorm(nn.LayerNorm):
    """flax 0.12's ``nn.LayerNorm(epsilon=1e-5, dtype=...)`` over the last
    axis, in its order: mean and the fast variance max(0, E[x^2] - E[x]^2)
    in ``promote_types(dtype, float32)``, then ``mul = rsqrt(var + eps) *
    scale`` and ``(x - mean) * mul + bias``, cast to ``dtype``.
    ``F.layer_norm`` takes a two-pass variance in another order and is not
    used."""

    def __init__(self, features: int, dtype: torch.dtype = torch.float32):
        super().__init__(features, eps=1e-5)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        sdt = torch.promote_types(self.compute_dtype, torch.float32)
        xs = x.to(sdt)
        mean = xs.mean(-1, keepdim=True)
        var = torch.clamp_min((xs * xs).mean(-1, keepdim=True) - mean * mean, 0.0)
        mul = torch.rsqrt(var + self.eps) * self.weight.to(sdt)
        return ((xs - mean) * mul + self.bias.to(sdt)).to(self.compute_dtype)


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
    """Random weights drawn from ``generator`` alone, in module order: the
    tests' and the kernel checks' weights, not a model's default (which is
    ``init_flax_defaults_``).

    Convolutions get He-normal weights (fan-in) and small biases. Every
    BatchNorm gets its scale, bias, running mean and running variance
    perturbed by about 10% so that no BN is the identity; the last BN of
    each residual branch (``bn3``) is scaled down so that activations stay
    in range through the residual stack, as zero-init-residual schemes do.

    The ViT's layers: Linear weights normal with variance 1 / fan-in and
    small biases; every LayerNorm's scale and bias perturbed by about 10%,
    so that no LN is the identity; the class and position embeddings
    (``cls_token``, ``pos_embed``, ``cls_emb``) normal at 0.02; the
    MaskTransformer's ``proj_patch`` and ``proj_classes`` normal at
    d**-0.5, the JAX package's init.
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
        elif isinstance(m, nn.Linear):
            m.weight.normal_(0.0, math.sqrt(1.0 / m.in_features), generator=generator)
            if m.bias is not None:
                m.bias.normal_(0.0, 0.01, generator=generator)
        elif isinstance(m, nn.LayerNorm):
            m.weight.normal_(1.0, _BN_JITTER, generator=generator)
            m.bias.normal_(0.0, _BN_JITTER, generator=generator)
        for pname, p in m.named_parameters(recurse=False):
            if pname in ("cls_token", "pos_embed", "cls_emb"):
                p.normal_(0.0, 0.02, generator=generator)
            elif pname in ("proj_patch", "proj_classes"):
                p.normal_(0.0, p.shape[0] ** -0.5, generator=generator)
    return module


# the standard deviation of a unit normal truncated to [-2, 2]: flax's
# variance-scaling initializers divide by it, so that the truncated draw has
# the variance asked for
_TRUNC_STD = 0.87962566103423978
_FLAX_LAYERS = (nn.Conv2d, nn.Linear, nn.BatchNorm2d, nn.LayerNorm)


def _trunc_normal_(p: torch.Tensor, std: float, generator: torch.Generator) -> None:
    """N(0, std) truncated to [-2 std, 2 std] in place, by the inverse CDF
    as ``jax.random.truncated_normal`` draws it: u uniform on [erf(-sqrt 2),
    erf(sqrt 2)], x = sqrt 2 * erfinv(u), clipped to the bounds."""
    lo = math.erf(-math.sqrt(2.0))
    p.uniform_(lo, -lo, generator=generator).erfinv_().mul_(math.sqrt(2.0) * std)
    p.clamp_(-2.0 * std, 2.0 * std)


@torch.no_grad()
def init_flax_defaults_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """A model's initial weights as the JAX package's ``model.init`` draws
    them (flax's defaults and the ViT's own initializers), from
    ``generator`` alone, in module order:

    - every conv and Linear weight ``lecun_normal``: a normal truncated to
      +-2 sigma, sigma = sqrt(1 / fan_in) / 0.8796 so that the draw's
      variance is 1 / fan_in (fan_in = in / groups * kh * kw for a conv,
      in_features for a Linear; the ViT's patch conv has the fan-in of the
      JAX ``patch_proj`` Dense);
    - every bias 0; every BatchNorm scale 1, bias 0, running mean 0 and
      running variance 1; every LayerNorm scale 1 and bias 0;
    - ``cls_token`` 0; ``pos_embed`` and ``cls_emb`` ``truncated_normal(0.02)``
      (std 0.02 on [-0.04, 0.04], no variance correction); ``proj_patch``
      and ``proj_classes`` ``normal(d ** -0.5)``.

    A parameter of any other kind raises. The values are not JAX's draws
    (the generators differ); the distributions are.
    """
    for name, m in module.named_modules():
        for pname, p in m.named_parameters(recurse=False):
            if isinstance(m, (nn.Conv2d, nn.Linear)) and pname == "weight":
                _trunc_normal_(p, math.sqrt(1.0 / p[0].numel()) / _TRUNC_STD, generator)
            elif isinstance(m, _FLAX_LAYERS) and pname == "bias" or pname == "cls_token":
                p.zero_()
            elif isinstance(m, _FLAX_LAYERS) and pname == "weight":
                p.fill_(1.0)
            elif pname in ("pos_embed", "cls_emb"):
                _trunc_normal_(p, 0.02, generator)
            elif pname in ("proj_patch", "proj_classes"):
                p.normal_(0.0, p.shape[0] ** -0.5, generator=generator)
            else:
                raise ValueError(f"no flax default for {name}.{pname} of "
                                 f"{type(m).__name__}")
        if isinstance(m, nn.BatchNorm2d):
            m.running_mean.zero_()
            m.running_var.fill_(1.0)
            m.num_batches_tracked.zero_()
    return module
