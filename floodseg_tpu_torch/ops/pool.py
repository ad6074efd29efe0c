"""Pooling in NHWC.

- ``adaptive_avg_pool`` reproduces ``nn.AdaptiveAvgPool2d`` (the PPM bins)
  as separable averaging matrices with torch's bin edges, as
  floodseg_tpu/ops/pool.py does.
- ``max_pool`` reproduces ``nn.MaxPool2d`` (the ResNet stem's 3/2/1), which
  pads with -inf.
- ``global_avg_pool`` is the mean over H and W (ASPP's pooling branch).
"""

from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F


@lru_cache(maxsize=128)
def _adaptive_avg_matrix(in_size: int, out_size: int) -> np.ndarray:
    """(out_size, in_size) averaging matrix with torch's adaptive bin edges."""
    m = np.zeros((out_size, in_size), dtype=np.float32)
    for i in range(out_size):
        start = (i * in_size) // out_size
        end = -(-((i + 1) * in_size) // out_size)  # ceil
        m[i, start:end] = 1.0 / (end - start)
    return m


@lru_cache(maxsize=128)
def _adaptive_avg_tensor(in_size, out_size, dtype, device):
    # cached on the device, made outside inference mode (see
    # ops/resize.py::_interp_tensor)
    with torch.inference_mode(False):
        return torch.as_tensor(_adaptive_avg_matrix(in_size, out_size),
                               dtype=dtype, device=device)


def adaptive_avg_pool(x: torch.Tensor, output_size) -> torch.Tensor:
    """Adaptive average pool NHWC ``x`` to spatial ``output_size=(H, W)``."""
    if isinstance(output_size, int):
        output_size = (output_size, output_size)
    h_out, w_out = output_size
    _, h_in, w_in, _ = x.shape
    cdt = torch.promote_types(x.dtype, torch.float32)
    mh = _adaptive_avg_tensor(h_in, h_out, cdt, x.device)
    mw = _adaptive_avg_tensor(w_in, w_out, cdt, x.device)
    y = x.to(cdt)
    y = torch.einsum("oh,bhwc->bowc", mh, y)
    y = torch.einsum("pw,bhwc->bhpc", mw, y)
    return y.to(x.dtype)


def max_pool(x: torch.Tensor, window: int = 3, stride: int = 2,
             padding: int = 1) -> torch.Tensor:
    """Max pool NHWC ``x`` (``nn.MaxPool2d`` semantics, -inf padding)."""
    y = F.max_pool2d(x.permute(0, 3, 1, 2), window, stride, padding)
    return y.permute(0, 2, 3, 1)


def global_avg_pool(x: torch.Tensor) -> torch.Tensor:
    """Mean of NHWC ``x`` over H and W, kept as (B, 1, 1, C). As ``jnp.mean``
    does, a bf16 input is summed and divided in float32 and the mean cast
    back to bf16."""
    cdt = torch.promote_types(x.dtype, torch.float32)
    return x.to(cdt).mean(dim=(1, 2), keepdim=True).to(x.dtype)
