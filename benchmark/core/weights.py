"""Weights made from the seed, on the device, in two large draws.

A configuration lists its tensors as (name, shape, kind). One normal draw
covers every tensor but the BN variances, one uniform draw those; each
tensor is then a view of a draw, scaled in place:

- conv: He-normal, standard deviation sqrt(2 / fan-in);
- bias: normal, 0.01;
- bn, bn_last: scale 1 + 0.1 z (times 0.2 for the last BN of a residual
  branch, as zero-init-residual schemes damp it), bias, running mean 0.1 z,
  running variance uniform on [0.9, 1.1], so that no BN is the identity.

The weights are float32, the type the program holds its parameters in.
"""

import math
from typing import Dict, List, Tuple

import torch

JITTER = 0.1
LAST_BN_SCALE = 0.2


def _bn_names(name: str) -> List[str]:
    return [f"{name}.{k}" for k in ("weight", "bias", "running_mean", "running_var")]


def make_weights(spec: List[Tuple[str, tuple, str]], seed: int,
                 device: torch.device) -> Dict[str, torch.Tensor]:
    sizes_n, sizes_u = 0, 0
    for _, shape, kind in spec:
        n = math.prod(shape)
        if kind.startswith("bn"):
            sizes_n += 3 * n
            sizes_u += n
        else:
            sizes_n += n
    gen = torch.Generator(device=device).manual_seed(seed)
    z = torch.randn(sizes_n, generator=gen, device=device)
    u = torch.rand(sizes_u, generator=gen, device=device)
    out: Dict[str, torch.Tensor] = {}
    iz = iu = 0

    def take_z(shape):
        nonlocal iz
        n = math.prod(shape)
        t = z[iz:iz + n].view(shape)
        iz += n
        return t

    with torch.no_grad():
        for name, shape, kind in spec:
            if kind == "conv":
                fan_in = math.prod(shape[1:])
                out[name] = take_z(shape).mul_(math.sqrt(2.0 / fan_in))
            elif kind == "bias":
                out[name] = take_z(shape).mul_(0.01)
            else:
                w, b, m, v = _bn_names(name)
                scale = LAST_BN_SCALE if kind == "bn_last" else 1.0
                out[w] = take_z(shape).mul_(JITTER).add_(1.0).mul_(scale)
                out[b] = take_z(shape).mul_(JITTER)
                out[m] = take_z(shape).mul_(JITTER)
                n = math.prod(shape)
                out[v] = u[iu:iu + n].view(shape).mul_(2 * JITTER).add_(1.0 - JITTER)
                iu += n
    return out


def parameter_names(spec: List[Tuple[str, tuple, str]]) -> List[str]:
    """The trainable tensors' names (BN's scale and bias, not its
    statistics)."""
    names = []
    for name, _, kind in spec:
        names += _bn_names(name)[:2] if kind.startswith("bn") else [name]
    return names
