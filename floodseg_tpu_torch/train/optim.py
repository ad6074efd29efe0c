"""Optimizers and the learning-rate schedule (counterpart of
floodseg_tpu/train/optim.py).

The JAX package chains optax transforms; the port uses ``torch.optim.SGD``
and ``torch.optim.Adam``, whose semantics the JAX chain reproduces (weight
decay added to the gradient before the momentum or the moments, classic
L2), with two parameter groups: the pretrained trunk at the base LR and
every head at ``head_lr_scale`` times it, or one group when that is 1 (the
s4GAN discriminator's Adam). The poly schedule sets each group's LR before
every step.

``exclude`` is the JAX package's ``exclude_subtrees``: the parameters under
those top-level keys of the JAX tree (the aux heads, ``AUX_KEYS``, for the
s4GAN generator) are left out of the optimizer, so they get no update at
all, no decay and no momentum, whatever gradient reaches them.
"""

from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn

from floodseg_tpu_torch.models.convert import jax_top_level
from floodseg_tpu_torch.models.semi import unwrap

# top-level keys of the JAX tree that belong to the pretrained trunk (LR x1);
# everything else is a head (LR x10)
BACKBONE_KEYS = ("backbone", "encoder")
# the aux heads' top-level keys, which the s4GAN generator freezes
AUX_KEYS = ("aux", "aux_classifier")


def poly_schedule(base_lr: float, max_iter: int, power: float = 0.9) -> Callable:
    """The LR of optimizer step k (0-based): base * (1 - min(k, max) / max)
    ** power, so step 0 runs at the base LR. Computed in float32, as the
    JAX schedule computes it from its int32 step count (also when the
    model is float64)."""
    f32 = np.float32

    def schedule(step: int) -> float:
        frac = f32(1.0) - f32(min(step, max_iter)) / f32(max_iter)
        return float(f32(base_lr) * frac ** f32(power))
    return schedule


def model_arch(model: nn.Module) -> str:
    """The architecture of a port model, from its module tree (through the
    U2PL wrapper, ``ModelRepresentation``)."""
    names = {n.split(".", 1)[0] for n, _ in unwrap(model).named_children()}
    if "ppm" in names:
        return "pspnet"
    if "classifier" in names:
        return "deeplabv3"
    if "encoder" in names:
        return "vit"
    raise ValueError(f"not a port PSPNet, DeepLabV3 or SegmenterViT: {sorted(names)}")


def head_mask(model: nn.Module) -> Dict[str, bool]:
    """Parameter name -> True for a head (10x LR) parameter: every parameter
    whose JAX top-level key (``models/convert.py``'s map) is not the trunk
    (the U2PL rep head is a head)."""
    arch = model_arch(model)
    return {name: jax_top_level(arch, name) not in BACKBONE_KEYS
            for name, _ in model.named_parameters()}


def param_groups(model: nn.Module, base_lr: float, head_lr_scale: float = 10.0,
                 exclude: Sequence[str] = ()) -> List[dict]:
    """The trunk's and the heads' parameters as two groups, each with its
    ``lr_scale``, or all of them as one group when ``head_lr_scale`` is 1
    and nothing is excluded (any module: no architecture is asked for).
    Parameters under the JAX top-level keys in ``exclude`` are in no
    group."""
    if head_lr_scale == 1.0 and not exclude:
        return [{"params": list(model.parameters()), "lr": base_lr, "lr_scale": 1.0}]
    arch = model_arch(model)
    mask = head_mask(model)
    groups = []
    for head, scale in ((False, 1.0), (True, head_lr_scale)):
        params = [p for n, p in model.named_parameters()
                  if mask[n] == head and jax_top_level(arch, n) not in exclude]
        if params:
            groups.append({"params": params, "lr": base_lr * scale, "lr_scale": scale})
    return groups


def make_optimizer(model: nn.Module, base_lr: float, max_iter: int,
                   optimizer: str = "sgd", momentum: float = 0.9,
                   weight_decay: float = 1e-4, power: float = 0.9,
                   head_lr_scale: float = 10.0, betas=(0.9, 0.999),
                   exclude: Sequence[str] = ()) -> Tuple[torch.optim.Optimizer, Callable]:
    """(optimizer, schedule): SGD (momentum, weight decay) or Adam (classic
    L2 weight decay) over ``param_groups`` (without the ``exclude``
    subtrees), and the poly LR of each step."""
    groups = param_groups(model, base_lr, head_lr_scale, exclude)
    if optimizer == "sgd":
        opt = torch.optim.SGD(groups, lr=base_lr, momentum=momentum,
                              weight_decay=weight_decay)
    elif optimizer == "adam":
        opt = torch.optim.Adam(groups, lr=base_lr, betas=tuple(betas),
                               weight_decay=weight_decay)
    else:
        raise ValueError(f"unknown optimizer {optimizer!r}")
    return opt, poly_schedule(base_lr, max_iter, power)
