"""The train state (counterpart of floodseg_tpu/train/state.py).

The JAX package keeps params, batch statistics and the optimizer state as
one immutable pytree; the port keeps them where PyTorch does, in the model
and the optimizer, and ``TrainState`` holds the step count beside them.
``apply_gradients`` updates in place.
"""

from dataclasses import dataclass
from typing import Callable, Mapping, Optional

import torch
import torch.nn as nn


@dataclass
class TrainState:
    """step: optimizer steps taken (a host integer); model: parameters and
    BN statistics; optimizer: its state and groups (each with ``lr_scale``);
    schedule: the LR of step k."""
    step: int
    model: nn.Module
    optimizer: torch.optim.Optimizer
    schedule: Callable[[int], float]

    def apply_gradients(self) -> None:
        """One optimizer step with the gradients in ``.grad``.

        A parameter without a gradient gets a zero one first: the JAX
        optimizer decays and moves every parameter, also one the loss does
        not reach (the aux head of flow training), where torch's optimizers
        would skip it. A parameter in no group (s4GAN's aux head,
        ``make_optimizer(exclude=...)``) is not touched. Each group's LR is
        the schedule's for this step times the group's ``lr_scale``."""
        lr = self.schedule(self.step)
        for group in self.optimizer.param_groups:
            group["lr"] = lr * group.get("lr_scale", 1.0)
            for p in group["params"]:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
        self.optimizer.step()
        self.step += 1


def create_train_state(model: nn.Module, optimizer: torch.optim.Optimizer,
                       schedule: Callable[[int], float],
                       pretrained: Optional[Mapping[str, torch.Tensor]] = None) -> TrainState:
    """The state at step 0, with ``pretrained`` (state_dict keys -> tensors)
    overlaid on the model's parameters and buffers first (``overlay``)."""
    if pretrained is not None:
        overlay(model, pretrained)
    return TrainState(step=0, model=model, optimizer=optimizer, schedule=schedule)


@torch.no_grad()
def overlay(model: nn.Module, pretrained: Mapping[str, torch.Tensor]) -> nn.Module:
    """Copy every entry of ``pretrained`` whose key the model has into it,
    keeping the model's dtype; a shape that differs raises. Keys the model
    lacks are ignored (the JAX package's ``_merge``)."""
    state = model.state_dict(keep_vars=True)
    for k, v in pretrained.items():
        if k not in state:
            continue
        v = torch.as_tensor(v)
        if tuple(v.shape) != tuple(state[k].shape):
            raise ValueError(f"pretrained shape {tuple(v.shape)} != model shape "
                             f"{tuple(state[k].shape)} for {k}")
        state[k].copy_(v.to(state[k].dtype))
    return model
