"""Supervised train and eval steps (counterpart of
floodseg_tpu/train/supervised.py).

A step is ``step(state, batch, rng) -> (state, metrics)``: NHWC tensors in
``batch`` on the model's device, ``rng`` a ``torch.Generator`` (or None)
from which the step's dropout draws, the model and the optimizer updated
in place. Metrics stay on the device as tensors: nothing in a step reads a
value back to the host, so the host can queue the next step while the card
runs this one. Each step runs under ``full_precision_f32``: float32 means
float32, as the JAX package's ``precision="highest"`` does.

Data parallelism (``world``, parallel/mesh.py): with more than one rank,
``batch`` is this rank's slice of the global batch; the model runs on it
under ``data_parallel`` (synchronised BN, global-shape dropout), its
outputs and the labels are gathered, and the loss and the metrics are the
global batch's on every rank; the gradients are summed over the ranks
before the update. A world of one (or None) runs the one-device step.
"""

import contextlib
from typing import Callable, Dict, Iterator, List, Optional

import torch
import torch.nn as nn

from floodseg_tpu_torch.core.device import full_precision_f32
from floodseg_tpu_torch.core.profiler import span
from floodseg_tpu_torch.models.layers import data_parallel, dropout_generator
from floodseg_tpu_torch.ops.losses import cross_entropy_loss, ohem_with_aux
from floodseg_tpu_torch.ops.metrics import intersection_and_union
from floodseg_tpu_torch.parallel.mesh import World, gather, sum_gradients
from floodseg_tpu_torch.train.state import TrainState


def make_loss_fn(loss: str = "ohem", aux_weight: float = 0.4, ignore_index: int = 255,
                 ohem_thresh: float = 0.7, ohem_min_kept: int = 100000) -> Callable:
    """loss_fn(out, labels): OHEM CE (``ohem_with_aux``) or plain CE of
    ``out["pred"]``, plus ``aux_weight`` times that of ``out["aux"]`` when
    there is one."""
    def loss_fn(out: Dict, labels: torch.Tensor) -> torch.Tensor:
        aux = out.get("aux")
        if loss == "ohem":
            return ohem_with_aux(out["pred"], aux, labels, aux_weight, ignore_index,
                                 ohem_thresh, ohem_min_kept)
        main = cross_entropy_loss(out["pred"], labels, ignore_index)
        if aux is not None and aux_weight > 0:
            main = main + aux_weight * cross_entropy_loss(aux, labels, ignore_index)
        return main

    return loss_fn


def split_seeds(rng: Optional[torch.Generator], k: int) -> List[Optional[int]]:
    """k seeds drawn from ``rng`` (None -> k Nones): the port's counterpart
    of ``jax.random.split(rng, k)``. Each seed makes a fresh generator per
    call, so two calls with one seed draw the same mask, as two uses of one
    JAX key do."""
    if rng is None:
        return [None] * k
    return [int(s) for s in torch.randint(0, 2 ** 62, (k,), generator=rng,
                                            device=rng.device)]


@contextlib.contextmanager
def dropout_seed(model: nn.Module, seed: Optional[int],
                 device: torch.device) -> Iterator[None]:
    """The model's dropout draws from a generator on ``device`` seeded with
    ``seed`` inside the block (no generator for None)."""
    gen = None if seed is None else torch.Generator(device=device).manual_seed(seed)
    with dropout_generator(model, gen):
        yield


def step_metrics(logits: torch.Tensor, labels: torch.Tensor, num_classes: int,
                 ignore_index: int) -> Dict[str, torch.Tensor]:
    """Intersection, union and target counts of the argmax, on the device."""
    inter, union, target = intersection_and_union(torch.argmax(logits.detach(), dim=-1),
                                                  labels, num_classes, ignore_index)
    return {"intersection": inter, "union": union, "target": target}


def optimizer_params(state: TrainState) -> List[torch.Tensor]:
    return [p for g in state.optimizer.param_groups for p in g["params"]]


def backward_and_update(state: TrainState, loss: torch.Tensor,
                        world: Optional[World] = None) -> None:
    """Gradients of ``loss`` into ``.grad`` (cleared first), summed over
    the ranks of ``world`` when it has more than one (the span
    ``train_backward``), then ``state.apply_gradients`` (``train_optimizer``)."""
    with span("train_backward"):
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        sum_gradients(optimizer_params(state), world)
    with span("train_optimizer"):
        state.apply_gradients()


def gather_outputs(out: Dict, world: Optional[World]) -> Dict:
    """The model's outputs (a dict of per-rank tensors) gathered to the
    global batch (parallel/mesh.py::gather); ``out`` itself in a world of
    one."""
    return {k: gather(v, world) for k, v in out.items()}


def _device(model: nn.Module) -> torch.device:
    return next(model.parameters()).device


def make_train_step(model: nn.Module, loss_fn: Callable, num_classes: int,
                    ignore_index: int = 255, world: Optional[World] = None) -> Callable:
    """train_step(state, batch, rng) -> (state, metrics): the whole model in
    training mode on ``batch["frame_current"]`` (its aux head too), the loss
    of ``loss_fn``, one optimizer step; over the ranks of ``world`` as the
    module note says. Its phases run in the spans ``train_forward``,
    ``train_loss``, ``train_backward`` and ``train_optimizer``
    (core/profiler.py::span)."""
    def train_step(state: TrainState, batch: Dict, rng: Optional[torch.Generator]):
        images, labels = batch["frame_current"], gather(batch["label"], world)
        (seed,) = split_seeds(rng, 1)
        with full_precision_f32():
            model.train()
            with (span("train_forward"), dropout_seed(model, seed, _device(model)),
                  data_parallel(model, world)):
                out = gather_outputs(model(images), world)
            with span("train_loss"):
                loss = loss_fn(out, labels)
            backward_and_update(state, loss, world)
        return state, {"loss": loss.detach(),
                       **step_metrics(out["pred"], labels, num_classes, ignore_index)}

    return train_step


def make_eval_step(model: nn.Module, num_classes: int, ignore_index: int = 255) -> Callable:
    """eval_step(state, batch) -> metrics: the model in eval mode on
    ``batch["frame_current"]``, without gradients."""
    def eval_step(state: TrainState, batch: Dict):
        with torch.no_grad(), full_precision_f32():
            model.eval()
            out = model(batch["frame_current"])
        return step_metrics(out["pred"], batch["label"], num_classes, ignore_index)

    return eval_step
