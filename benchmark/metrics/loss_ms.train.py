"""loss_ms.train: the device milliseconds a training step launches under
``train_loss``: the loss (ops/losses.py::ohem_with_aux) (layer: train
step; core/spans.py)."""

from benchmark.core.spans import device_ms


def read(run):
    return device_ms(run, "train_loss")
