"""backward_ms.train: the device milliseconds a training step launches under
``train_backward``, autograd's thread included: clearing the gradients,
the backward pass, their sum over the ranks
(train/supervised.py::backward_and_update) (layer: train step;
core/spans.py)."""

from benchmark.core.spans import device_ms


def read(run):
    return device_ms(run, "train_backward")
