"""optimizer_ms.train: the device milliseconds a training step launches under
``train_optimizer``: the optimizer's step
(train/state.py::apply_gradients, train/optim.py) (layer: train step;
core/spans.py)."""

from benchmark.core.spans import device_ms


def read(run):
    return device_ms(run, "train_optimizer")
