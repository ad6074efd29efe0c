"""forward_ms.train: the device milliseconds a training step launches under
``train_forward``: the model in training mode and the gather of its
outputs (train/supervised.py::make_train_step) (layer: train step;
core/spans.py)."""

from benchmark.core.spans import device_ms


def read(run):
    return device_ms(run, "train_forward")
