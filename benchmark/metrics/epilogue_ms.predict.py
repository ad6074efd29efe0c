"""epilogue_ms.predict: the device milliseconds a cached window launches
under ``predict_epilogue``: the resize to the output size and the argmax
(ops/resize.py::resize_argmax) (layer: model; core/spans.py)."""

from benchmark.core.spans import device_ms


def read(run):
    return device_ms(run, "predict_epilogue")
