"""bind_idle_ms.predict: the milliseconds a cached window in which the
device is idle while ``predict_window`` is the host's innermost program
span: the part of the gap that opens a window that the binding of the
variables, inference mode and ``full_precision_f32``'s entry and exit
(train/flow.py::_bind) hold the device back, from the profiled stretch
(layer: predict builders; core/spans.py)."""

from benchmark.core.spans import idle_ms


def read(run):
    return idle_ms(run, "predict_window")
