"""bind_ms.predict: the host milliseconds a cached window spends in
``predict_window`` outside the spans of its phases: the binding of the
variables by ``functional_call``, inference mode and
``full_precision_f32``'s entry and exit (train/flow.py::_bind), from the
profiled stretch (layer: predict builders; core/spans.py)."""

from benchmark.core.spans import host_self_ms


def read(run):
    return host_self_ms(run, "predict_window")
