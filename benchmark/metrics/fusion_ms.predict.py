"""fusion_ms.predict: the device milliseconds a cached window launches under
``predict_fusion``: the int8 bound, the key map through the default grid
(K1), the blend with its flip, the resize back to the feature size or K3,
the quantizing (video/flow_model.py::FlowInterpolator.predict_clip)
(layer: model; core/spans.py)."""

from benchmark.core.spans import device_ms


def read(run):
    return device_ms(run, "predict_fusion")
