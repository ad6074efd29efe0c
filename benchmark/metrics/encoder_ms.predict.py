"""encoder_ms.predict: the device milliseconds a cached window launches under
``predict_encoder``: the next key frame's encoder pass
(video/flow_model.py::FlowInterpolator.predict_clip, models/pspnet.py)
(layer: model; core/spans.py)."""

from benchmark.core.spans import device_ms


def read(run):
    return device_ms(run, "predict_encoder")
