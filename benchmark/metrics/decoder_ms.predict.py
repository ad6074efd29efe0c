"""decoder_ms.predict: the device milliseconds a cached window launches under
``predict_decoder``: the decoder calls and their concatenation
(video/flow_model.py::FlowInterpolator.predict_clip, models/pspnet.py)
(layer: model; core/spans.py)."""

from benchmark.core.spans import device_ms


def read(run):
    return device_ms(run, "predict_decoder")
