"""warp_ms.predict: the device milliseconds a cached window launches under
``predict_warp``: both chains, K1 onto the first grid and K2
(video/flow_model.py::FlowInterpolator._predict_chain, csrc/warp.cu)
(layer: kernels; core/spans.py)."""

from benchmark.core.spans import device_ms


def read(run):
    return device_ms(run, "predict_warp")
