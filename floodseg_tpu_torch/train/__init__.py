from floodseg_tpu_torch.train.evaluate import crop_offsets, flow_sliding_window_predict
from floodseg_tpu_torch.train.flow import (
    make_cached_flow_predict_fn,
    make_flow_predict_crop_fn,
    make_flow_predict_fn,
)
from floodseg_tpu_torch.train.predict import colorize, run_flow_predict, run_predict

__all__ = ["colorize", "crop_offsets", "flow_sliding_window_predict",
           "make_cached_flow_predict_fn", "make_flow_predict_crop_fn", "make_flow_predict_fn",
           "run_flow_predict", "run_predict"]
