from floodseg_tpu_torch.train.evaluate import crop_offsets, flow_sliding_window_predict
from floodseg_tpu_torch.train.fit import (
    FitConfig,
    flow_transforms,
    round_train,
    run_fit,
    run_flow_fit,
    sem_transforms,
)
from floodseg_tpu_torch.train.flow import (
    flow_train_forward,
    make_cached_flow_predict_fn,
    make_flow_eval_step,
    make_flow_predict_crop_fn,
    make_flow_predict_fn,
    make_flow_train_step,
    plain_train_forward,
)
from floodseg_tpu_torch.train.optim import head_mask, make_optimizer, poly_schedule
from floodseg_tpu_torch.train.predict import colorize, run_flow_predict, run_predict
from floodseg_tpu_torch.train.state import TrainState, create_train_state
from floodseg_tpu_torch.train.supervised import make_eval_step, make_loss_fn, make_train_step

__all__ = ["FitConfig", "TrainState", "colorize", "create_train_state", "crop_offsets",
           "flow_sliding_window_predict", "flow_train_forward", "flow_transforms",
           "head_mask", "make_cached_flow_predict_fn", "make_eval_step",
           "make_flow_eval_step", "make_flow_predict_crop_fn", "make_flow_predict_fn",
           "make_flow_train_step", "make_loss_fn", "make_optimizer", "make_train_step",
           "plain_train_forward", "poly_schedule", "round_train", "run_fit", "run_flow_fit",
           "run_flow_predict", "run_predict", "sem_transforms"]
