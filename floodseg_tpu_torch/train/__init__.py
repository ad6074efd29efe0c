from floodseg_tpu_torch.train.contrastive import (
    ContrastiveConfig,
    U2PLState,
    contra_memobank_loss,
    create_u2pl_state,
    make_u2pl_steps,
    served_model,
    sync_teacher,
)
from floodseg_tpu_torch.train.evaluate import (
    crop_offsets,
    flow_sliding_window_predict,
    flow_sliding_window_test,
    make_crop_forward,
    multi_scale_test,
    sliding_window_predict,
)
from floodseg_tpu_torch.train.fit import (
    FitConfig,
    flow_transforms,
    role_datasets,
    round_train,
    run_fit,
    run_contrastive_fit,
    run_flow_fit,
    run_gan_fit,
    run_test,
    sem_transforms,
    train_loaders,
)
from floodseg_tpu_torch.train.flow import (
    flow_train_forward,
    make_cached_flow_predict_fn,
    make_flow_eval_step,
    make_flow_phase_fns,
    make_flow_predict_crop_fn,
    make_flow_predict_fn,
    make_flow_test_crop_fn,
    make_flow_train_step,
    plain_train_forward,
    profile_predict_phases,
)
from floodseg_tpu_torch.train.gan import (
    flow_g_forward,
    make_gan_train_step,
    one_hot_masks,
    single_frame_g_forward,
)
from floodseg_tpu_torch.train.memory_bank import (
    MemoryBank,
    create_memory_bank,
    enqueue,
    sample_negatives,
)
from floodseg_tpu_torch.train.optim import AUX_KEYS, head_mask, make_optimizer, poly_schedule
from floodseg_tpu_torch.train.predict import colorize, run_flow_predict, run_predict
from floodseg_tpu_torch.train.state import TrainState, create_train_state
from floodseg_tpu_torch.train.supervised import make_eval_step, make_loss_fn, make_train_step

__all__ = ["AUX_KEYS", "ContrastiveConfig", "FitConfig", "MemoryBank", "TrainState", "U2PLState",
           "colorize", "contra_memobank_loss", "create_memory_bank", "create_train_state",
           "create_u2pl_state", "crop_offsets", "enqueue", "flow_g_forward",
           "flow_sliding_window_predict", "flow_sliding_window_test", "flow_train_forward",
           "flow_transforms", "head_mask", "make_cached_flow_predict_fn", "make_crop_forward",
           "make_eval_step", "make_flow_eval_step", "make_flow_phase_fns",
           "make_flow_predict_crop_fn", "make_flow_predict_fn", "make_flow_test_crop_fn",
           "make_flow_train_step", "make_gan_train_step", "make_loss_fn", "make_optimizer",
           "make_train_step", "make_u2pl_steps", "multi_scale_test", "one_hot_masks",
           "plain_train_forward", "poly_schedule", "profile_predict_phases", "role_datasets",
           "round_train", "run_contrastive_fit", "run_fit", "run_flow_fit", "run_flow_predict",
           "run_gan_fit", "run_predict", "run_test", "sample_negatives", "sem_transforms",
           "served_model", "single_frame_g_forward", "sliding_window_predict", "sync_teacher",
           "train_loaders"]
