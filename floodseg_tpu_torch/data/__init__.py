from floodseg_tpu_torch.data.avi import MJPGWriter, read_mjpg_avi
from floodseg_tpu_torch.data.dataset import (
    ConcatDataset,
    FlowDataset,
    SemDataset,
    collate,
    parse_list,
)
from floodseg_tpu_torch.data.image import imread, write_jpeg, write_png
from floodseg_tpu_torch.data.loader import DataLoader, device_put
from floodseg_tpu_torch.data.synthetic import (
    generate_synthetic_dataset,
    predict_windows,
    synthetic_clip,
)
from floodseg_tpu_torch.data.transforms import (
    MEAN,
    STD,
    Compose,
    Crop,
    IgnoreClasses,
    Normalize,
    RandomGaussianBlur,
    RandomHorizontalFlip,
    RandRotate,
    RandScale,
    Resize,
    ScaleBlurFlipCrop,
    ToFloat,
    build_test_transform,
    build_train_transform,
    build_val_transform,
    resize_frames,
)

__all__ = ["MEAN", "STD", "Compose", "ConcatDataset", "Crop", "DataLoader", "FlowDataset",
           "IgnoreClasses", "MJPGWriter", "Normalize", "RandRotate", "RandScale",
           "RandomGaussianBlur", "RandomHorizontalFlip", "Resize", "ScaleBlurFlipCrop",
           "SemDataset", "ToFloat", "build_test_transform", "build_train_transform",
           "build_val_transform", "collate", "device_put", "generate_synthetic_dataset",
           "imread", "parse_list", "predict_windows", "read_mjpg_avi", "resize_frames",
           "synthetic_clip", "write_jpeg", "write_png"]
