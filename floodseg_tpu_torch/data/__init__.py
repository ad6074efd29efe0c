from floodseg_tpu_torch.data.synthetic import predict_windows, synthetic_clip
from floodseg_tpu_torch.data.transforms import MEAN, STD, Resize

__all__ = ["MEAN", "STD", "Resize", "predict_windows", "synthetic_clip"]
