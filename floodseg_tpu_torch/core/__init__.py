from floodseg_tpu_torch.core.device import full_precision_f32, resolve_device

__all__ = ["full_precision_f32", "resolve_device"]
