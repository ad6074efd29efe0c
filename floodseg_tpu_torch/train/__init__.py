from floodseg_tpu_torch.train.flow import make_cached_flow_predict_fn, make_flow_predict_fn

__all__ = ["make_cached_flow_predict_fn", "make_flow_predict_fn"]
