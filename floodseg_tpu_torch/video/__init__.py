from floodseg_tpu_torch.video.flow_model import FlowInterpolator, warp
from floodseg_tpu_torch.video.grid import default_grid, grids_from_motion_vectors

__all__ = ["FlowInterpolator", "default_grid", "grids_from_motion_vectors", "warp"]
