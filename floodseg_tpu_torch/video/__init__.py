from floodseg_tpu_torch.video.flow_model import (
    FlowInterpolator,
    interp_weight,
    warp,
    warp_chain_masked,
)
from floodseg_tpu_torch.video.grid import default_grid, grids_from_motion_vectors

__all__ = ["FlowInterpolator", "default_grid", "grids_from_motion_vectors",
           "interp_weight", "warp", "warp_chain_masked"]
