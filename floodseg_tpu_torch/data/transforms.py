"""Frame normalisation constants and the frame resize.

Counterpart of the predict path's part of floodseg_tpu/data/transforms.py.
The JAX package resizes frames with cv2; the machine with the card has
neither cv2 nor PIL, so ``Resize`` uses the port's own half-pixel bilinear
(ops/resize.py with align_corners=False, cv2.INTER_LINEAR's convention).
"""

import torch

from floodseg_tpu_torch.ops.resize import resize_bilinear

# ImageNet mean/std scaled by 255
MEAN = [0.485 * 255, 0.456 * 255, 0.406 * 255]
STD = [0.229 * 255, 0.224 * 255, 0.225 * 255]


class Resize:
    """Resize frames (..., H, W, 3) to ``size=(h, w)``: half-pixel bilinear
    in float32. uint8 frames come back as uint8, rounded and clipped as cv2
    returns them; float frames keep their dtype. Grids need no resize: their
    coordinates are normalized."""

    def __init__(self, size):
        self.size = tuple(int(s) for s in size)

    def __call__(self, frames) -> torch.Tensor:
        x = torch.as_tensor(frames)
        if x.dtype == torch.uint8:
            y = resize_bilinear(x.to(torch.float32), self.size, align_corners=False)
            return y.round().clamp(0, 255).to(torch.uint8)
        return resize_bilinear(x, self.size, align_corners=False)
