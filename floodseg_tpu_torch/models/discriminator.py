"""The s4GAN discriminator (counterpart of
floodseg_tpu/models/discriminator.py).

Four 4x4 stride-2 pad-1 convolutions (ndf, 2 ndf, 4 ndf, 8 ndf channels),
each followed by LeakyReLU(0.2), the first three also by channel dropout
(the reference's ``Dropout2d``: whole maps of a sample dropped, the port's
``Dropout(broadcast_dims=(2, 3))`` on NCHW), a global average pool and a
linear head. The head stays a logit, paired with a from-logits BCE
(ops/losses.py::binary_cross_entropy); the self-training threshold takes
its sigmoid. Module names give the reference's keys: ``layers.{0,3,6,9}``
for the convolutions and ``final.0`` for the head.
"""

from typing import Tuple

import torch
import torch.nn as nn

from floodseg_tpu_torch.models.layers import Conv2d, Dropout, Linear
from floodseg_tpu_torch.ops.pool import global_avg_pool


class S4GANDiscriminator(nn.Module):
    """Input NHWC (B, H, W, num_classes + 3): softmax(pred) (or the one-hot
    labels) and the normalised image, in that channel order. Returns (the
    logit (B,), the pooled feature (B, 8 ndf))."""

    def __init__(self, num_classes: int = 5, ndf: int = 64, dropout: float = 0.5,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        layers = []
        cin = num_classes + 3
        for i, cout in enumerate((ndf, ndf * 2, ndf * 4, ndf * 8)):
            layers += [Conv2d(cin, cout, 4, stride=2, padding=1, dtype=dtype),
                       nn.LeakyReLU(0.2)]
            if i < 3:
                layers.append(Dropout(dropout, broadcast_dims=(2, 3)))
            cin = cout
        self.layers = nn.Sequential(*layers)
        self.final = nn.Sequential(Linear(ndf * 8, 1, dtype=dtype))

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        y = self.layers(x.permute(0, 3, 1, 2))
        feat = global_avg_pool(y.permute(0, 2, 3, 1))[:, 0, 0]
        return self.final(feat)[:, 0], feat
