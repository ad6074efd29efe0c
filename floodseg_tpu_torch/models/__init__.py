"""Model factory (counterpart of floodseg_tpu/models/__init__.py).

The port has the two flow-predict architectures, PSPNet and DeepLabV3
(ResNet-50/101/152 trunks, eval); the Segmenter ViT comes with a later
slice.
"""

import torch
import torch.nn as nn

from floodseg_tpu_torch.models.convert import from_jax_variables, load_jax_variables
from floodseg_tpu_torch.models.deeplabv3 import DeepLabV3
from floodseg_tpu_torch.models.layers import init_from_generator_
from floodseg_tpu_torch.models.pspnet import PPM, PSPNet
from floodseg_tpu_torch.models.resnet import ResNetFeatures

ARCHS = ("pspnet", "deeplabv3")


def build_model(arch: str, classes: int = 5, layers: int = 50,
                with_aux: bool = True, dtype: torch.dtype = torch.float32) -> nn.Module:
    """The model for ``arch`` in eval mode, on the CPU, float32 parameters
    computing in ``dtype``. Weights come from ``load_jax_variables``,
    ``load_state_dict`` or ``init_from_generator_``."""
    if arch == "pspnet":
        return PSPNet(classes=classes, layers=layers, with_aux=with_aux,
                      dtype=dtype).eval()
    if arch == "deeplabv3":
        return DeepLabV3(classes=classes, layers=layers, with_aux=with_aux,
                         dtype=dtype).eval()
    raise ValueError(f"arch {arch!r} is not ported yet; the port has {ARCHS}")


__all__ = ["ARCHS", "DeepLabV3", "PPM", "PSPNet", "ResNetFeatures", "build_model",
           "from_jax_variables", "init_from_generator_", "load_jax_variables"]
