"""Model factory (counterpart of floodseg_tpu/models/__init__.py).

This slice ports PSPNet, the flow-predict path's model; DeepLabV3 and the
Segmenter ViT come with later slices.
"""

import torch

from floodseg_tpu_torch.models.convert import from_jax_variables, load_jax_variables
from floodseg_tpu_torch.models.layers import init_from_generator_
from floodseg_tpu_torch.models.pspnet import PPM, PSPNet
from floodseg_tpu_torch.models.resnet import ResNetFeatures

ARCHS = ("pspnet",)


def build_model(arch: str, classes: int = 5, layers: int = 50,
                with_aux: bool = True, dtype: torch.dtype = torch.float32) -> PSPNet:
    """The model for ``arch`` in eval mode, on the CPU, float32 parameters
    computing in ``dtype``. Weights come from ``load_jax_variables``,
    ``load_state_dict`` or ``init_from_generator_``."""
    if arch == "pspnet":
        return PSPNet(classes=classes, layers=layers, with_aux=with_aux,
                      dtype=dtype).eval()
    raise ValueError(f"arch {arch!r} is not ported yet; this slice has {ARCHS}")


__all__ = ["ARCHS", "PPM", "PSPNet", "ResNetFeatures", "build_model",
           "from_jax_variables", "init_from_generator_", "load_jax_variables"]
