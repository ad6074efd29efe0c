"""Model factory (counterpart of floodseg_tpu/models/__init__.py).

The port has the three flow-predict architectures: PSPNet and DeepLabV3
(ResNet-50/101/152 trunks) and the Segmenter ViT (ViT-B/32 with the
MaskTransformer decoder). All three train: training-mode BN, each one's
dropout (models/layers.py::Dropout), the CNNs' aux heads. The s4GAN
methods add ``S4GANDiscriminator``; the U2PL (``contrastive``) method
builds each with its rep head (``semisupervised=True``:
``ModelRepresentation``, models/semi.py).
"""

import torch
import torch.nn as nn

from floodseg_tpu_torch.models.convert import from_jax_variables, load_jax_variables
from floodseg_tpu_torch.models.deeplabv3 import DeepLabV3
from floodseg_tpu_torch.models.discriminator import S4GANDiscriminator
from floodseg_tpu_torch.models.layers import init_flax_defaults_, init_from_generator_
from floodseg_tpu_torch.models.pspnet import PPM, PSPNet
from floodseg_tpu_torch.models.resnet import ResNetFeatures
from floodseg_tpu_torch.models.semi import ArchWrapper, ModelRepresentation, unwrap, with_rep
from floodseg_tpu_torch.models.vit import (
    MaskTransformer,
    SegmenterViT,
    ViTClassifier,
    VisionTransformer,
)

ARCHS = ("pspnet", "deeplabv3", "vit")


def build_model(arch: str, classes: int = 5, layers: int = 50, image_size: int = 768,
                with_aux: bool = True, dtype: torch.dtype = torch.float32,
                semisupervised: bool = False, remat: bool = False) -> nn.Module:
    """The model for ``arch`` in eval mode, on the CPU, float32 parameters
    computing in ``dtype``. ``layers`` and ``with_aux`` are the CNNs',
    ``image_size`` (the position grid's frame size) the ViT's, as in the
    JAX factory; ``semisupervised`` adds the U2PL rep head in the
    reference's ``ModelRepresentation`` layout; ``remat`` rematerialises
    every bottleneck of the CNNs' trunks in training (models/resnet.py;
    the ViT ignores it, as the JAX factory's does). Weights come from
    ``init_flax_defaults_`` (the JAX package's initial distributions),
    ``load_jax_variables``, ``load_state_dict`` or, in tests,
    ``init_from_generator_``."""
    if arch == "pspnet":
        model = PSPNet(classes=classes, layers=layers, with_aux=with_aux, dtype=dtype,
                       remat=remat)
    elif arch == "deeplabv3":
        model = DeepLabV3(classes=classes, layers=layers, with_aux=with_aux, dtype=dtype,
                          remat=remat)
    elif arch == "vit":
        model = SegmenterViT(classes=classes, image_size=image_size, dtype=dtype)
    else:
        raise ValueError(f"unknown arch {arch!r}; expected one of {ARCHS}")
    return (with_rep(model, dtype) if semisupervised else model).eval()


__all__ = ["ARCHS", "ArchWrapper", "DeepLabV3", "MaskTransformer", "ModelRepresentation", "PPM",
           "PSPNet", "ResNetFeatures", "S4GANDiscriminator", "SegmenterViT",
           "ViTClassifier", "VisionTransformer", "build_model", "from_jax_variables",
           "init_flax_defaults_", "init_from_generator_", "load_jax_variables", "unwrap",
           "with_rep"]
