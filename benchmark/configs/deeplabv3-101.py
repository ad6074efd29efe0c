"""deeplabv3-101: DeepLabV3 on ResNet-101 in torchvision's layout
(``deeplabv3-101.json``), the port's ``build_model("deeplabv3")`` against
``reference/deeplabv3.py``."""

from benchmark.core.program import port_model
from benchmark.reference import deeplabv3 as REFERENCE  # noqa: N812


def program_model(cfg, weights, device):
    return port_model("deeplabv3", cfg, weights, device)
