"""pspnet50: PSPNet on a deep-base ResNet-50 (``pspnet50.json``), the
port's ``build_model("pspnet")`` against ``reference/pspnet.py``."""

from benchmark.core.program import port_model
from benchmark.reference import pspnet as REFERENCE  # noqa: N812


def program_model(cfg, weights, device):
    return port_model("pspnet", cfg, weights, device)
