"""Builds the program's model and puts the benchmark's weights in it."""

from typing import Dict

import torch

DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16, "float32": torch.float32}


def port_model(arch: str, cfg: dict, weights: Dict[str, torch.Tensor],
               device: torch.device) -> torch.nn.Module:
    """The port's ``build_model(arch, ...)`` on ``device`` (channels-last
    on the card, as the port's entry points place it), its parameters and
    statistics copied from ``weights``. Every tensor of the model must be
    in ``weights``, at the same shape, but BN's ``num_batches_tracked``,
    which nothing reads: the configuration's widths are the reference's, and
    a port built to other widths is refused here."""
    from floodseg_tpu_torch.models import build_model

    with torch.device("meta"):
        model = build_model(arch, classes=int(cfg["classes"]), layers=int(cfg["layers"]),
                            with_aux=bool(cfg["aux"]), dtype=DTYPES[cfg["dtype"]])
    model.to_empty(device=device)
    state = model.state_dict()
    missing = sorted(set(state) - set(weights))
    extra = sorted(set(weights) - set(state))
    if extra or any(not k.endswith("num_batches_tracked") for k in missing):
        raise KeyError(f"the port's {arch} and the reference differ: missing {missing[:5]}, "
                       f"extra {extra[:5]}")
    shapes = [k for k, v in state.items() if k in weights and v.shape != weights[k].shape]
    if shapes:
        raise ValueError(f"the port's {arch} and the reference differ in shape: {shapes[:5]}")
    with torch.no_grad():
        for k, v in state.items():
            v.copy_(weights[k]) if k in weights else v.zero_()
    if device.type == "cuda":
        model.to(memory_format=torch.channels_last)
    return model.eval()
