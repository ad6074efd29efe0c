"""The weight bridge: floodseg_tpu variable trees -> the port's state_dict.

``from_jax_variables`` takes a PSPNet's ``{"params", "batch_stats"}`` tree
(nested mappings of numpy arrays, as ``jax.device_get`` returns them) and
emits the reference's PSPNet key names, exactly as
floodseg_tpu/models/lightning_export.py::export_pspnet_variables(...,
flow=False) does. The port keeps its own copy of that mapping and needs no
JAX at run time:

  conv  HWIO kernel -> OIHW ``weight`` (+ ``bias``)
  BN    scale/bias -> weight/bias, batch_stats mean/var ->
        running_mean/running_var, plus ``num_batches_tracked`` = 0
  stem  conv1/bn1/conv2/bn2/conv3/bn3 -> layer0.{0,1,3,4,6,7}
  trunk layerX_blockY.convZ/bnZ/downsample_{conv,bn} -> layerX.Y.convZ/bnZ/
        downsample.{0,1}
  PPM   binI_conv/binI_bn -> ppm.features.I.{1,2}
  heads cls/aux conv1/bn/conv2 -> cls/aux.{0,1,4}

``load_jax_variables`` strict-loads the result into a port PSPNet.
"""

from typing import Dict, Mapping

import numpy as np
import torch


def _f32(a) -> np.ndarray:
    return np.asarray(a, dtype=np.float32)


def _conv(out: dict, p: Mapping, key: str) -> None:
    out[f"{key}.weight"] = _f32(p["kernel"]).transpose(3, 2, 0, 1)
    if "bias" in p:
        out[f"{key}.bias"] = _f32(p["bias"])


def _bn(out: dict, p: Mapping, s: Mapping, key: str) -> None:
    out[f"{key}.weight"] = _f32(p["scale"])
    out[f"{key}.bias"] = _f32(p["bias"])
    out[f"{key}.running_mean"] = _f32(s["mean"])
    out[f"{key}.running_var"] = _f32(s["var"])
    out[f"{key}.num_batches_tracked"] = np.asarray(0, dtype=np.int64)


def _seg_head(out: dict, p: Mapping, s: Mapping, key: str) -> None:
    _conv(out, p["conv1"], f"{key}.0")
    _bn(out, p["bn"], s["bn"], f"{key}.1")
    _conv(out, p["conv2"], f"{key}.4")


_STEM = {"conv1": "layer0.0", "bn1": "layer0.1", "conv2": "layer0.3",
         "bn2": "layer0.4", "conv3": "layer0.6", "bn3": "layer0.7"}


def from_jax_variables(variables: Mapping) -> Dict[str, np.ndarray]:
    """JAX PSPNet variables -> the reference's PSPNet state_dict (numpy)."""
    p, s = variables["params"], variables["batch_stats"]
    bp, bs = p["backbone"], s["backbone"]
    out: Dict[str, np.ndarray] = {}
    for i in (1, 2, 3):
        _conv(out, bp[f"conv{i}"], _STEM[f"conv{i}"])
        _bn(out, bp[f"bn{i}"], bs[f"bn{i}"], _STEM[f"bn{i}"])
    for name in bp:
        if not name.startswith("layer"):
            continue
        li, bi = name[len("layer"):].split("_block")
        key = f"layer{li}.{bi}"
        for ci in (1, 2, 3):
            _conv(out, bp[name][f"conv{ci}"], f"{key}.conv{ci}")
            _bn(out, bp[name][f"bn{ci}"], bs[name][f"bn{ci}"], f"{key}.bn{ci}")
        if "downsample_conv" in bp[name]:
            _conv(out, bp[name]["downsample_conv"], f"{key}.downsample.0")
            _bn(out, bp[name]["downsample_bn"], bs[name]["downsample_bn"],
                f"{key}.downsample.1")
    for i in range(len([k for k in p["ppm"] if k.endswith("_conv")])):
        _conv(out, p["ppm"][f"bin{i}_conv"], f"ppm.features.{i}.1")
        _bn(out, p["ppm"][f"bin{i}_bn"], s["ppm"][f"bin{i}_bn"],
            f"ppm.features.{i}.2")
    _seg_head(out, p["cls"], s["cls"], "cls")
    if "aux" in p:
        _seg_head(out, p["aux"], s["aux"], "aux")
    return out


def load_jax_variables(model: torch.nn.Module, variables: Mapping) -> torch.nn.Module:
    """Strict-load JAX PSPNet variables into the port's ``model``."""
    state = {k: torch.from_numpy(np.array(v))  # a writable copy of each leaf
             for k, v in from_jax_variables(variables).items()}
    model.load_state_dict(state, strict=True)
    return model
