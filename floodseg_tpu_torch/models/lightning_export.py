"""The port's state_dicts -> a reference Lightning checkpoint (counterpart of
floodseg_tpu/models/lightning_export.py; the inverse of
models/torch_import.py).

The port's modules carry the reference's key names already, so a role's
export is a choice of prefixes: ``_export_role`` gives the within-role
layout the JAX exporter gives for the same weights, and
``export_lightning_checkpoint`` puts each role under its prefix:

  supervised, contrastive  ``model.*`` (and ``model_teacher.*``)
  gan                      ``model_G.*`` (and ``model_D.*``)
  flow_*                   ``model_G.*``, the FlowModel layouts

Within a role:

  PSPNet             bare layer0..4 / ppm / cls / aux; with the rep head
                     model.* + rep.* (ModelRepresentation)
  FlowPSPNet         model.* with cls as decoder and no aux, plus the
                     duplicate aliases layers.{i}.* and encoder.0.{i}.* of
                     layer{i}.* and encoder.1.* of ppm.* (the reference
                     registers the shared modules three times)
  DeepLabv3          model.backbone / model.classifier ...; with the rep
                     head model.model.* + rep.*
  FlowDeepLabv3      model.encoder.model.* (the trunk) and model.decoder.*
                     (the classifier), no aux
  Segmenter ViT      model.encoder / model.decoder; with the rep head
                     model.model.* + rep.rep_model.*; a flow layout raises:
                     the reference has none
  discriminator      layers.{0,3,6,9} / final.0

Every ``num_batches_tracked`` is written as 0 (int64), as the JAX exporter
writes it; other tensors are float32 on the CPU.
"""

from typing import Any, Dict, Mapping, Optional

import torch

State = Mapping[str, torch.Tensor]


def _tensors(sd: State) -> Dict[str, torch.Tensor]:
    out = {}
    for k, v in sd.items():
        v = torch.as_tensor(v).detach().cpu()
        if k.endswith("num_batches_tracked"):
            v = torch.zeros((), dtype=torch.int64)
        elif v.is_floating_point() and v.dtype not in (torch.float32, torch.float64):
            v = v.float()
        out[k] = v
    return out


def _flow_pspnet(sd: State) -> Dict[str, torch.Tensor]:
    out = {}
    for k, v in sd.items():
        if k.startswith("aux."):
            continue
        out["decoder." + k[len("cls."):] if k.startswith("cls.") else k] = v
    aliases = {}
    for k, v in out.items():
        for i in range(5):
            if k.startswith(f"layer{i}."):
                rest = k[len(f"layer{i}."):]
                aliases[f"layers.{i}.{rest}"] = v
                aliases[f"encoder.0.{i}.{rest}"] = v
        if k.startswith("ppm."):
            aliases["encoder.1." + k[len("ppm."):]] = v
    out.update(aliases)
    return {f"model.{k}": v for k, v in out.items()}


def _export_role(arch: str, sd: State, flow: bool = False) -> Dict[str, torch.Tensor]:
    """One role's port state_dict -> its within-role reference layout."""
    sd = _tensors(sd)
    rep = any(k.startswith("rep.") for k in sd)
    if arch == "pspnet":
        return _flow_pspnet(sd) if flow else sd
    if arch == "deeplabv3":
        if flow:
            out = {}
            for k, v in sd.items():
                if k.startswith("backbone."):
                    out["model.encoder.model." + k[len("backbone."):]] = v
                elif k.startswith("classifier."):
                    out["model.decoder." + k[len("classifier."):]] = v
            return out
        return sd if rep else {f"model.{k}": v for k, v in sd.items()}
    if flow:
        raise ValueError(
            "the reference has no vit flow layout (flow/base.py:94-103 raises "
            "NotImplementedError); a floodseg vit flow model cannot be exported to a "
            "reference-loadable checkpoint")
    return sd if rep else {f"model.{k}": v for k, v in sd.items()}


def export_lightning_checkpoint(arch: str, roles: Mapping[str, State], method_family: str,
                                epoch: Optional[int] = None) -> Dict[str, Any]:
    """A Lightning checkpoint dict from per-role port state_dicts:
    ``roles`` maps ``model`` (the student or generator) and optionally
    ``teacher`` and ``discriminator``, the shape
    ``import_lightning_checkpoint`` returns them in, so exporting what it
    imported gives the original keys back."""
    flow = method_family.startswith("flow")
    g_prefix = "model_G." if method_family in ("gan", "flow_gan", "flow_supervised") else "model."
    sd: Dict[str, torch.Tensor] = {}
    for k, v in _export_role(arch, roles["model"], flow=flow).items():
        sd[g_prefix + k] = v
    if "teacher" in roles:
        if method_family != "contrastive":
            raise ValueError("a teacher role implies method contrastive")
        for k, v in _export_role(arch, roles["teacher"]).items():
            sd["model_teacher." + k] = v
    if "discriminator" in roles:
        for k, v in _tensors(roles["discriminator"]).items():
            sd["model_D." + k] = v
    out: Dict[str, Any] = {"state_dict": sd}
    if epoch is not None:
        out["epoch"] = int(epoch)
    return out
