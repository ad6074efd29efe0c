"""Reference PyTorch checkpoints -> the port's state_dicts (counterpart of
floodseg_tpu/models/torch_import.py and lightning_import.py).

The port's modules carry the reference's key names already (models/
convert.py), so importing is mostly choosing keys and stripping prefixes:

``convert_resnet_backbone`` maps a reference ResNet state_dict
(conv1/bn1[/conv2/bn2/conv3/bn3], layer{1..4}.{i}.conv{1..3}/bn{1..3},
downsample.0/.1; the pretrained trunk ``model.pretrained_path`` names) to
the trunk of a port model: PSPNet's deep-base stem into
``layer0.{0,1,3,4,6,7}``, DeepLabV3's under ``backbone.``. Other keys (the
classifier ``fc``, ``num_batches_tracked``) are left out.

``import_lightning_checkpoint`` reads a reference Lightning checkpoint (or
a bare state_dict) by role, as the JAX package's importer does: ``model.``
(the supervised and contrastive student), ``model_G.`` (the s4GAN and flow
generator), ``model_teacher.`` (the U2PL teacher), ``model_D.`` (the s4GAN
discriminator). Each role's layout:

  bare PSPNet          layer0..4 / ppm / cls / aux     -> as is
  PSPNet + rep         model.* + rep.*                  -> as is
  DeepLabv3 wrapper    model.backbone / classifier ...  -> without ``model.``
  DeepLabv3 + rep      model.model.* + rep.*            -> as is
  VITSegmentModel      model.encoder / model.decoder    -> without ``model.``
  ViT + rep            model.model.* + rep.rep_model.*  -> as is
  discriminator        layers.{0,3,6,9} / final.0       -> as is

The reference's FlowModel wrappers (FlowPSPNet's ``model.decoder`` with its
``layers.``/``encoder.`` aliases, FlowDeepLabv3's
``model.encoder.model.*``) are not read yet (ROADMAP item 13d) and raise.
"""

from typing import Any, Dict, Mapping, Tuple

import torch

from floodseg_tpu_torch.models.resnet import DEPTH_BLOCKS

_PSP_STEM = {"conv1": "layer0.0", "bn1": "layer0.1", "conv2": "layer0.3",
             "bn2": "layer0.4", "conv3": "layer0.6", "bn3": "layer0.7"}
_CONV = ("weight",)
_BN = ("weight", "bias", "running_mean", "running_var")


def convert_resnet_backbone(sd: Mapping[str, Any], arch: str,
                            layers: int) -> Dict[str, torch.Tensor]:
    """A reference ResNet state_dict -> the trunk entries of the port's
    ``arch`` ("pspnet": the deep-base stem; "deeplabv3": torchvision's stem
    under ``backbone.``) for ``layers`` 50, 101 or 152. A key the trunk
    needs and ``sd`` lacks raises ``KeyError``."""
    if arch not in ("pspnet", "deeplabv3"):
        raise ValueError(f"model.pretrained_path loads a ResNet trunk; {arch!r} has none")
    deep_base = arch == "pspnet"
    prefix = "" if deep_base else "backbone."
    out: Dict[str, torch.Tensor] = {}

    def take(src: str, dst: str, leaves) -> None:
        for leaf in leaves:
            out[f"{dst}.{leaf}"] = torch.as_tensor(sd[f"{src}.{leaf}"])

    stem = (("conv1", "bn1", "conv2", "bn2", "conv3", "bn3") if deep_base
            else ("conv1", "bn1"))
    for name in stem:
        take(name, _PSP_STEM[name] if deep_base else prefix + name,
             _CONV if name.startswith("conv") else _BN)
    for li, n in enumerate(DEPTH_BLOCKS[layers], start=1):
        for bi in range(n):
            src = f"layer{li}.{bi}"
            for ci in (1, 2, 3):
                take(f"{src}.conv{ci}", f"{prefix}{src}.conv{ci}", _CONV)
                take(f"{src}.bn{ci}", f"{prefix}{src}.bn{ci}", _BN)
            if f"{src}.downsample.0.weight" in sd:
                take(f"{src}.downsample.0", f"{prefix}{src}.downsample.0", _CONV)
                take(f"{src}.downsample.1", f"{prefix}{src}.downsample.1", _BN)
    return out


def _sub(sd: Mapping[str, Any], prefix: str) -> Dict[str, Any]:
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


def _role(sd: Mapping[str, Any]) -> Tuple[str, Dict[str, Any]]:
    """One role's keys (its prefix stripped) -> (arch, the port's
    state_dict)."""
    if "model.decoder.0.weight" in sd and "model.layer0.0.weight" in sd:
        raise NotImplementedError(
            "a FlowModel(FlowPSPNet) checkpoint layout is not read by the port yet "
            "(ROADMAP item 13d)")
    if "model.encoder.model.conv1.weight" in sd:
        raise NotImplementedError(
            "a FlowModel(FlowDeepLabv3) checkpoint layout is not read by the port yet "
            "(ROADMAP item 13d)")
    if "layer0.0.weight" in sd or "model.cls.0.weight" in sd:
        return "pspnet", dict(sd)
    if "model.backbone.conv1.weight" in sd:
        return "deeplabv3", _sub(sd, "model.")
    if "model.model.backbone.conv1.weight" in sd:
        return "deeplabv3", dict(sd)
    if "model.encoder.cls_token" in sd:
        return "vit", _sub(sd, "model.")
    if "model.model.encoder.cls_token" in sd:
        return "vit", dict(sd)
    raise ValueError("unrecognized reference model layout; sample keys: "
                     + ", ".join(sorted(sd)[:8]))


def import_lightning_checkpoint(ckpt: Mapping[str, Any]) -> Dict[str, Any]:
    """A loaded Lightning checkpoint (or bare state_dict) -> ``{"arch",
    "method_family", "roles", "epoch"}``; roles maps "model" and, where
    present, "teacher" and "discriminator" to the port's state_dicts
    (torch tensors), the family is named as the JAX importer names it."""
    sd = ckpt.get("state_dict", ckpt) if isinstance(ckpt, Mapping) else ckpt
    sd = {k: torch.as_tensor(v) for k, v in sd.items()}
    roles: Dict[str, Dict[str, Any]] = {}
    if any(k.startswith("model_G.") for k in sd):
        arch, roles["model"] = _role(_sub(sd, "model_G."))
        family = "gan"
    elif any(k.startswith("model_teacher.") for k in sd):
        family = "contrastive"
        arch, roles["model"] = _role(_sub(sd, "model."))
        _, roles["teacher"] = _role(_sub(sd, "model_teacher."))
    else:
        family = "supervised"
        arch, roles["model"] = _role(_sub(sd, "model."))
    if any(k.startswith("model_D.") for k in sd):
        roles["discriminator"] = _sub(sd, "model_D.")
    epoch = ckpt.get("epoch") if isinstance(ckpt, Mapping) else None
    return {"arch": arch, "method_family": family, "roles": roles, "epoch": epoch}


def load_torch_file(path: str) -> Dict[str, Any]:
    """``torch.load`` a reference checkpoint file and import it."""
    return import_lightning_checkpoint(torch.load(path, map_location="cpu",
                                                  weights_only=False))
