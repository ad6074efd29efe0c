"""The weight bridge: floodseg_tpu variable trees -> the port's state_dict.

``from_jax_variables`` takes a ``{"params", "batch_stats"}`` tree (nested
mappings of numpy arrays, as ``jax.device_get`` returns them) of any flow
architecture, picked from the tree (``encoder.patch_proj`` for the ViT,
whose tree has no ``batch_stats`` or an empty one; ``ppm`` for PSPNet,
``classifier``/``aspp`` for DeepLabV3), and emits the reference's key
names exactly as floodseg_tpu/models/lightning_export.py does:
``export_pspnet_variables(..., flow=False)``,
``export_deeplabv3_variables``, ``export_vit_encoder(p["encoder"],
"encoder.")`` with ``export_mask_transformer(p["decoder"], "decoder.")``,
and ``export_s4gan_discriminator`` for an s4GAN discriminator's tree
(``conv1``..``conv4`` and ``final``, no ``batch_stats``).
The port keeps its own copy of that mapping and needs no JAX at run time:

  conv  HWIO kernel -> OIHW ``weight`` (+ ``bias``)
  BN    scale/bias -> weight/bias, batch_stats mean/var ->
        running_mean/running_var, plus ``num_batches_tracked`` = 0
  trunk layerX_blockY.convZ/bnZ/downsample_{conv,bn} -> layerX.Y.convZ/bnZ/
        downsample.{0,1}

PSPNet (the reference's names):
  stem  conv1/bn1/conv2/bn2/conv3/bn3 -> layer0.{0,1,3,4,6,7}
  PPM   binI_conv/binI_bn -> ppm.features.I.{1,2}
  heads cls/aux conv1/bn/conv2 -> cls/aux.{0,1,4}

DeepLabV3 (torchvision's names, all of the trunk under ``backbone.``):
  stem  conv1/bn1 -> backbone.conv1/bn1
  ASPP  b0_conv/b0_bn, bI_conv/bI_bn -> classifier.0.convs.{0,I}.{0,1};
        pool_conv/pool_bn -> classifier.0.convs.4.{1,2};
        project_conv/project_bn -> classifier.0.project.{0,1}
  head  conv/bn/classifier -> classifier.{1,2,4}
  aux   aux_classifier conv/bn/classifier -> aux_classifier.{0,1,4}

Segmenter ViT (timm's and Segmenter's names):
  linear  (in, out) kernel -> (out, in) ``weight`` (+ ``bias``)
  LN      scale/bias -> weight/bias
  patch   patch_proj (P*P*C, D) kernel, rows in (py, px, c) order ->
          OIHW conv weight (D, C, P, P) ``encoder.patch_embed.proj``
  encoder cls_token, pos_embed, norm; blockI.{norm1, attn.qkv, attn.proj,
          norm2, mlp.fc1, mlp.fc2} -> encoder.blocks.I.*
  decoder proj_dec, cls_emb, proj_patch, proj_classes, decoder_norm,
          mask_norm, blocks.I.* under ``decoder.``; the linear decoder's
          head -> decoder.head
  ViTClassifier (a tree of ``encoder`` and ``head``): the encoder as
          above, the head -> head

s4GAN discriminator:
  conv1..conv4 -> layers.{0,3,6,9}; final (a linear head) -> final.0

U2PL's rep head (a tree with ``rep``): the reference's ModelRepresentation
layout that ``_export_role`` emits, the model's keys under ``model.`` and
the head under ``rep.``: PSPNet ``model.*`` + rep conv1/bn/conv2 ->
``rep.{0,1,4}``; DeepLabV3 ``model.model.*`` + ``rep.{0,1,4}``; the ViT
``model.model.*`` + the rep MaskTransformer under ``rep.rep_model.``
(models/semi.py builds these modules).

``load_jax_variables`` strict-loads the result into a port model.
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


def _scale_bias(out: dict, p: Mapping, key: str) -> None:
    out[f"{key}.weight"] = _f32(p["scale"])
    out[f"{key}.bias"] = _f32(p["bias"])


def _bn(out: dict, p: Mapping, s: Mapping, key: str) -> None:
    _scale_bias(out, p, key)
    out[f"{key}.running_mean"] = _f32(s["mean"])
    out[f"{key}.running_var"] = _f32(s["var"])
    out[f"{key}.num_batches_tracked"] = np.asarray(0, dtype=np.int64)


def _conv_bn(out: dict, p: Mapping, s: Mapping, conv: str, bn: str,
             conv_key: str, bn_key: str) -> None:
    _conv(out, p[conv], conv_key)
    _bn(out, p[bn], s[bn], bn_key)


def _seg_head(out: dict, p: Mapping, s: Mapping, key: str) -> None:
    _conv_bn(out, p, s, "conv1", "bn", f"{key}.0", f"{key}.1")
    _conv(out, p["conv2"], f"{key}.4")


def _trunk(out: dict, bp: Mapping, bs: Mapping, stem: Mapping[str, str],
           prefix: str = "") -> None:
    """The stem's convs and BNs under the names in ``stem``, then every
    bottleneck of layer1..4."""
    for name, key in stem.items():
        if name.startswith("conv"):
            _conv(out, bp[name], prefix + key)
        else:
            _bn(out, bp[name], bs[name], prefix + key)
    for name in bp:
        if not name.startswith("layer"):
            continue
        li, bi = name[len("layer"):].split("_block")
        key = f"{prefix}layer{li}.{bi}"
        for ci in (1, 2, 3):
            _conv_bn(out, bp[name], bs[name], f"conv{ci}", f"bn{ci}",
                     f"{key}.conv{ci}", f"{key}.bn{ci}")
        if "downsample_conv" in bp[name]:
            _conv_bn(out, bp[name], bs[name], "downsample_conv", "downsample_bn",
                     f"{key}.downsample.0", f"{key}.downsample.1")


# The top-level key of the JAX variable tree that each state_dict key comes
# from, by the key's first component, as the bridge below names them:
# PSPNet's trunk (layer0 the stem, layer1-4) is the JAX ``backbone``, the
# DeepLabV3 trunk keeps ``backbone.``, the ViT's parts keep their names;
# the U2PL rep head is ``rep`` in every architecture.
JAX_TOP_LEVEL = {
    "pspnet": {**{f"layer{i}": "backbone" for i in range(5)},
               "ppm": "ppm", "cls": "cls", "aux": "aux", "rep": "rep"},
    "deeplabv3": {"backbone": "backbone", "classifier": "classifier",
                  "aux_classifier": "aux_classifier", "rep": "rep"},
    "vit": {"encoder": "encoder", "decoder": "decoder", "rep": "rep"},
}


def jax_top_level(arch: str, key: str) -> str:
    """The JAX tree's top-level key of the port's state_dict ``key`` (a
    rep-head model's ``model.`` prefixes are seen through)."""
    while key.startswith("model."):
        key = key[len("model."):]
    first = key.split(".", 1)[0]
    try:
        return JAX_TOP_LEVEL[arch][first]
    except KeyError:
        raise KeyError(f"{key!r} has no counterpart in the JAX {arch} tree") from None


_PSP_STEM = {"conv1": "layer0.0", "bn1": "layer0.1", "conv2": "layer0.3",
             "bn2": "layer0.4", "conv3": "layer0.6", "bn3": "layer0.7"}
_TV_STEM = {"conv1": "conv1", "bn1": "bn1"}


def _pspnet(p: Mapping, s: Mapping) -> Dict[str, np.ndarray]:
    """A PSPNet tree; with ``rep``, the ModelRepresentation layout."""
    out: Dict[str, np.ndarray] = {}
    _trunk(out, p["backbone"], s["backbone"], _PSP_STEM)
    for i in range(len([k for k in p["ppm"] if k.endswith("_conv")])):
        _conv_bn(out, p["ppm"], s["ppm"], f"bin{i}_conv", f"bin{i}_bn",
                 f"ppm.features.{i}.1", f"ppm.features.{i}.2")
    _seg_head(out, p["cls"], s["cls"], "cls")
    if "aux" in p:
        _seg_head(out, p["aux"], s["aux"], "aux")
    return _with_rep(out, p, s, "model.")


def _with_rep(out: Dict[str, np.ndarray], p: Mapping, s: Mapping,
              prefix: str) -> Dict[str, np.ndarray]:
    """``out`` itself for a tree without ``rep``; else ``out`` under
    ``prefix`` plus the CNN rep head as ``rep.{0,1,4}``."""
    if "rep" not in p:
        return out
    wrapped = {prefix + k: v for k, v in out.items()}
    _seg_head(wrapped, p["rep"], s["rep"], "rep")
    return wrapped


def _deeplabv3(p: Mapping, s: Mapping) -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    _trunk(out, p["backbone"], s["backbone"], _TV_STEM, prefix="backbone.")
    ap, as_ = p["classifier"]["aspp"], s["classifier"]["aspp"]
    for i in range(4):
        _conv_bn(out, ap, as_, f"b{i}_conv", f"b{i}_bn",
                 f"classifier.0.convs.{i}.0", f"classifier.0.convs.{i}.1")
    _conv_bn(out, ap, as_, "pool_conv", "pool_bn",
             "classifier.0.convs.4.1", "classifier.0.convs.4.2")
    _conv_bn(out, ap, as_, "project_conv", "project_bn",
             "classifier.0.project.0", "classifier.0.project.1")
    _conv_bn(out, p["classifier"], s["classifier"], "conv", "bn",
             "classifier.1", "classifier.2")
    _conv(out, p["classifier"]["classifier"], "classifier.4")
    if "aux_classifier" in p:
        _conv_bn(out, p["aux_classifier"], s["aux_classifier"], "conv", "bn",
                 "aux_classifier.0", "aux_classifier.1")
        _conv(out, p["aux_classifier"]["classifier"], "aux_classifier.4")
    return _with_rep(out, p, s, "model.model.")


def _linear(out: dict, p: Mapping, key: str) -> None:
    out[f"{key}.weight"] = _f32(p["kernel"]).T
    if "bias" in p:
        out[f"{key}.bias"] = _f32(p["bias"])


def _vit_block(out: dict, p: Mapping, key: str) -> None:
    for ln in ("norm1", "norm2"):
        _scale_bias(out, p[ln], f"{key}.{ln}")
    for sub, name in (("attn", "qkv"), ("attn", "proj"), ("mlp", "fc1"), ("mlp", "fc2")):
        _linear(out, p[sub][name], f"{key}.{sub}.{name}")


def _vit_blocks(out: dict, p: Mapping, prefix: str) -> None:
    for name in p:
        if name.startswith("block"):
            _vit_block(out, p[name], f"{prefix}blocks.{name[len('block'):]}")


def _vit_encoder(out: dict, p: Mapping, prefix: str) -> None:
    k = _f32(p["patch_proj"]["kernel"])
    d = k.shape[1]
    patch = int(round((k.shape[0] // 3) ** 0.5))  # RGB frames
    if patch * patch * 3 != k.shape[0]:
        raise ValueError(f"patch kernel rows {k.shape[0]} are not P*P*3")
    out[f"{prefix}patch_embed.proj.weight"] = k.reshape(patch, patch, 3, d).transpose(3, 2, 0, 1)
    out[f"{prefix}patch_embed.proj.bias"] = _f32(p["patch_proj"]["bias"])
    out[f"{prefix}cls_token"] = _f32(p["cls_token"])
    out[f"{prefix}pos_embed"] = _f32(p["pos_embed"])
    _scale_bias(out, p["norm"], f"{prefix}norm")
    _vit_blocks(out, p, prefix)


def _mask_transformer(out: dict, p: Mapping, prefix: str) -> None:
    _linear(out, p["proj_dec"], f"{prefix}proj_dec")
    for name in ("cls_emb", "proj_patch", "proj_classes"):
        out[f"{prefix}{name}"] = _f32(p[name])
    for ln in ("decoder_norm", "mask_norm"):
        _scale_bias(out, p[ln], f"{prefix}{ln}")
    _vit_blocks(out, p, prefix)


def _vit(p: Mapping) -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    _vit_encoder(out, p["encoder"], "encoder.")
    if "decoder" not in p:  # ViTClassifier
        _linear(out, p["head"], "head")
        return out
    if "head" in p["decoder"]:
        _linear(out, p["decoder"]["head"], "decoder.head")
    else:
        _mask_transformer(out, p["decoder"], "decoder.")
    if "rep" not in p:
        return out
    wrapped = {"model.model." + k: v for k, v in out.items()}
    _mask_transformer(wrapped, p["rep"], "rep.rep_model.")
    return wrapped


def _discriminator(p: Mapping) -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    for i, li in enumerate((0, 3, 6, 9)):
        _conv(out, p[f"conv{i + 1}"], f"layers.{li}")
    _linear(out, p["final"], "final.0")
    return out


def from_jax_variables(variables: Mapping) -> Dict[str, np.ndarray]:
    """JAX PSPNet, DeepLabV3, SegmenterViT (each with or without the U2PL
    rep head), ViTClassifier or S4GANDiscriminator variables -> the
    reference's state_dict (numpy)."""
    p = variables["params"]
    if "final" in p and "conv1" in p:
        return _discriminator(p)
    if "patch_proj" in p.get("encoder", {}):
        return _vit(p)
    s = variables["batch_stats"]
    if "ppm" in p:
        return _pspnet(p, s)
    if "aspp" in p.get("classifier", {}):
        return _deeplabv3(p, s)
    raise ValueError(f"not a PSPNet, DeepLabV3, SegmenterViT or S4GANDiscriminator variable "
                     f"tree: {sorted(p)}")


def load_jax_variables(model: torch.nn.Module, variables: Mapping) -> torch.nn.Module:
    """Strict-load JAX PSPNet, DeepLabV3, SegmenterViT or S4GANDiscriminator
    variables into the port's ``model``."""
    state = {k: torch.from_numpy(np.array(v))  # a writable copy of each leaf
             for k, v in from_jax_variables(variables).items()}
    model.load_state_dict(state, strict=True)
    return model
