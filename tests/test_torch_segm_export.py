"""The port's Lightning export (floodseg_tpu_torch/models/lightning_export.py)
against the JAX package's ``export_lightning_checkpoint`` on the same
weights, on the CPU.

For every method layout the JAX package's tests cover (supervised PSPNet
with and without the rep head, contrastive PSPNet with a teacher, s4GAN
PSPNet with its discriminator, flow_supervised FlowPSPNet with its alias
keys, flow_gan FlowDeepLabv3, supervised DeepLabV3 with the rep head, the
Segmenter ViT bare and with its rep head): JAX variables drawn from numpy
in the init's shapes (standard normal float32), the port's roles the weight bridge's state_dicts of
them. The exported key sets are equal and every value equal bit for bit,
dtype included (the ``num_batches_tracked`` leaves 0 as int64, whatever
the port's BN counted). The port's ``import_lightning_checkpoint`` of the
export gives the roles back (without the aux head for a flow layout, which
the reference's FlowModel lacks). A ViT flow layout raises on both sides.
``cli/export_ckpt.py`` writes the file of a checkpoint the port's CLI
saved.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from floodseg_tpu.models import build_model as jax_build_model
from floodseg_tpu.models.discriminator import S4GANDiscriminator as JaxDiscriminator
from floodseg_tpu.models.lightning_export import (
    export_lightning_checkpoint as jax_export,
)
from floodseg_tpu.models.vit import SegmenterViT as JaxSegmenterViT

from floodseg_tpu_torch.models import from_jax_variables
from floodseg_tpu_torch.models.lightning_export import export_lightning_checkpoint
from floodseg_tpu_torch.models.torch_import import import_lightning_checkpoint

VIT = dict(image_size=64, patch_size=32, d_model=64, n_layers=1, dec_layers=1, n_heads=2)


@functools.lru_cache(maxsize=None)
def _shapes(kind):
    """The init's shapes of ``kind`` (pspnet[_aux][_rep],
    deeplabv3[_aux][_rep], vit[_rep], disc); the rep heads come from a
    training-mode init."""
    base = kind.split("_")[0]
    rep, aux = kind.endswith("_rep"), "_aux" in kind
    if base in ("pspnet", "deeplabv3"):
        model = jax_build_model(base, classes=5, layers=50, with_aux=aux, semisupervised=rep)
        x = jnp.zeros((1, 65, 65, 3))
    elif base == "disc":
        model, x = JaxDiscriminator(num_classes=5), jnp.zeros((1, 64, 64, 8))
    else:
        model, x = JaxSegmenterViT(classes=5, with_rep=rep, **VIT), jnp.zeros((1, 64, 64, 3))
    key = jax.random.PRNGKey(0)
    kw = {"train": rep} if base != "disc" else {}
    return dict(jax.eval_shape(lambda: model.init({"params": key, "dropout": key}, x, **kw)))


def _variables(kind, rng):
    """JAX variables of ``kind``, every leaf standard normal float32 from
    ``rng`` (an export moves values; it needs no init's statistics)."""
    return jax.tree.map(lambda a: rng.standard_normal(a.shape, dtype=np.float32), _shapes(kind))


CASES = {  # name: (arch, family, roles)
    "pspnet_supervised": ("pspnet", "supervised", {"model": "pspnet_aux"}),
    "pspnet_rep_supervised": ("pspnet", "supervised", {"model": "pspnet_aux_rep"}),
    "pspnet_contrastive": ("pspnet", "contrastive", {"model": "pspnet_aux_rep",
                                                     "teacher": "pspnet_aux_rep"}),
    "pspnet_gan": ("pspnet", "gan", {"model": "pspnet", "discriminator": "disc"}),
    "pspnet_flow_supervised": ("pspnet", "flow_supervised", {"model": "pspnet_aux"}),
    "deeplabv3_flow_gan": ("deeplabv3", "flow_gan", {"model": "deeplabv3_aux",
                                                     "discriminator": "disc"}),
    "deeplabv3_rep_supervised": ("deeplabv3", "supervised", {"model": "deeplabv3_rep"}),
    "vit_supervised": ("vit", "supervised", {"model": "vit"}),
    "vit_rep_contrastive": ("vit", "contrastive", {"model": "vit_rep", "teacher": "vit_rep"}),
}


def _port_roles(variables):
    return {role: {k: torch.from_numpy(np.array(v)) for k, v in from_jax_variables(tree).items()}
            for role, tree in variables.items()}


@pytest.mark.parametrize("case", sorted(CASES))
def test_export_equals_jax_and_round_trips(case):
    arch, family, roles = CASES[case]
    rng = np.random.default_rng(sorted(CASES).index(case))
    variables = {role: _variables(kind, rng) for role, kind in roles.items()}
    ports = _port_roles(variables)
    for sd in ports.values():  # a trained BN counts; the export writes 0
        for k in sd:
            if k.endswith("num_batches_tracked"):
                sd[k] = torch.tensor(12, dtype=torch.int64)
    ref = jax_export(arch, variables, family, epoch=5)
    ours = export_lightning_checkpoint(arch, ports, family, epoch=5)
    assert ours["epoch"] == ref["epoch"] == 5
    assert sorted(ours["state_dict"]) == sorted(ref["state_dict"])
    for k, want in ref["state_dict"].items():
        got = ours["state_dict"][k].numpy()
        assert got.dtype == np.asarray(want).dtype and np.array_equal(got, want), k
    back = import_lightning_checkpoint(ours)
    assert (back["arch"], back["method_family"], back["epoch"]) == (arch, family, 5)
    assert back["roles"].keys() == ports.keys()
    flow = family.startswith("flow")
    for role, sd in ports.items():
        want = {k: v for k, v in sd.items()
                if not (flow and k.startswith(("aux.", "aux_classifier.")))
                and not k.endswith("num_batches_tracked")}
        got = {k: v for k, v in back["roles"][role].items()
               if not k.endswith("num_batches_tracked")}
        assert got.keys() == want.keys(), role
        for k in want:
            assert torch.equal(got[k], want[k]), (role, k)


def test_vit_flow_export_raises():
    ports = _port_roles({"model": _variables("vit", np.random.default_rng(0))})
    with pytest.raises(ValueError, match="no vit flow layout"):
        export_lightning_checkpoint("vit", ports, "flow_supervised")
