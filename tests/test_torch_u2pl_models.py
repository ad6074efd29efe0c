"""The U2PL rep heads (floodseg_tpu_torch/models/semi.py,
``build_model(..., semisupervised=True)``) against the JAX package on the
CPU.

- For each architecture, the state_dict keys and shapes of the model with
  its rep head equal those ``lightning_export._export_role`` emits for the
  JAX model's tree (PSPNet ``model.*`` + ``rep.{0,1,4}``, DeepLabV3 and the
  ViT ``model.model.*`` + ``rep.*``), which the weight bridge gives and
  which strict-load into the port's model; ``head_mask`` marks the rep
  head, as every head, at 10x LR, equal to JAX's head mask carried through
  the bridge.
- The narrow ViT of tests/torch_u2pl_fixtures.py in training mode (dropout
  0) against JAX on 96 px frames, float64: pred and rep within 1e-10 of
  their scale; the rep is resized twice with align_corners=True, first to (1 + N, D), and
  that hop changes the map (checked against a single resize).
- The CNN rep heads on a random feature map through the bridge (PSPNet's
  on a 4096-channel map, DeepLabV3's on a 2048-channel one, float32, eval
  mode), resized to the input as each model resizes it: within 1e-5 of
  scale.
- The teacher's BN statistics move through its own training-mode forwards
  only (a port-only check on PSPNet-50 at 33 px, float32, which the ViT
  trajectory cannot see: the ViT has no BN): after a sup step they equal
  those of a training-mode forward of a copy of the teacher on the labeled
  batch, the student's are its own; after the sync and a semi step whose
  coin is not taken they equal a copy's forward on labeled + unlabeled,
  and the teacher's parameters are the student's tensors.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from floodseg_tpu.models import build_model as jax_build_model
from floodseg_tpu.models.lightning_export import _export_role
from floodseg_tpu.models.vit import SegmenterViT as JaxSegmenterViT
from floodseg_tpu.ops.resize import resize_bilinear as jax_resize

from floodseg_tpu_torch.models import (
    SegmenterViT,
    build_model,
    convert,
    init_from_generator_,
    load_jax_variables,
    with_rep,
)
from floodseg_tpu_torch.ops.u2pl import U2PLDraws
from floodseg_tpu_torch.ops.resize import resize_bilinear
from floodseg_tpu_torch.train import (
    ContrastiveConfig,
    create_u2pl_state,
    head_mask,
    make_optimizer,
    make_u2pl_steps,
    sync_teacher,
)

from torch_port_fixtures import _numpy_init, jax_head_mask_through_bridge
from torch_u2pl_fixtures import jax_model, port_model, t, weights
from torch_port_fixtures import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

HW = 96
VIT = dict(image_size=64, patch_size=32, d_model=64, n_layers=1, dec_layers=1, n_heads=2)


def _jax_model(arch):
    if arch == "vit":
        return JaxSegmenterViT(classes=5, with_rep=True, **VIT)
    return jax_build_model(arch, classes=5, layers=50, semisupervised=True)


def _shapes(arch):
    jm, size = _jax_model(arch), 64 if arch == "vit" else 65
    key = jax.random.PRNGKey(0)
    return jax.eval_shape(lambda: jm.init({"params": key, "dropout": key},
                                          jnp.zeros((1, size, size, 3)), train=True))


def _port(arch):
    if arch == "vit":
        return with_rep(SegmenterViT(classes=5, **VIT)).eval()
    return build_model(arch, classes=5, layers=50, semisupervised=True)


@pytest.mark.parametrize("arch", ["pspnet", "deeplabv3", "vit"])
def test_rep_model_keys_are_the_reference_layout(arch):
    shapes = _shapes(arch)
    variables = _numpy_init(dict(shapes), np.random.default_rng(0))
    want = _export_role(arch, variables)
    got = convert.from_jax_variables(variables)
    port = _port(arch)
    assert set(got) == set(want) == set(port.state_dict())
    assert {k for k in got if k.startswith("rep.")} and all(
        k.startswith(("model.", "rep.")) for k in got)
    for k, v in want.items():
        assert np.shape(got[k]) == np.shape(v) == tuple(port.state_dict()[k].shape), k
    load_jax_variables(port, variables)  # strict
    mask = head_mask(port)
    want_mask = jax_head_mask_through_bridge(variables)
    assert mask == {k: want_mask[k] for k in mask}
    rep = [k for k in mask if k.startswith("rep.")]
    assert rep and all(mask[k] for k in rep) and not all(mask.values())


def test_vit_rep_forward_matches_jax():
    """Training mode without dropout, on 96 px frames (a 3x3 token grid: on
    2x2 every align_corners resize is one linear map, and the hop could not
    show): pred and the twice-resized rep."""
    v = weights(40)
    jm = jax_model(dropout=0.0)
    x = np.random.default_rng(41).standard_normal((2, HW, HW, 3))
    with jax.enable_x64(True):
        want = jm.apply(v, jnp.asarray(x), train=True)
    port = port_model(v)
    for mod in port.modules():
        if hasattr(mod, "rate"):
            mod.rate = 0.0
    port.train()
    out = port(t(x))
    assert set(out) == {"pred", "rep"} and tuple(out["rep"].shape) == (2, HW, HW, 256)
    for k in ("pred", "rep"):
        w = np.asarray(want[k])
        np.testing.assert_allclose(out[k].detach().numpy(), w, rtol=0,
                                   atol=1e-10 * np.abs(w).max(), err_msg=k)
    port.eval()
    assert set(port(t(x))) == {"pred"}
    # the extra hop to (1 + N, D) is not the identity: one resize differs
    port.train()
    _, tokens = port.model(t(x), with_feature=True)
    direct = resize_bilinear(port.rep.rep_model(tokens[:, 1:], (HW, HW)), (HW, HW),
                             align_corners=True)
    assert np.abs(direct.detach().numpy() - np.asarray(want["rep"])).max() > 1e-3


@pytest.mark.parametrize("arch", ["pspnet", "deeplabv3"])
def test_cnn_rep_head_matches_jax_through_the_bridge(arch):
    shapes = _shapes(arch)
    variables = _numpy_init(dict(shapes), np.random.default_rng(1))
    rng = np.random.default_rng(2)
    for k in ("scale", "bias"):
        variables["params"]["rep"]["bn"][k] = rng.uniform(0.5, 1.5, 256).astype(np.float32)
    for k in ("mean", "var"):
        variables["batch_stats"]["rep"]["bn"][k] = rng.uniform(0.5, 1.5, 256).astype(np.float32)
    channels = 4096 if arch == "pspnet" else 2048
    f = rng.standard_normal((2, 9, 9, channels)).astype(np.float32)
    jm = _jax_model(arch)
    want = jm.apply(variables, jnp.asarray(f), method=lambda m, x: m.rep_head(x, False))
    want = np.asarray(jax_resize(want, (65, 65), align_corners=True))
    port = load_jax_variables(build_model(arch, classes=5, layers=50, semisupervised=True),
                              variables)
    got = port.rep(t(f), (65, 65)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())


class _NoCoin(U2PLDraws):
    def coin(self):
        return torch.ones((), dtype=torch.float64)


def _bn_stats(module):
    return {k: v.clone() for k, v in module.state_dict().items() if "running" in k}


def test_teacher_bn_statistics_follow_its_own_train_forwards():
    model = init_from_generator_(build_model("pspnet", classes=5, layers=50,
                                             semisupervised=True),
                                 torch.Generator().manual_seed(3))
    opt, sched = make_optimizer(model, 1e-3, 4)
    state = create_u2pl_state(model, opt, sched, bank_capacity=64, bank_class0_capacity=64,
                              max_enqueue=32, seed=4)
    rng = np.random.default_rng(5)
    image_l = t(rng.standard_normal((2, 33, 33, 3)).astype(np.float32))
    image_u = t(rng.standard_normal((2, 33, 33, 3)).astype(np.float32))
    label_l = t(rng.integers(0, 5, (2, 33, 33)).astype(np.int32))
    batch = {"l": {"frame_current": image_l, "label": label_l},
             "u": {"frame_current": image_u}}
    sup, semi = make_u2pl_steps(5, ContrastiveConfig(num_queries=8, num_negatives=4,
                                                     max_enqueue=32), aux_weight=0.4)

    def forward_copy(module, x):
        c = copy.deepcopy(module).train()
        with torch.no_grad():
            for mod in c.modules():
                if hasattr(mod, "rate"):
                    mod.rate = 0.0  # dropout follows every BN: the statistics do not see it
            c(x)
        return _bn_stats(c)

    t0, s0 = _bn_stats(state.teacher), _bn_stats(model)
    want = forward_copy(state.teacher, image_l)
    state, _ = sup(state, batch, torch.Generator().manual_seed(6))
    got = _bn_stats(state.teacher)
    assert all(torch.equal(got[k], want[k]) for k in want)
    assert all(not torch.equal(got[k], t0[k]) for k in got)
    student = _bn_stats(model)
    assert all(not torch.equal(student[k], got[k]) and not torch.equal(student[k], s0[k])
               for k in student)

    sync_teacher(state)
    want = forward_copy(state.teacher, torch.cat([image_l, image_u]))
    state, m = semi(state, batch, torch.Generator().manual_seed(7), 0.5, 0,
                    draws=_NoCoin(torch.device("cpu"), 1, 2, 3))
    got = _bn_stats(state.teacher)
    assert all(torch.equal(got[k], want[k]) for k in want)
    params = dict(model.named_parameters())
    assert all(p is params[n] for n, p in state.teacher.named_parameters())
    assert all(np.isfinite(float(m[k])) for k in ("loss", "sup_loss", "unsup_loss",
                                                  "contra_loss"))
