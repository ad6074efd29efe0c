"""DeepLabV3 training against the JAX package on the CPU: one interpolated,
one plain and one eval step of DeepLabV3-50 with its aux head at 33 px,
and one supervised (single-frame) step with the aux loss at 0.4, float64;
the port's element dropout against flax's ``nn.Dropout``; the head mask
for DeepLabV3-101 and ViT-B/32; and the bridge on a DeepLabV3-101 tree.

Both sides start from the same weights (JAX's init with every BN
perturbed, carried through the weight bridge) and take the same batch as
tests/test_torch_train_flow.py's: chains of 1 and 3 (left) and 4 and 2
(right) warps on 2x2 grids that are multiples of 2**-10, labels with
ignored pixels, OHEM with min_kept 200 below the 2178 pixels, SGD with
momentum, weight decay and the head group at 10x. The JAX steps run
jitted under ``jax.enable_x64``. The port's dropout takes the keep masks
flax draws in the JAX step's own calls (recorded by module path, injected
by the port's module name, NHWC masks transposed to NCHW): the ASPP
projection's (rate 0.5) in every decode, and the FCNHead's (0.1) in the
supervised forward.

Tolerances: the loss within rtol 1e-8; every parameter (the aux head's,
which flow training decays and moves without a gradient, included) and
every BN statistic within 1e-7 of its tensor's largest magnitude; eval
counts equal. The dropout is bit-equal to flax's in float32 and bf16.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from floodseg_tpu.models import build_model as jax_build_model
from floodseg_tpu.models.deeplabv3 import DeepLabV3 as JaxDeepLabV3
from floodseg_tpu.models.vit import SegmenterViT as JaxSegmenterViT
from floodseg_tpu.train import flow as jflow
from floodseg_tpu.train import supervised as jax_sup
from floodseg_tpu.train.optim import make_optimizer as jax_make_optimizer
from floodseg_tpu.train.state import TrainState as JaxTrainState
from floodseg_tpu.train.supervised import make_loss_fn as jax_make_loss_fn

from floodseg_tpu_torch.models import build_model, from_jax_variables, load_jax_variables
from floodseg_tpu_torch.models.layers import Dropout
from floodseg_tpu_torch.train import (
    TrainState,
    head_mask,
    make_eval_step,
    make_flow_eval_step,
    make_flow_train_step,
    make_loss_fn,
    make_optimizer,
    make_train_step,
)

from torch_port_fixtures import (
    _perturb_bn,
    _to_dict,
    clear_keep_masks,
    flax_keep_masks,
    inject_keep_masks,
    jax_head_mask_through_bridge,
    port_state,
)
from torch_port_fixtures import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

SIZE, B, T, CLASSES = 33, 2, 4, 5
LR, MAX_ITER, MIN_KEPT = 1e-3, 10, 200
LEFT, RIGHT = (1, 3), (4, 2)
FEAT = (B, 5, 5, 2048)  # DeepLabV3's stride-8 encoding of a 33 px frame
# flax module path -> the port's module name of each DeepLabV3 Dropout
MASK_NAMES = {"classifier/aspp/Dropout_0": "classifier.0.project.3",
              "aux_classifier/Dropout_0": "aux_classifier.3"}
NCHW = tuple(MASK_NAMES)


def _batch(rng):
    base = np.stack(np.meshgrid(np.linspace(-0.75, 0.75, 2), np.linspace(-0.75, 0.75, 2)), -1)

    def grids():
        g = base[None, None] + rng.uniform(-0.2, 0.2, (T, B, 2, 2, 2))
        return (np.round(g * 1024) / 1024).astype(np.float32)

    labels = rng.integers(0, CLASSES, (B, SIZE, SIZE))
    labels = np.where(rng.random(labels.shape) < 0.05, 255, labels).astype(np.int32)
    return {"frame_prev": rng.standard_normal((B, SIZE, SIZE, 3)),
            "frame_next": rng.standard_normal((B, SIZE, SIZE, 3)),
            "frame_current": rng.standard_normal((B, SIZE, SIZE, 3)),
            "mvs_left": grids(), "mvs_right": grids(),
            "left_index": np.array(LEFT, np.int32), "right_index": np.array(RIGHT, np.int32),
            "label": labels}


def _jax_model():
    return JaxDeepLabV3(classes=CLASSES, layers=50, with_aux=True, dtype=jnp.float64)


def _port_tensors(variables):
    return {k: v.numpy() for k, v in port_state(variables).items()}


def _jax_state(v, tx):
    params = jax.tree.map(jnp.asarray, v["params"])
    return JaxTrainState(step=jnp.zeros((), jnp.int32), params=params,
                         batch_stats=jax.tree.map(jnp.asarray, v["batch_stats"]),
                         opt_state=tx.init(params), tx=tx)


def _state_of(s):
    return _port_tensors({"params": s.params, "batch_stats": s.batch_stats})


def _port_model(v):
    port = build_model("deeplabv3", layers=50, with_aux=True, dtype=torch.float64).double()
    port.load_state_dict(port_state(v))
    return port


def _torch_batch(batch):
    return {k: (a if k in ("left_index", "right_index") else torch.from_numpy(a))
            for k, a in batch.items()}


def _snapshot(port):
    return {k: t.detach().numpy().copy() for k, t in port.state_dict().items()}


@pytest.fixture(scope="module")
def init():
    """JAX's float64 DeepLabV3-50 variables with the aux head (every BN
    perturbed) and the batch."""
    key = jax.random.PRNGKey(0)
    with jax.enable_x64(True):
        v = _to_dict(jax.device_get(jax.jit(lambda: _jax_model().init(
            {"params": key, "dropout": key}, jnp.zeros((B, SIZE, SIZE, 3)), train=True))()))
    _perturb_bn(v["params"], v["batch_stats"], np.random.default_rng(23))
    return jax.tree.map(lambda a: np.asarray(a, np.float64), v), _batch(np.random.default_rng(24))


@pytest.fixture(scope="module")
def trajectory(init):
    """interp step, then plain step, then eval, both packages; and the
    supervised step and its eval from the initial state."""
    v, batch = init
    k_interp, k_plain, k_sup = jax.random.PRNGKey(1), jax.random.PRNGKey(2), jax.random.PRNGKey(3)
    with jax.enable_x64(True):
        jm = _jax_model()
        tx = jax_make_optimizer(LR, MAX_ITER)
        state = _jax_state(v, tx)
        vs = {"params": state.params, "batch_stats": state.batch_stats}
        feat = np.zeros(FEAT)
        masks = {"interp": flax_keep_masks(jm, vs, jax.random.split(k_interp, 3)[2], feat,
                                           "decode"),
                 "plain": flax_keep_masks(jm, vs, jax.random.split(k_plain)[1], feat, "decode"),
                 "supervised": flax_keep_masks(jm, vs, k_sup, batch["frame_current"])}
        jb = {k: jnp.asarray(a) for k, a in batch.items()}
        interp, plain = jflow.make_flow_train_step(
            jm, jax_make_loss_fn("ohem", 0.0, 255, 0.7, MIN_KEPT), CLASSES, 255)
        s1, m1 = jax.jit(interp)(state, jb, k_interp)
        s2, m2 = jax.jit(plain)(s1, jb, k_plain)
        ev = jax.jit(jflow.make_flow_eval_step(jm, CLASSES, 255))(s2, jb)
        ss, ms = jax.jit(jax_sup.make_train_step(
            jm, jax_make_loss_fn("ohem", 0.4, 255, 0.7, MIN_KEPT), CLASSES, 255))(
            state, jb, k_sup)
        sev = jax.jit(jax_sup.make_eval_step(jm, CLASSES, 255))(ss, jb)
        counts = ("intersection", "union", "target")
        ref = {"interp": (float(m1["loss"]), _state_of(s1)),
               "plain": (float(m2["loss"]), _state_of(s2)),
               "eval": {k: np.asarray(ev[k]) for k in counts},
               "supervised": (float(ms["loss"]), _state_of(ss)),
               "supervised_eval": {k: np.asarray(sev[k]) for k in counts}}

    port = _port_model(v)
    ours = {"init": _snapshot(port)}
    opt, sched = make_optimizer(port, LR, MAX_ITER)
    st = TrainState(0, port, opt, sched)
    p_interp, p_plain = make_flow_train_step(port, make_loss_fn("ohem", 0.0, 255, 0.7, MIN_KEPT),
                                             CLASSES, 255)
    tb = _torch_batch(batch)
    for name, step in (("interp", p_interp), ("plain", p_plain)):
        inject_keep_masks(port, masks[name], MASK_NAMES, NCHW)
        st, m = step(st, tb, None)
        clear_keep_masks(port)
        ours[name] = (float(m["loss"]), _snapshot(port))
    ev = make_flow_eval_step(port, CLASSES, 255)(st, tb)
    ours["eval"] = {k: ev[k].numpy() for k in ("intersection", "union", "target")}
    ours["steps"] = st.step

    port = _port_model(v)
    opt, sched = make_optimizer(port, LR, MAX_ITER)
    step = make_train_step(port, make_loss_fn("ohem", 0.4, 255, 0.7, MIN_KEPT), CLASSES, 255)
    inject_keep_masks(port, masks["supervised"], MASK_NAMES, NCHW)
    st, m = step(TrainState(0, port, opt, sched), tb, None)
    clear_keep_masks(port)
    ours["supervised"] = (float(m["loss"]), _snapshot(port))
    ev = make_eval_step(port, CLASSES, 255)(st, tb)
    ours["supervised_eval"] = {k: ev[k].numpy() for k in ("intersection", "union", "target")}
    return ref, ours, masks


def _close(got, want, keys):
    for k in keys:
        w = np.asarray(want[k], np.float64)
        np.testing.assert_allclose(got[k], w, rtol=0, atol=1e-7 * np.abs(w).max(), err_msg=k)


@pytest.mark.parametrize("step", ["interp", "plain", "supervised"])
def test_train_step_loss_matches_jax(trajectory, step):
    ref, ours, _ = trajectory
    assert ours[step][0] == pytest.approx(ref[step][0], rel=1e-8)


@pytest.mark.parametrize("part", ["trunk", "heads", "aux", "bn_statistics"])
@pytest.mark.parametrize("step", ["interp", "plain", "supervised"])
def test_train_step_updates_match_jax(trajectory, step, part):
    """Each tensor after the step within 1e-7 of its largest magnitude."""
    ref, ours, _ = trajectory
    want, got = ref[step][1], ours[step][1]
    assert set(got) == set(want)

    def in_part(k):
        stat = k.endswith(("running_mean", "running_var"))
        if part == "bn_statistics":
            return stat
        if stat or k.endswith("num_batches_tracked"):
            return False
        return {"trunk": "backbone", "heads": "classifier",
                "aux": "aux_classifier"}[part] == k.split(".")[0]

    keys = [k for k in want if in_part(k)]
    assert len(keys) > (100 if part in ("trunk", "bn_statistics") else 3)
    _close(got, want, keys)


def test_aux_head_moves_without_a_gradient(trajectory):
    """Flow training never runs the FCNHead, yet the first step decays it:
    p1 = p0 - 10 * lr * wd * p0, as optax does to a zero-gradient parameter;
    the supervised step trains it (its loss at 0.4)."""
    ref, ours, _ = trajectory
    lr = float(np.float32(LR))  # the schedule's float32 LR of step 0
    for k in ("aux_classifier.0.weight", "aux_classifier.1.weight", "aux_classifier.4.weight"):
        p0, p1 = ours["init"][k], ours["interp"][1][k]
        np.testing.assert_allclose(p1, p0 - 10 * lr * 1e-4 * p0, rtol=1e-12, err_msg=k)
        np.testing.assert_allclose(p1, ref["interp"][1][k], rtol=1e-12, err_msg=k)
        assert not np.allclose(ours["supervised"][1][k], p1, rtol=1e-9), k


@pytest.mark.parametrize("step", ["eval", "supervised_eval"])
def test_eval_step_counts_match_jax(trajectory, step):
    ref, ours, _ = trajectory
    for k in ("intersection", "union", "target"):
        np.testing.assert_array_equal(ours[step][k], ref[step][k], err_msg=k)


def test_the_steps_dropped_elements(trajectory):
    """The ASPP projection's masks keep about half of the elements, the
    FCNHead's about 90%; each step took the JAX step's own masks."""
    _, ours, masks = trajectory
    assert ours["steps"] == 2
    assert set(masks["interp"]) == set(masks["plain"]) == {"classifier/aspp/Dropout_0"}
    assert set(masks["supervised"]) == set(MASK_NAMES)
    aspp = masks["supervised"]["classifier/aspp/Dropout_0"]
    fcn = masks["supervised"]["aux_classifier/Dropout_0"]
    assert aspp.shape == (B, 5, 5, 256) and 0.4 < aspp.mean() < 0.6
    assert fcn.shape == (B, 5, 5, 256) and 0.8 < fcn.mean() < 0.97


@pytest.mark.parametrize("rate", [0.1, 0.5])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_element_dropout_matches_flax_given_its_mask(dtype, rate):
    """flax's ``nn.Dropout(rate)`` (no broadcast dims) on an injected keep
    mask: the port's output bit-equal in float32 and bf16 (x / keep_prob
    with keep_prob rounded to the dtype, as flax's weakly typed divide
    does), and its gradient kept on the same elements."""
    rng = np.random.default_rng(9)
    x = rng.standard_normal((2, 5, 6, 48)).astype(np.float32)
    key = jax.random.PRNGKey(4)
    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    drop = fnn.Dropout(rate)
    keep = np.asarray(drop.apply({}, jnp.ones(x.shape, jdt), deterministic=False,
                                 rngs={"dropout": key}) != 0)
    assert 0 < keep.mean() < 1
    ref = drop.apply({}, jnp.asarray(x, jdt), deterministic=False, rngs={"dropout": key})
    d = Dropout(rate).train()
    d.keep = torch.from_numpy(keep)
    xt = torch.from_numpy(x).to(tdt).requires_grad_(True)
    y = d(xt)
    np.testing.assert_array_equal(y.detach().float().numpy(),
                                  np.asarray(ref.astype(jnp.float32)))
    y.float().sum().backward()
    np.testing.assert_array_equal(xt.grad.float().numpy() != 0, keep)


def _variable_shapes(model, size):
    key = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(lambda: model.init({"params": key, "dropout": key},
                                               jnp.zeros((1, size, size, 3)), train=True))
    return jax.tree.map(lambda s: np.zeros(s.shape, np.float32), dict(shapes))


@pytest.mark.parametrize("arch", ["deeplabv3-101", "vit-b32"])
def test_head_mask_equals_jax_at_the_configs(arch):
    """The repository's configurations: DeepLabV3-101 with its aux head
    (deeplabv3.yaml) and ViT-B/32 at image_size 416 (vit.yaml's link of
    the 433 px crop): the 10x parameters equal JAX's head_mask through the
    bridge."""
    if arch == "vit-b32":
        variables = _variable_shapes(JaxSegmenterViT(classes=CLASSES, image_size=416), 416)
        port = build_model("vit", image_size=416)
    else:
        variables = _variable_shapes(jax_build_model("deeplabv3", classes=CLASSES, layers=101,
                                                     with_aux=True), 33)
        port = build_model("deeplabv3", layers=101, with_aux=True)
    want = jax_head_mask_through_bridge(variables)
    ours = head_mask(port)
    assert set(ours) <= set(want)
    assert ours == {k: want[k] for k in ours}
    assert any(ours.values()) and not all(ours.values())


def test_bridge_strict_loads_a_deeplabv3_101_tree():
    """The JAX DeepLabV3-101 tree with the aux head (keys and shapes from
    an abstract init) crosses the bridge into the port's DeepLabV3-101 by
    strict load: every key, every shape, 23 blocks in layer3."""
    variables = _variable_shapes(jax_build_model("deeplabv3", classes=CLASSES, layers=101,
                                                 with_aux=True), 33)
    sd = from_jax_variables(variables)
    port = build_model("deeplabv3", layers=101, with_aux=True)
    want = {k: tuple(v.shape) for k, v in port.state_dict().items()}
    assert {k: tuple(np.shape(v)) for k, v in sd.items()} == want
    load_jax_variables(port, variables)
    assert len(port.backbone.layer3) == 23 and "aux_classifier.4.weight" in sd
