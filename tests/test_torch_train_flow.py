"""One interpolated train step, one plain train step and one eval step of
PSPNet-50 (with its aux head) at 33 px, float64, the port against the JAX
package on the CPU; and one supervised (single-frame) step with the aux
loss and its eval step.

Both sides start from the same weights (JAX's init, every BN perturbed,
carried through the weight bridge) and take the same batch: two samples
with chains of 1 and 3 (left) and 4 and 2 (right) warps on 2x2 block grids
(frame_delta 5), labels with ignored pixels, OHEM with min_kept 200 below
the 2178 pixels, so mining runs, SGD with momentum, weight decay and the
head group at 10x. The JAX steps run jitted under ``jax.enable_x64``; the
port's dropout takes the keep masks flax draws for the decode call, read
by running flax's Dropout on ones inside the same call (an interceptor),
so both drop the same channels. The grids are multiples of 2**-10, so
their float32 tap coordinates are exact whether or not XLA fuses that
arithmetic.

Tolerances: the loss within rtol 1e-8; every parameter (the aux head's,
which gets no gradient but is decayed and moved, included) and every BN
statistic within 1e-7 of its tensor's largest magnitude; eval counts equal.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from floodseg_tpu.models.pspnet import PSPNet as JaxPSPNet
from floodseg_tpu.train import flow as jflow
from floodseg_tpu.train.optim import make_optimizer as jax_make_optimizer
from floodseg_tpu.train.state import TrainState as JaxTrainState
from floodseg_tpu.train import supervised as jax_sup
from floodseg_tpu.train.supervised import make_loss_fn as jax_make_loss_fn

from floodseg_tpu_torch.models import build_model
from floodseg_tpu_torch.models.layers import Dropout
from floodseg_tpu_torch.ops import launch_counts, reset_launch_counts
from floodseg_tpu_torch.train import (
    TrainState,
    make_eval_step,
    make_flow_eval_step,
    make_flow_train_step,
    make_loss_fn,
    make_optimizer,
    make_train_step,
)

from torch_port_fixtures import _perturb_bn, _to_dict, port_state
from torch_port_fixtures import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

SIZE, B, T, CLASSES = 33, 2, 4, 5
LR, MAX_ITER, MIN_KEPT = 1e-3, 10, 200
LEFT, RIGHT = (1, 3), (4, 2)


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


def _decode_keep_mask(model, variables, key, feat_shape):
    """The (B, 512) keep mask flax's cls Dropout draws in a training decode
    call with dropout key ``key``: the call the JAX step makes, with the
    Dropout's input replaced by ones."""
    masks = []

    def interceptor(next_fun, args, kwargs, context):
        if isinstance(context.module, fnn.Dropout) and context.method_name == "__call__":
            out = next_fun(jnp.ones_like(args[0]), *args[1:], **kwargs)
            masks.append(np.asarray(out[:, 0, 0, :] != 0))
            return out
        return next_fun(*args, **kwargs)

    with fnn.intercept_methods(interceptor):
        model.apply(variables, jnp.zeros(feat_shape), train=True, method="decode",
                    rngs={"dropout": key}, mutable=["batch_stats"])
    assert len(masks) == 1
    return masks[0]


def _port_tensors(variables):
    return {k: v.numpy() for k, v in port_state(variables).items()}


def _jax_model():
    return JaxPSPNet(classes=CLASSES, layers=50, dropout=0.1, with_aux=True,
                     dtype=jnp.float64)


@pytest.fixture(scope="module")
def init():
    """JAX's float64 PSPNet-50 variables (every BN perturbed) and the batch."""
    key = jax.random.PRNGKey(0)
    with jax.enable_x64(True):
        v = _to_dict(jax.device_get(jax.jit(lambda: _jax_model().init(
            {"params": key, "dropout": key}, jnp.zeros((B, SIZE, SIZE, 3)), train=True))()))
    _perturb_bn(v["params"], v["batch_stats"], np.random.default_rng(22))
    return jax.tree.map(lambda a: np.asarray(a, np.float64), v), _batch(np.random.default_rng(21))


def _jax_state(v, tx):
    params = jax.tree.map(jnp.asarray, v["params"])
    return JaxTrainState(step=jnp.zeros((), jnp.int32), params=params,
                         batch_stats=jax.tree.map(jnp.asarray, v["batch_stats"]),
                         opt_state=tx.init(params), tx=tx)


def _port_model(v):
    port = build_model("pspnet", with_aux=True, dtype=torch.float64).double()
    port.load_state_dict({k: torch.from_numpy(np.array(a)) for k, a in _port_tensors(v).items()})
    return port


def _torch_batch(batch):
    return {k: (a if k in ("left_index", "right_index") else torch.from_numpy(a))
            for k, a in batch.items()}


@pytest.fixture(scope="module")
def trajectory(init):
    v, batch = init
    k_interp, k_plain = jax.random.PRNGKey(1), jax.random.PRNGKey(2)
    with jax.enable_x64(True):
        jm = _jax_model()
        tx = jax_make_optimizer(LR, MAX_ITER)
        state = _jax_state(v, tx)
        loss_fn = jax_make_loss_fn("ohem", 0.0, 255, 0.7, MIN_KEPT)
        interp, plain = jflow.make_flow_train_step(jm, loss_fn, CLASSES, 255)
        jb = {k: jnp.asarray(a) for k, a in batch.items()}
        feat = (B, 5, 5, 4096)
        vs = {"params": state.params, "batch_stats": state.batch_stats}
        masks = {"interp": _decode_keep_mask(jm, vs, jax.random.split(k_interp, 3)[2], feat)}
        s1, m1 = jax.jit(interp)(state, jb, k_interp)
        vs = {"params": s1.params, "batch_stats": s1.batch_stats}
        masks["plain"] = _decode_keep_mask(jm, vs, jax.random.split(k_plain)[1], feat)
        s2, m2 = jax.jit(plain)(s1, jb, k_plain)
        ev = jax.jit(jflow.make_flow_eval_step(jm, CLASSES, 255))(s2, jb)
        ref = {
            "interp": (float(m1["loss"]), _port_tensors({"params": s1.params,
                                                         "batch_stats": s1.batch_stats})),
            "plain": (float(m2["loss"]), _port_tensors({"params": s2.params,
                                                        "batch_stats": s2.batch_stats})),
            "eval": {k: np.asarray(ev[k]) for k in ("intersection", "union", "target")},
        }

    port = _port_model(v)
    ours = {"init": {k: t.detach().numpy().copy() for k, t in port.state_dict().items()}}
    opt, sched = make_optimizer(port, LR, MAX_ITER)
    st = TrainState(0, port, opt, sched)
    p_interp, p_plain = make_flow_train_step(port, make_loss_fn("ohem", 0.0, 255, 0.7, MIN_KEPT),
                                             CLASSES, 255)
    tb = _torch_batch(batch)
    drop = port.cls[3]
    assert isinstance(drop, Dropout) and drop.broadcast_dims == (2, 3)
    reset_launch_counts()
    for name, step in (("interp", p_interp), ("plain", p_plain)):
        drop.keep = torch.from_numpy(masks[name].copy())[:, :, None, None]
        st, m = step(st, tb, None)
        ours[name] = (float(m["loss"]),
                      {k: t.detach().numpy().copy() for k, t in port.state_dict().items()})
    drop.keep = None
    ev = make_flow_eval_step(port, CLASSES, 255)(st, tb)
    ours["eval"] = {k: ev[k].numpy() for k in ("intersection", "union", "target")}
    ours["steps"] = st.step
    ours["launches"] = launch_counts()
    return ref, ours, masks


@pytest.mark.parametrize("step", ["interp", "plain"])
def test_train_step_loss_matches_jax(trajectory, step):
    ref, ours, _ = trajectory
    assert ours[step][0] == pytest.approx(ref[step][0], rel=1e-8)


@pytest.mark.parametrize("part", ["trunk", "heads", "aux", "bn_statistics"])
@pytest.mark.parametrize("step", ["interp", "plain"])
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
        top = k.split(".")[0]
        return {"trunk": top.startswith("layer"), "aux": top == "aux",
                "heads": top in ("ppm", "cls")}[part]

    keys = [k for k in want if in_part(k)]
    assert len(keys) > (100 if part in ("trunk", "bn_statistics") else 3)
    for k in keys:
        w = np.asarray(want[k], np.float64)
        np.testing.assert_allclose(got[k], w, rtol=0, atol=1e-7 * np.abs(w).max(), err_msg=k)


def test_aux_head_moves_without_a_gradient(trajectory):
    """The aux head gets no gradient in flow training, yet the first step
    decays it: p1 = p0 - 10 * lr * wd * p0, as optax does to a zero-gradient
    parameter (the zero-gradient rule of TrainState.apply_gradients)."""
    ref, ours, _ = trajectory
    lr = float(np.float32(LR))  # the schedule's float32 LR of step 0
    for k in ("aux.0.weight", "aux.1.weight", "aux.4.weight"):
        p0, p1 = ours["init"][k], ours["interp"][1][k]
        np.testing.assert_allclose(p1, p0 - 10 * lr * 1e-4 * p0, rtol=1e-12, err_msg=k)
        np.testing.assert_allclose(p1, ref["interp"][1][k], rtol=1e-12, err_msg=k)
        assert not np.array_equal(p1, ours["plain"][1][k])


def test_eval_step_counts_match_jax(trajectory):
    ref, ours, _ = trajectory
    for k in ("intersection", "union", "target"):
        np.testing.assert_array_equal(ours["eval"][k], ref["eval"][k], err_msg=k)
    assert ref["eval"]["target"].sum() == (_batch(np.random.default_rng(21))["label"]
                                           != 255).sum()


def test_steps_took_the_plain_warps_and_dropped_channels(trajectory):
    """On the CPU the warps take the plain versions (no launch counted);
    both dropout masks drop some channels and keep most."""
    _, ours, masks = trajectory
    assert ours["steps"] == 2
    assert all(v == 0 for v in ours["launches"].values())
    for m in masks.values():
        assert m.shape == (B, 512) and 0.8 < m.mean() < 0.97


def _call_keep_masks(model, variables, key):
    """The keep masks flax's Dropouts draw in one training ``__call__``
    with dropout key ``key``, in call order (cls, then aux): (B, C) each."""
    masks = []

    def interceptor(next_fun, args, kwargs, context):
        if isinstance(context.module, fnn.Dropout) and context.method_name == "__call__":
            out = next_fun(jnp.ones_like(args[0]), *args[1:], **kwargs)
            masks.append(np.asarray(out[:, 0, 0, :] != 0))
            return out
        return next_fun(*args, **kwargs)

    with fnn.intercept_methods(interceptor):
        model.apply(variables, jnp.zeros((B, SIZE, SIZE, 3)), train=True,
                    rngs={"dropout": key}, mutable=["batch_stats"])
    return masks


@pytest.fixture(scope="module")
def supervised(init):
    """One supervised step (the whole PSPNet in training mode on
    frame_current, OHEM on pred + 0.4 x aux, both heads' dropout) and one
    eval step, both packages, float64."""
    v, batch = init
    key = jax.random.PRNGKey(3)
    with jax.enable_x64(True):
        jm = _jax_model()
        tx = jax_make_optimizer(LR, MAX_ITER)
        loss_fn = jax_make_loss_fn("ohem", 0.4, 255, 0.7, MIN_KEPT)
        masks = _call_keep_masks(jm, {"params": v["params"], "batch_stats": v["batch_stats"]},
                                 key)
        s1, m1 = jax.jit(jax_sup.make_train_step(jm, loss_fn, CLASSES, 255))(
            _jax_state(v, tx), {k: jnp.asarray(a) for k, a in batch.items()}, key)
        ev = jax.jit(jax_sup.make_eval_step(jm, CLASSES, 255))(
            s1, {k: jnp.asarray(a) for k, a in batch.items()})
        ref = (float(m1["loss"]), _port_tensors({"params": s1.params,
                                                 "batch_stats": s1.batch_stats}),
               {k: np.asarray(ev[k]) for k in ("intersection", "union", "target")})
    port = _port_model(v)
    opt, sched = make_optimizer(port, LR, MAX_ITER)
    step = make_train_step(port, make_loss_fn("ohem", 0.4, 255, 0.7, MIN_KEPT), CLASSES, 255)
    port.cls[3].keep, port.aux[3].keep = (torch.from_numpy(m.copy())[:, :, None, None]
                                          for m in masks)
    st, m = step(TrainState(0, port, opt, sched), _torch_batch(batch), None)
    ev = make_eval_step(port, CLASSES, 255)(st, _torch_batch(batch))
    ours = (float(m["loss"]), {k: t.detach().numpy() for k, t in port.state_dict().items()},
            {k: ev[k].numpy() for k in ("intersection", "union", "target")})
    return ref, ours, masks


def test_supervised_step_matches_jax(supervised):
    """The loss within rtol 1e-8, every tensor after the step (the aux head
    now trained by its 0.4-weighted loss) within 1e-7 of its scale, the eval
    counts equal; both heads dropped channels."""
    (rl, rs, rev), (ol, os_, oev), masks = supervised
    assert ol == pytest.approx(rl, rel=1e-8)
    assert set(os_) == set(rs)
    for k, w in rs.items():
        w = np.asarray(w, np.float64)
        np.testing.assert_allclose(os_[k], w, rtol=0, atol=1e-7 * np.abs(w).max(), err_msg=k)
    for k in rev:
        np.testing.assert_array_equal(oev[k], rev[k], err_msg=k)
    assert [m.shape for m in masks] == [(B, 512), (B, 256)]
    assert all(0.8 < m.mean() < 0.97 for m in masks)
