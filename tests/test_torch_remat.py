"""Rematerialisation (``build_model(..., remat=True)``, models/resnet.py)
on the CPU, float64.

A remat step keeps each bottleneck's input only and recomputes the block
in the backward. It must be the plain step to the bit: the same loss, the
same parameters after the update and the same BN running statistics,
which the recompute must not move a second time. Held on the port's flow
(interpolated) step of PSPNet-50 with its aux head at 33 px and on one
supervised step of DeepLabV3-50 with its aux head, both from one state
and one dropout generator; and on the count of running-statistics
updates. Then one supervised PSPNet-50 step against the JAX package's
step of a PSPNet built with ``remat=True`` (``nn.remat(Bottleneck)``),
jitted under x64, within the step tests' tolerances
(tests/test_torch_train_flow.py): the loss to rtol 1e-8, every tensor to
1e-7 of its largest magnitude, flax's dropout masks injected.

About 63 s alone, 41-56 s of it JAX's compile of the remat step.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from floodseg_tpu.models.pspnet import PSPNet as JaxPSPNet
from floodseg_tpu.train import supervised as jax_sup
from floodseg_tpu.train.optim import make_optimizer as jax_make_optimizer

from floodseg_tpu_torch.models import build_model, init_from_generator_
from floodseg_tpu_torch.models.layers import BatchNorm2d
from floodseg_tpu_torch.models.resnet import Bottleneck
from floodseg_tpu_torch.train import (
    TrainState,
    make_flow_train_step,
    make_loss_fn,
    make_optimizer,
    make_train_step,
)
from floodseg_tpu_torch.train.fit import step_generator

from test_torch_train_flow import (
    B,
    CLASSES,
    LR,
    MAX_ITER,
    MIN_KEPT,
    SIZE,
    _batch,
    _call_keep_masks,
    _jax_state,
    _port_tensors,
    _torch_batch,
)
from torch_port_fixtures import _numpy_init, _perturb_bn, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _model(arch, remat, state=None):
    m = build_model(arch, with_aux=True, dtype=torch.float64, remat=remat).double()
    if state is None:
        init_from_generator_(m, torch.Generator().manual_seed(4))
    else:
        m.load_state_dict(state)
    return m


def _snapshot(model):
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def _step(arch, model, kind, batch):
    opt, sched = make_optimizer(model, LR, MAX_ITER)
    loss = make_loss_fn("ohem", 0.0 if kind == "flow" else 0.4, 255, 0.7, MIN_KEPT)
    if kind == "flow":
        step = make_flow_train_step(model, loss, CLASSES, 255)[0]
    else:
        step = make_train_step(model, loss, CLASSES, 255)
    _, m = step(TrainState(0, model, opt, sched), batch, step_generator(7, 0))
    return float(m["loss"]), _snapshot(model)


@pytest.fixture(scope="module", params=[("pspnet", "flow"), ("deeplabv3", "supervised")],
                ids=["pspnet_flow", "deeplabv3_supervised"])
def steps(request):
    """The same step from the same state and generator, plain and remat,
    with each real update of a running statistic counted."""
    arch, kind = request.param
    plain = _model(arch, False)
    remat = _model(arch, True, plain.state_dict())
    batch = _torch_batch(_batch(np.random.default_rng(21)))
    updates = []
    update = BatchNorm2d._update_running
    names = {}

    def counting(self, *a):
        if self.update_running:
            updates.append(names[id(self)])
        return update(self, *a)

    out = {}
    for name, model in (("plain", plain), ("remat", remat)):
        names = {id(m): n for n, m in model.named_modules()}
        updates.clear()
        BatchNorm2d._update_running = counting
        try:
            out[name] = _step(arch, model, kind, batch) + (list(updates),)
        finally:
            BatchNorm2d._update_running = update
    out["models"] = (plain, remat)
    return out


def test_remat_step_equals_plain_step_bit_for_bit(steps):
    """Loss, every parameter and every BN statistic after the step equal."""
    (lp, sp, _), (lr, sr, _) = steps["plain"], steps["remat"]
    assert lr == lp
    assert set(sr) == set(sp)
    for k in sp:
        assert torch.equal(sr[k], sp[k]), k
    plain, remat = steps["models"]
    assert any(b.remat for b in remat.modules() if isinstance(b, Bottleneck))
    assert not any(b.remat for b in plain.modules() if isinstance(b, Bottleneck))


def test_remat_moves_each_running_statistic_once(steps):
    """Each BN of the step moves its running statistics as often as in the
    plain step (once a forward call); the recompute moves none."""
    (_, _, up), (_, _, ur) = steps["plain"], steps["remat"]
    assert len(up) > 50
    assert ur == up


def test_remat_in_eval_and_without_gradients_is_the_plain_forward():
    """Outside training with gradients (eval, ``no_grad``: the U2PL
    teacher) a remat model runs its blocks as they are; its state_dict keys
    are the plain model's."""
    plain = _model("pspnet", False)
    remat = _model("pspnet", True, plain.state_dict())
    assert list(remat.state_dict()) == list(plain.state_dict())
    x = torch.from_numpy(np.random.default_rng(2).standard_normal((1, SIZE, SIZE, 3)))
    for train in (False, True):
        with torch.no_grad():
            a = plain.train(train).encode(x)[0]
            b = remat.train(train).encode(x)[0]
        assert torch.equal(a, b)
    for k, v in plain.state_dict().items():
        assert torch.equal(v, remat.state_dict()[k]), k


def _jax_model(remat):
    return JaxPSPNet(classes=CLASSES, layers=50, dropout=0.1, with_aux=True,
                     dtype=jnp.float64, remat=remat)


def test_remat_supervised_step_matches_jax_remat():
    """One supervised step of a remat PSPNet-50 against JAX's step of the
    PSPNet built with remat=True: the loss within rtol 1e-8, every tensor
    within 1e-7 of its largest magnitude."""
    key = jax.random.PRNGKey(3)
    with jax.enable_x64(True):
        jm = _jax_model(True)
        shapes = jax.eval_shape(lambda: jm.init({"params": key, "dropout": key},
                                                jnp.zeros((B, SIZE, SIZE, 3)), train=True))
        v = _numpy_init(shapes, np.random.default_rng(23))
        _perturb_bn(v["params"], v["batch_stats"], np.random.default_rng(22))
        v = jax.tree.map(lambda a: np.asarray(a, np.float64), v)
        batch = _batch(np.random.default_rng(21))
        masks = _call_keep_masks(jm, v, key)
        loss_fn = jax_sup.make_loss_fn("ohem", 0.4, 255, 0.7, MIN_KEPT)
        s1, m1 = jax.jit(jax_sup.make_train_step(jm, loss_fn, CLASSES, 255))(
            _jax_state(v, jax_make_optimizer(LR, MAX_ITER)),
            {k: jnp.asarray(a) for k, a in batch.items()}, key)
        want = _port_tensors({"params": s1.params, "batch_stats": s1.batch_stats})
        want_loss = float(m1["loss"])
    port = _model("pspnet", True, {k: torch.from_numpy(np.array(a))
                                   for k, a in _port_tensors(v).items()})
    opt, sched = make_optimizer(port, LR, MAX_ITER)
    step = make_train_step(port, make_loss_fn("ohem", 0.4, 255, 0.7, MIN_KEPT), CLASSES, 255)
    port.cls[3].keep, port.aux[3].keep = (torch.from_numpy(m.copy())[:, :, None, None]
                                          for m in masks)
    _, m = step(TrainState(0, port, opt, sched), _torch_batch(batch), None)
    assert float(m["loss"]) == pytest.approx(want_loss, rel=1e-8)
    got = {k: t.detach().numpy() for k, t in port.state_dict().items()}
    assert set(got) == set(want)
    for k, w in want.items():
        w = np.asarray(w, np.float64)
        np.testing.assert_allclose(got[k], w, rtol=0, atol=1e-7 * np.abs(w).max(), err_msg=k)
