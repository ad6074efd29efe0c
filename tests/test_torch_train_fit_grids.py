"""DeepLabV3's first fit step on the loader's unrounded float32 grids,
against the JAX package, with a tolerance taken from the port's own
sensitivity to its grids.

tests/test_torch_train_fit.py runs the fit on grids rounded to multiples
of 2**-10 on both sides, where float32 tap arithmetic is exact however it
is evaluated. This file takes the grids as the loader gives them. One
synthetic tree from the JAX package's writer (the fit test's: 30 frames of
96x128, 8 labeled), DeepLabV3-50 with its aux head in float64 (JAX under
``jax.enable_x64``), dropout off on both sides, and the first batch of
``Runner.fit``'s flow_supervised loader (33 px crops) through the
interpolated step, from the same state under the fit's SGD.

The spread: the port's step on the batch, and again on the same batch with
every grid coordinate g moved up by one float32 ulp of g + 1, the first
value the tap arithmetic forms; for the loss, each parameter and each BN
statistic the largest difference between the two results relative to its
largest magnitude, and the spread the largest of these. (A move of g by
its own ulp, ``np.nextafter(g)``, is absorbed in g + 1 wherever
0 <= g < 1, and every coordinate of this batch is there: that spread is 0,
which ``test_a_grid_ulp_is_absorbed_in_g_plus_1`` pins.) The gap: the
same measure between the port's step and the JAX step on the unmoved
batch.

The gap must sit within ``MULTIPLE`` times the spread. The multiple was
fixed at 8 before the gap was measured. Why: XLA evaluates the jitted
JAX chain's float32 tap coordinates (``((g + 1) * w - 1) * 0.5``) in its
own fused form. That changes a coordinate by at most one rounding, that
is one ulp of a value below the map's width. The one-ulp move of g + 1
changes each coordinate by (w/2)·ulp(g + 1), which is within a factor of
2 of that. So both are perturbations of the same size, but at other
points and with other signs, and BN's backward at 5x5 maps amplifies them unevenly from point
to point. A factor of 8 leaves room for that unevenness. A fault in the
port's tap arithmetic (a wrong formula, weights in another precision)
would move weights by far more than one rounding and land orders of
magnitude above the spread.

Measured on the CPU: spread 8.096e-5, gap 5.642e-5 (0.70 of the spread),
both at ``classifier.0.convs.2.0.weight`` (the ASPP's second dilated
branch). So the 5.6e-5 between the two packages is the size of one
rounding in the tap coordinates, not a fault of the port.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from floodseg_tpu.data.synthetic import generate_synthetic_dataset as jax_generate
from floodseg_tpu.models.deeplabv3 import DeepLabV3 as JaxDeepLabV3
from floodseg_tpu.train import flow as jflow
from floodseg_tpu.train.supervised import make_loss_fn as jax_make_loss_fn

from floodseg_tpu_torch.models import build_model
from floodseg_tpu_torch.models.layers import Dropout
from floodseg_tpu_torch.train import (
    default_fit_config,
    TrainState,
    make_flow_train_step,
    make_loss_fn,
    make_optimizer,
)
from floodseg_tpu_torch.train.fit import step_generator

from torch_port_fixtures import _perturb_bn, _to_dict, jax_fit_data, jax_fit_state, port_state

CROP = 33
FIT = default_fit_config(train_h=CROP, train_w=CROP, resize_h=96, resize_w=128, frame_delta=5,
                         workers=2, max_epochs=1, limit_train_batches=2, lr=1e-3, seed=42)
MULTIPLE = 8.0


def _jax_model():
    return JaxDeepLabV3(classes=5, layers=50, with_aux=True, dropout_scale=0.0,
                        dtype=jnp.float64)


def _tensors(state):
    """Parameters and BN statistics by the port's names, as float64 numpy."""
    return {k: np.asarray(v, np.float64) for k, v in port_state(
        {"params": state.params, "batch_stats": state.batch_stats}).items()
        if not k.endswith("num_batches_tracked")}


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The tree, JAX's float64 variables (every BN perturbed), the fit's
    first train batch and its steps an epoch."""
    tree = jax_generate(str(tmp_path_factory.mktemp("fit_grids_tree")), num_frames=30,
                        size=(96, 128), frame_delta=5, num_labeled=8)
    key = jax.random.PRNGKey(0)
    with jax.enable_x64(True):
        v = _to_dict(jax.device_get(jax.jit(lambda: _jax_model().init(
            {"params": key, "dropout": key}, jnp.zeros((2, CROP, CROP, 3)), train=True))()))
    _perturb_bn(v["params"], v["batch_stats"], np.random.default_rng(33))
    loader, _, steps = jax_fit_data(tree, FIT, "flow_supervised", CROP)
    batch = {k: np.asarray(a) for k, a in next(iter(loader)).items()}
    return jax.tree.map(lambda a: np.asarray(a, np.float64), v), batch, steps


def _port_model():
    port = build_model("deeplabv3", layers=50, with_aux=True, dtype=torch.float64).double()
    for m in port.modules():
        if isinstance(m, Dropout):
            m.rate = 0.0
    return port


def _port_step(port, v, batch, steps):
    """The port's interpolated step from ``v`` (loaded into ``port`` anew)."""
    port.load_state_dict(port_state(v))
    opt, sched = make_optimizer(port, FIT.lr, steps * FIT.max_epochs, "sgd", FIT.momentum,
                                FIT.weight_decay, FIT.power)
    interp, _ = make_flow_train_step(
        port, make_loss_fn(FIT.loss, 0.0, 255, FIT.ohem_thresh, FIT.ohem_min_kept),
        FIT.classes, 255)
    tb = {k: (a if k in ("left_index", "right_index") else torch.from_numpy(a))
          for k, a in batch.items()}
    _, m = interp(TrainState(0, port, opt, sched), tb, step_generator(FIT.seed, 0))
    return {"loss": np.float64(m["loss"]),
            **{k: t.detach().numpy().copy() for k, t in port.state_dict().items()
               if not k.endswith("num_batches_tracked")}}


def _ulp_of_g_plus_1(g):
    """g moved up by one float32 ulp of g + 1 (exact for g + 1 in [1, 2))."""
    one = np.float32(1)
    return np.nextafter(g + one, np.float32(np.inf)) - one


def _moved(batch):
    return {k: (_ulp_of_g_plus_1(a) if k in ("mvs_left", "mvs_right") else a)
            for k, a in batch.items()}


def _largest_rel(a, b):
    """(the largest per-tensor max |a - b| / max |b|, its tensor)."""
    rel = {k: float(np.abs(a[k] - b[k]).max() / max(np.abs(b[k]).max(), 1e-300)) for k in b}
    name = max(rel, key=rel.get)
    return rel[name], name


@pytest.fixture(scope="module")
def steps(setup):
    """The JAX step and the port's step on the batch, and the port's on the
    moved batch."""
    v, batch, n = setup
    with jax.enable_x64(True):
        interp, _ = jflow.make_flow_train_step(
            _jax_model(), jax_make_loss_fn(FIT.loss, 0.0, 255, FIT.ohem_thresh,
                                           FIT.ohem_min_kept), FIT.classes, 255)
        s1, m = jax.jit(interp)(jax_fit_state(v, FIT, n),
                                {k: jnp.asarray(a) for k, a in batch.items()},
                                jax.random.fold_in(jax.random.PRNGKey(FIT.seed), 0))
        ref = {"loss": np.float64(m["loss"]), **_tensors(jax.device_get(s1))}
    port = _port_model()
    return ref, _port_step(port, v, batch, n), _port_step(port, v, _moved(batch), n)


def test_grids_are_unrounded(setup):
    """The batch's grids are the loader's float32 values, not multiples of
    2**-10 (the rounded fit test's)."""
    _, batch, _ = setup
    for k in ("mvs_left", "mvs_right"):
        g = batch[k]
        assert g.dtype == np.float32
        assert np.mean(np.round(g * 1024) / 1024 != g) > 0.9, k


def test_a_grid_ulp_is_absorbed_in_g_plus_1(setup):
    """np.nextafter(g) leaves g + 1, and so every tap, as it was; the move
    the spread takes changes g + 1 at every coordinate, by one ulp."""
    _, batch, _ = setup
    one, up = np.float32(1), np.float32(np.inf)
    for k in ("mvs_left", "mvs_right"):
        g = batch[k]
        assert ((g >= 0) & (g < 1)).all(), k
        np.testing.assert_array_equal(np.nextafter(g, up) + one, g + one, err_msg=k)
        np.testing.assert_array_equal(_ulp_of_g_plus_1(g) + one, np.nextafter(g + one, up),
                                      err_msg=k)


def test_fit_step_on_unrounded_grids_within_the_ports_ulp_spread(steps):
    ref, ours, moved = steps
    assert set(ours) == set(ref) == set(moved)
    spread, spread_at = _largest_rel(moved, ours)
    gap, gap_at = _largest_rel(ours, ref)
    assert spread > 0, "the move of the grids changed nothing"
    assert gap <= MULTIPLE * spread, (
        f"port vs JAX {gap:.3e} ({gap_at}) beyond {MULTIPLE} x the port's one-ulp "
        f"spread {spread:.3e} ({spread_at})")
