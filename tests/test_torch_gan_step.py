"""The s4GAN ``flow_gan`` train step (floodseg_tpu_torch/train/gan.py) and
``run_gan_fit`` against the JAX package on the CPU: two ``flow_gan`` steps
from one initial state against ``make_gan_train_step``, then the flow eval
step; and ``run_gan_fit(method="flow_gan")`` against a JAX wiring of
``Runner.fit``. The JAX step is jitted under ``jax.enable_x64`` once
(tests/torch_gan_fixtures.py::_oracle) and serves both: the fit's batches
take the shapes and dtypes of the step test's. (The ``gan`` step is held in
tests/test_torch_gan_step_frame.py.)

The generator is the narrow Segmenter ViT of tests/test_torch_train_vit.py
(d = 128, 2 heads, 2 + 2 layers, patch 32) on 64 px frames with 4x4 block
grids, so the flow forward runs K1's and K1-bwd's plain versions; the
discriminator is at ndf 64. Both float64, on float32 frames (as the
loaders give them). Every dropout takes flax's mask for its call: the
step key splits into r_l, r_u, r_d1..r_d4; the flow generator forward
splits r_l (and r_u) into encode(prev), encode(next) and decode keys; D
draws with r_d1 (the fake in the G loss), r_d2 (the real in the G loss),
r_d3 and r_d4 (fake and real in the D loss). The masks are recorded by
flax module path and injected call by call by the port's module name.
``threshold_st`` and the tolerances: tests/torch_gan_fixtures.py.

The fit: one synthetic tree from the JAX package's writer (30 frames of
128x160, 8 labeled, train_u.txt), the JAX side through the Runner's own
transforms, role datasets and loaders (``Runner._train_loaders`` on a
Runner made without its constructor) and ``_build_states_and_steps``'
optimizers and step, with ``fold_in(PRNGKey(seed), step)`` keys; one epoch
of two steps and a validation pass. Each step's masks are those of its
``fold_in`` key, injected into ``run_gan_fit``'s calls (validation runs in
eval mode and draws none). The epoch's mean loss within rtol 1e-5 and the
validation counts equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from floodseg_tpu.cli.runner import Runner
from floodseg_tpu.data.synthetic import generate_synthetic_dataset as jax_generate
from floodseg_tpu.ops.metrics import MetricMeter as JaxMeter

from floodseg_tpu_torch.train import run_gan_fit

from torch_gan_fixtures import (  # noqa: F401 (the tests run on this file's trajectory)
    CLASSES,
    COUNTS,
    D_NAMES,
    FIT,
    G_NAMES,
    LR,
    LR_D,
    MAX_ITER,
    T,
    THRESHOLD,
    TREE,
    _init,
    _jax_states,
    _masks,
    _oracle,
    _port_models,
    test_gan_eval_counts_match_jax,
    test_gan_step_losses_match_jax,
    test_gan_step_updates_match_jax,
    trajectory_of,
)
from torch_port_fixtures import jax_runner, masks_per_call
from torch_port_fixtures import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.fixture(scope="module")
def trajectory():
    return trajectory_of("flow_gan")


# ------------------------------------------------------------------ the fit

@pytest.fixture(scope="module")
def fits(tmp_path_factory):
    """run_gan_fit and the JAX wiring of Runner.fit's flow_gan branch on
    one tree, the same weights and, step by step, the same masks."""
    tree = jax_generate(str(tmp_path_factory.mktemp("gan_fit_tree")), num_frames=30,
                        size=TREE, frame_delta=T + 1, num_labeled=8)
    v, d = _init(28)
    o = _oracle("flow_gan")
    r = jax_runner(tree, "flow_gan", FIT)
    m = r.cfg.model
    assert (m.optim.optim, m.optim.lr, m.optim.lr_D, m.optim.momentum, m.optim.weight_decay,
            m.power, m.threshold_st, m.lambda_fm, m.lambda_st) == (
        "SGD", LR, LR_D, 0.9, 1e-4, 0.9, THRESHOLD["flow_gan"], 0.1, 1.0)
    tf = Runner._transforms(r)
    loaders, steps = Runner._train_loaders(r, tf)
    assert r._max_iter(steps) == MAX_ITER
    val_ds = r._dataset("val", "val.txt", "l", tf["val"])
    keys = [jax.random.fold_in(jax.random.PRNGKey(FIT.seed), i) for i in range(steps)]
    iters = {k: iter(ld) for k, ld in loaders.items()}
    with jax.enable_x64(True):
        sg, sd = _jax_states(o, v, d)
        masks = [_masks("flow_gan", o.recorders, v, d, k) for k in keys]
        losses = []
        try:
            for key in keys:
                sg, sd, metrics = o.step(sg, sd, {k: next(it) for k, it in iters.items()}, key)
                losses.append(float(metrics["loss"]))
        finally:
            for it in iters.values():
                it.close()
        meter = JaxMeter(CLASSES)
        for vb in r._loader(val_ds, FIT.batch_size_val):
            out = o.ev(sg, {k: jnp.asarray(a) for k, a in vb.items()})
            meter.update(out["intersection"], out["union"], out["target"])

    port_g, port_d = _port_models(v, d)
    evals = len(val_ds)  # validation: encode twice and decode once a frame, no draws
    g_calls = {"encode": [x for g, _ in masks for x in g["encode"]] + [{}] * (2 * evals),
               "decode": [x for g, _ in masks for x in g["decode"]] + [{}] * evals}
    d_calls = {"forward": [x for _, dm in masks for x in dm["forward"]]}
    with masks_per_call(port_g, g_calls, G_NAMES), \
            masks_per_call(port_d, d_calls, D_NAMES, nchw=tuple(D_NAMES)):
        ours = run_gan_fit(port_g, tree, FIT, "flow_gan", discriminator=port_d, device="cpu")
    return (float(np.mean(losses)), meter, steps), ours


def test_run_gan_fit_loss_matches_jax(fits):
    (ref_loss, _, steps), ours = fits
    assert ours["steps"] == steps == 2 and len(ours["epochs"]) == 1
    assert ours["epochs"][0]["train_loss"] == pytest.approx(ref_loss, rel=1e-5)
    state_g, state_d = ours["state"]
    assert state_g.step == state_d.step == 2


def test_run_gan_fit_validation_matches_jax(fits):
    (_, ref_meter, _), ours = fits
    counts = ours["epochs"][0]["val_counts"]
    for k in COUNTS:
        np.testing.assert_array_equal(counts[k], getattr(ref_meter, k), err_msg=k)
