"""Shared set-up of the s4GAN step tests (tests/test_torch_gan_step.py,
``flow_gan`` and ``run_gan_fit``; tests/test_torch_gan_step_frame.py,
``gan``): the narrow Segmenter ViT generator and the discriminator, their
float64 weights drawn in numpy in the inits' shapes, each role's batches,
the JAX oracle of a method (``_oracle``: the jitted ``make_gan_train_step``,
made once a process so that the flow test and the fit share one compile),
flax's dropout masks recorded call by call, the two-step trajectory of
both packages (``trajectory_of``) and the tests run on it, which each file
imports and runs on its own ``trajectory`` fixture.

``threshold_st`` sits halfway between the two samples' confidences
sigmoid(D(pred_cat)) at step 1, read from a first JAX run of these inputs
(``THRESHOLD``, the confidences beside it), so that one sample of two
passes at step 1 and the self-training branch runs; the JAX run's own
``st_count`` of 1 pins that. Step 0's gate is closed by ``step > 0``.
Tolerances as tests/test_torch_train_flow.py's: losses and metrics within
rtol 1e-8, ``st_count`` equal, every G and D parameter within 1e-7 of its
tensor's largest magnitude, counts equal.
"""

import functools
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from floodseg_tpu.models.discriminator import S4GANDiscriminator as JaxDiscriminator
from floodseg_tpu.models.vit import SegmenterViT as JaxSegmenterViT
from floodseg_tpu.train import flow as jflow
from floodseg_tpu.train import gan as jgan
from floodseg_tpu.train import supervised as jsup
from floodseg_tpu.train.optim import exclude_subtrees
from floodseg_tpu.train.optim import make_optimizer as jax_make_optimizer
from floodseg_tpu.train.state import TrainState as JaxTrainState

from floodseg_tpu_torch.models import S4GANDiscriminator, SegmenterViT
from floodseg_tpu_torch.train import (
    AUX_KEYS,
    FitConfig,
    TrainState,
    flow_g_forward,
    make_eval_step,
    make_flow_eval_step,
    make_gan_train_step,
    make_optimizer,
    single_frame_g_forward,
)

from torch_port_fixtures import (
    flax_keep_masks_fn,
    masks_per_call,
    numpy_leaves,
    port_state,
    vit_mask_names,
)

SIZE, B, T, CLASSES = 64, 2, 4, 5
TREE = (128, 160)
# the fit's one epoch of two steps sets the poly schedules' max_iter to 2
LR, LR_D, MAX_ITER = 1e-3, 1e-4, 2
CONFIG = dict(image_size=SIZE, patch_size=32, d_model=128, n_layers=2, dec_layers=2,
              n_heads=2)
G_NAMES = vit_mask_names(CONFIG["n_layers"], CONFIG["dec_layers"])
D_NAMES = {f"Dropout_{i}": f"layers.{3 * i + 2}" for i in range(3)}
# halfway between the two samples' sigmoid(D(pred_cat)) at step 1 of a first
# JAX run of these inputs: flow_gan 0.47229054 and 0.50975456, gan
# 0.49301163 and 0.49418036
THRESHOLD = {"flow_gan": 0.49102255, "gan": 0.49359600}
METRICS = ("loss", "loss_s", "loss_ce", "loss_fm", "loss_st", "loss_d")
COUNTS = ("intersection", "union", "target")
FIT = FitConfig(train_h=SIZE, train_w=SIZE, resize_h=TREE[0], resize_w=TREE[1],
                frame_delta=T + 1, workers=2, max_epochs=1, limit_train_batches=2, lr=LR,
                lr_D=LR_D, threshold_st=THRESHOLD["flow_gan"], seed=42)
VAL_KEYS = ("frame_prev", "frame_next", "mvs_left", "mvs_right", "label", "left_index",
            "right_index")


def _frames(rng):
    return rng.standard_normal((B, SIZE, SIZE, 3)).astype(np.float32)


def _labels(rng):
    labels = rng.integers(0, CLASSES, (B, SIZE, SIZE))
    return np.where(rng.random(labels.shape) < 0.05, 255, labels).astype(np.int32)


def _flow_roles(rng):
    """One step's {"l", "u", "gt"} with the keys, shapes and dtypes the
    Runner's FlowDataset loaders give each role (u without labels; gt the
    current frame and labels)."""
    gh = SIZE // 16
    base = np.stack(np.meshgrid(np.linspace(-0.75, 0.75, gh), np.linspace(-0.75, 0.75, gh)), -1)

    def grids():
        g = base[None, None] + rng.uniform(-0.2, 0.2, (T, B, gh, gh, 2))
        return (np.round(g * 1024) / 1024).astype(np.float32)

    def sample():
        return {"frame_current": _frames(rng), "frame_prev": _frames(rng),
                "frame_next": _frames(rng), "mvs_left": grids(), "mvs_right": grids(),
                "left_index": np.array((1, 3), np.int32),
                "right_index": np.array((4, 2), np.int32)}

    gt = {"frame_current": _frames(rng), "label": _labels(rng),
          "left_index": np.array((2, 1), np.int32), "right_index": np.array((3, 4), np.int32)}
    return {"l": {**sample(), "label": _labels(rng)}, "u": sample(), "gt": gt}


def _batches(method, rng):
    """Each step's roles: flow samples, or single frames (u's labels zeros,
    as SemDataset's "test" split)."""
    if method == "flow_gan":
        return [_flow_roles(rng) for _ in range(2)]
    return [{"l": {"frame_current": _frames(rng), "label": _labels(rng)},
             "u": {"frame_current": _frames(rng), "label": np.zeros((B, SIZE, SIZE), np.int32)},
             "gt": {"frame_current": _frames(rng), "label": _labels(rng)}}
            for _ in range(2)]


def _jax_model():
    return JaxSegmenterViT(classes=CLASSES, dropout=0.1, dtype=jnp.float64, **CONFIG)


@functools.lru_cache(maxsize=None)
def _init(seed=25):
    """Float64 generator and discriminator variables in their inits' shapes
    (``numpy_leaves``)."""
    k = jax.random.PRNGKey(0)
    with jax.enable_x64(True):
        g = jax.eval_shape(lambda: _jax_model().init(
            {"params": k, "dropout": k}, jnp.zeros((B, SIZE, SIZE, 3)), train=False))
        d = jax.eval_shape(lambda: JaxDiscriminator(num_classes=CLASSES).init(
            {"params": k}, jnp.zeros((1, SIZE, SIZE, CLASSES + 3)), train=False))
    rng = np.random.default_rng(seed)
    return ({"params": numpy_leaves(g["params"], rng)},
            {"params": numpy_leaves(d["params"], rng)})


@functools.lru_cache(maxsize=None)
def _d_mask_recorder():
    return flax_keep_masks_fn(JaxDiscriminator(num_classes=CLASSES, dtype=jnp.float64),
                              np.zeros((B, SIZE, SIZE, CLASSES + 3)))


def _mask_recorders(method, jm):
    """flax_keep_masks_fn of each call the step makes: G's by method
    ("encode" and "decode", or the whole model) and D's."""
    frames = np.zeros((B, SIZE, SIZE, 3))
    if method == "flow_gan":
        feat = np.zeros((B, SIZE // 32, SIZE // 32, CONFIG["d_model"]))
        g = {"encode": flax_keep_masks_fn(jm, frames, "encode"),
             "decode": flax_keep_masks_fn(jm, feat, "decode")}
    else:
        g = {"forward": flax_keep_masks_fn(jm, frames)}
    return g, _d_mask_recorder()


def _masks(method, recorders, v, d, key):
    """The flax masks of one step's calls, in call order: G's ("encode" and
    "decode" calls of both forwards, or two whole-model calls) and D's four
    calls."""
    (g_rec, d_rec), vs = recorders, {"params": v["params"]}
    r_l, r_u, *r_d = jax.random.split(key, 6)
    if method == "flow_gan":
        keys = [jax.random.split(r, 3) for r in (r_l, r_u)]
        g = {"encode": [g_rec["encode"](vs, k) for r1, r2, _ in keys for k in (r1, r2)],
             "decode": [g_rec["decode"](vs, r3) for _, _, r3 in keys]}
    else:
        g = {"forward": [g_rec["forward"](vs, r) for r in (r_l, r_u)]}
    return g, {"forward": [d_rec(d, r) for r in r_d]}


def _port_state(tree):
    return {k: t.numpy() for k, t in port_state({"params": tree}).items()}


@functools.lru_cache(maxsize=None)
def _oracle(method):
    """The JAX side of ``method``, made once for the module: the flax
    generator (dropout 0.1) and discriminator (0.5), the optimizers as
    ``_build_states_and_steps`` makes them (one object each: a state's
    ``tx`` is part of jit's cache key), the jitted s4GAN step and
    generator eval step, and the mask recorders."""
    jm, jd = _jax_model(), JaxDiscriminator(num_classes=CLASSES, dtype=jnp.float64)
    tx_g = exclude_subtrees(jax_make_optimizer(LR, MAX_ITER), ("aux", "aux_classifier"))
    tx_d = jax_make_optimizer(LR_D, MAX_ITER, "adam", betas=(0.9, 0.99), weight_decay=0.0,
                              head_lr_scale=1.0)
    flow = method == "flow_gan"
    g_fwd = jgan.flow_g_forward(jm) if flow else jgan.single_frame_g_forward(jm)
    step = jax.jit(jgan.make_gan_train_step(g_fwd, jd, CLASSES, 255, THRESHOLD[method], 0.1,
                                            1.0, gt_norm_by_labeled_max=not flow))
    ev = jax.jit(jflow.make_flow_eval_step(jm, CLASSES, 255) if flow
                 else jsup.make_eval_step(jm, CLASSES, 255))
    return SimpleNamespace(tx_g=tx_g, tx_d=tx_d, step=step, ev=ev,
                           recorders=_mask_recorders(method, jm))


def _jax_states(o, v, d):
    pg, pd = (jax.tree.map(jnp.asarray, t["params"]) for t in (v, d))
    return (JaxTrainState(step=jnp.zeros((), jnp.int32), params=pg, batch_stats={},
                          opt_state=o.tx_g.init(pg), tx=o.tx_g),
            JaxTrainState(step=jnp.zeros((), jnp.int32), params=pd, batch_stats={},
                          opt_state=o.tx_d.init(pd), tx=o.tx_d))


def _port_models(v, d):
    port_g = SegmenterViT(classes=CLASSES, dropout=0.1, dtype=torch.float64, **CONFIG).double()
    port_g.load_state_dict(port_state(v))
    port_d = S4GANDiscriminator(num_classes=CLASSES, dtype=torch.float64).double()
    port_d.load_state_dict(port_state(d))
    return port_g, port_d


def _torch(batch):
    return {k: (a if k.endswith("_index") else torch.from_numpy(a)) for k, a in batch.items()}


def _eval_batch(method, batch):
    """The eval step's batch: for the flow method one sample with the val
    loader's keys (as the fit's validation gives it), else the labeled
    batch."""
    if method != "flow_gan":
        return batch
    return {k: (batch[k][:, :1] if k.startswith("mvs") else batch[k][:1]) for k in VAL_KEYS}


def trajectory_of(method):
    """Two steps of ``method`` on the JAX side and in the port from one
    state, every dropout mask injected, then the generator's eval step:
    (JAX's metrics and G and D parameters after each step, the port's,
    JAX's eval counts, the port's, the port's (state_g, state_d))."""
    v, d = _init()
    batches = _batches(method, np.random.default_rng(26 if method == "flow_gan" else 27))
    keys = [jax.random.PRNGKey(7), jax.random.PRNGKey(8)]
    o = _oracle(method)
    eval_batch = _eval_batch(method, batches[0]["l"])
    with jax.enable_x64(True):
        sg, sd = _jax_states(o, v, d)
        masks = [_masks(method, o.recorders, v, d, k) for k in keys]
        ref = []
        for batch, key in zip(batches, keys):
            jb = {r: {k: jnp.asarray(a) for k, a in b.items()} for r, b in batch.items()}
            sg, sd, m = o.step(sg, sd, jb, key)
            ref.append(({k: np.asarray(a) for k, a in m.items()},
                        _port_state(jax.device_get(sg.params)),
                        _port_state(jax.device_get(sd.params))))
        ref_eval = {k: np.asarray(a) for k, a in o.ev(
            sg, {k: jnp.asarray(a) for k, a in eval_batch.items()}).items()}

    port_g, port_d = _port_models(v, d)
    opt_g, sched_g = make_optimizer(port_g, LR, MAX_ITER, exclude=AUX_KEYS)
    opt_d, sched_d = make_optimizer(port_d, LR_D, MAX_ITER, "adam", weight_decay=0.0,
                                    head_lr_scale=1.0, betas=(0.9, 0.99))
    state_g, state_d = TrainState(0, port_g, opt_g, sched_g), TrainState(0, port_d, opt_d, sched_d)
    g_fwd = flow_g_forward(port_g) if method == "flow_gan" else single_frame_g_forward(port_g)
    pstep = make_gan_train_step(g_fwd, CLASSES, 255, THRESHOLD[method], 0.1, 1.0,
                                gt_norm_by_labeled_max=method == "gan")
    ours = []
    for batch, (g_masks, d_masks) in zip(batches, masks):
        with masks_per_call(port_g, g_masks, G_NAMES), \
                masks_per_call(port_d, d_masks, D_NAMES, nchw=tuple(D_NAMES)):
            state_g, state_d, m = pstep(state_g, state_d,
                                        {r: _torch(b) for r, b in batch.items()}, None)
        ours.append(({k: a.numpy() for k, a in m.items()},
                     {k: t.detach().numpy().copy() for k, t in port_g.state_dict().items()},
                     {k: t.detach().numpy().copy() for k, t in port_d.state_dict().items()}))
    pev = (make_flow_eval_step(port_g, CLASSES, 255) if method == "flow_gan"
           else make_eval_step(port_g, CLASSES, 255))
    ours_eval = {k: a.numpy() for k, a in pev(state_g, _torch(eval_batch)).items()}
    return ref, ours, ref_eval, ours_eval, (state_g, state_d)


@pytest.mark.parametrize("step", [0, 1])
def test_gan_step_losses_match_jax(trajectory, step):
    """Every loss within rtol 1e-8, st_count equal (1 of 2 at step 1, the
    gate open; 0 in the gated loss_st at step 0) and the labeled batch's
    counts equal."""
    ref, ours, *_ = trajectory
    (rm, _, _), (om, _, _) = ref[step], ours[step]
    assert set(om) == set(rm)
    for k in METRICS:
        assert float(om[k]) == pytest.approx(float(rm[k]), rel=1e-8, abs=0.0), k
    assert int(om["st_count"]) == int(rm["st_count"])
    if step == 1:
        assert int(rm["st_count"]) == 1 and float(rm["loss_st"]) > 0.0
    else:
        assert float(rm["loss_st"]) == 0.0
    for k in COUNTS:
        np.testing.assert_array_equal(om[k], rm[k], err_msg=k)


@pytest.mark.parametrize("net", ["generator", "discriminator"])
@pytest.mark.parametrize("step", [0, 1])
def test_gan_step_updates_match_jax(trajectory, step, net):
    """Each parameter after the step within 1e-7 of its tensor's largest
    magnitude, and moved by the step."""
    ref, ours, *_ = trajectory
    i = 1 if net == "generator" else 2
    want, got = ref[step][i], ours[step][i]
    assert set(got) == set(want)
    before = ours[step - 1][i] if step else None
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=0, atol=1e-7 * np.abs(w).max(), err_msg=k)
        if before is not None:
            assert not np.array_equal(got[k], before[k]), k


def test_gan_eval_counts_match_jax(trajectory):
    """The generator's eval step after the two steps (the flow one for
    flow_gan, the single-frame one for gan): counts equal; the port's
    states are the step counts of two steps."""
    _, _, ref_eval, ours_eval, (state_g, state_d) = trajectory
    for k in COUNTS:
        np.testing.assert_array_equal(ours_eval[k], ref_eval[k], err_msg=k)
    assert state_g.step == state_d.step == 2
