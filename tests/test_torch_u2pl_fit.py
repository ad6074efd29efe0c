"""The U2PL wiring of ``Runner.fit`` and ``Runner.test`` in the port
(``run_contrastive_fit``, ``run_test(method="contrastive")``,
floodseg_tpu_torch/train/fit.py) against the JAX package's, on the CPU.

One synthetic tree from the JAX package's writer (30 frames of 128x160, 8
labeled: 6 train items, 4 in train_u.txt, 1 val). The role loaders
(``role_datasets``, ``train_loaders``) against ``Runner._train_loaders``
on a Runner made without its constructor: "l" and "u" only, their first
batches equal, the steps an epoch equal.

The fit: the narrow ViT with its rep head of tests/torch_u2pl_fixtures.py,
float64, two epochs of two steps with ``sup_only_epoch`` 1, so it crosses
the boundary: 2 sup steps, the sync, 2 semi steps (epoch_frac 0.5). The
JAX side is ``Runner.fit``'s contrastive loop wired by hand (the sync at
the boundary epoch, rel_step from host counters, epoch_frac in float32)
over the Runner's own transforms, datasets and loaders, with the jitted
steps of ``make_u2pl_steps`` and ``fold_in(PRNGKey(seed), step)`` keys;
validation after each epoch through the eval step on the student before
the boundary and on the teacher after (``_EvalState``, as the Runner's
``eval_fn``). Each step's dropout masks and draws are those of its key,
injected into the port's calls (validation runs in eval mode and draws
none). Held: each epoch's mean train loss within rtol 2e-6 (the float32
contrastive loss, tests/test_torch_u2pl_step.py), the validation counts
equal, validation served the student in epoch 0 and the teacher in epoch
1, the final student parameters within 1e-7 of their scale.

``run_test(state, method="contrastive")`` serves the teacher of a synced
state and the student of one that is not, with the results of
``run_test(that model, method="supervised")`` (the single-frame route,
held against ``Runner.test`` in tests/test_torch_evaluate.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from floodseg_tpu.cli.runner import Runner, _EvalState
from floodseg_tpu.data.synthetic import generate_synthetic_dataset as jax_generate
from floodseg_tpu.ops.metrics import MetricMeter as JaxMeter
from floodseg_tpu.train import contrastive as jcon

from floodseg_tpu_torch.train import (
    FitConfig,
    role_datasets,
    run_contrastive_fit,
    run_test,
    sem_transforms,
    train_loaders,
)

from torch_port_fixtures import jax_runner, masks_per_call
from torch_u2pl_fixtures import (
    CAPS,
    CCFG,
    CLASSES,
    COUNTS,
    LR,
    NAMES,
    SIZE,
    JaxDraws,
    jax_params,
    jax_state,
    oracle,
    port_params,
    port_state_of,
    step_masks,
    weights,
)

TREE = (128, 160)
EPOCHS, STEPS, SUP_ONLY = 2, 2, 1
FIT = FitConfig(train_h=SIZE, train_w=SIZE, resize_h=TREE[0], resize_w=TREE[1], frame_delta=5,
                workers=2, workers_test=2, max_epochs=EPOCHS, limit_train_batches=STEPS, lr=LR,
                seed=42, aux_weight=0.0, sup_only_epoch=SUP_ONLY, contrastive=CCFG, **CAPS)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return jax_generate(str(tmp_path_factory.mktemp("u2pl_tree")), num_frames=30, size=TREE,
                        frame_delta=5, num_labeled=8)


def _first(loader):
    it = iter(loader)
    try:
        return {k: np.asarray(v) for k, v in next(it).items()}
    finally:
        it.close()


def test_role_loaders_match_runner(tree):
    cfg = FitConfig(**{**FIT.__dict__, "limit_train_batches": None})
    r = jax_runner(tree, "contrastive", cfg)
    ref, ref_steps = Runner._train_loaders(r, Runner._transforms(r))
    roles = role_datasets(cfg, tree, "contrastive", sem_transforms(cfg, "vit")["train"])
    loaders, steps = train_loaders(cfg, roles, "cpu")
    assert sorted(loaders) == sorted(ref) == ["l", "u"] and steps == ref_steps == 3
    for k in ("l", "u"):
        ours, want = _first(loaders[k]), _first(ref[k])
        assert sorted(ours) == sorted(want), k
        for key, v in want.items():
            np.testing.assert_array_equal(ours[key], v, err_msg=f"{k} {key}")


@pytest.fixture(scope="module")
def fits(tree):
    sv, tv = weights(50), weights(51)
    o = oracle(EPOCHS * STEPS)
    r = jax_runner(tree, "contrastive", FIT)
    tf = Runner._transforms(r)
    loaders, steps = Runner._train_loaders(r, tf)
    steps = min(steps, STEPS)
    val_ds = r._dataset("val", "val.txt", "l", tf["val"])
    n_val = len(val_ds)
    keys = [jax.random.fold_in(jax.random.PRNGKey(FIT.seed), i) for i in range(EPOCHS * steps)]
    iters = {k: iter(ld) for k, ld in loaders.items()}
    losses, meters = [], []
    s_calls, t_calls = [], []
    with jax.enable_x64(True):
        s = jax_state(o, sv, tv)
        try:
            for e in range(EPOCHS):
                epoch = []
                for i in range(steps):
                    key = keys[e * steps + i]
                    batch = {k: next(it) for k, it in iters.items()}
                    semi = e >= SUP_ONLY
                    sm, tm = step_masks(o, sv["params"], tv["params"], key, semi)
                    s_calls += sm
                    t_calls += tm
                    if not semi:
                        s, m = o.sup(s, batch, key)
                    else:
                        if e == SUP_ONLY and i == 0:
                            s = jcon.sync_teacher(s)
                        s, m = o.semi(s, batch, key, jnp.float32(e / EPOCHS),
                                      jnp.int32((e - SUP_ONLY) * steps + i))
                    epoch.append(float(m["loss"]))
                losses.append(float(np.mean(epoch)))
                variables = (_EvalState(s.teacher_params, s.teacher_batch_stats)
                             if e >= SUP_ONLY else
                             _EvalState(s.student.params, s.student.batch_stats))
                (t_calls if e >= SUP_ONLY else s_calls).extend([{}] * n_val)
                meter = JaxMeter(CLASSES)
                for vb in r._loader(val_ds, FIT.batch_size_val):
                    out = o.ev(variables, {k: jnp.asarray(a) for k, a in vb.items()})
                    meter.update(out["intersection"], out["union"], out["target"])
                meters.append(meter)
        finally:
            for it in iters.values():
                it.close()
        ref_params = jax_params(jax.device_get(s.student.params))

        state = port_state_of(sv, tv, EPOCHS * steps)
        student, teacher = state.student.model, state.teacher
        with masks_per_call(student, {"forward": s_calls}, NAMES), \
                masks_per_call(teacher, {"forward": t_calls}, NAMES):
            ours = run_contrastive_fit(
                student, tree, FIT, teacher=teacher, device="cpu",
                draws=lambda step: JaxDraws.of_step(keys[step]))
    return (losses, meters, ref_params, steps), ours


def test_run_contrastive_fit_losses_match_jax(fits):
    (losses, _, ref_params, steps), ours = fits
    assert ours["steps"] == EPOCHS * steps == 4 and len(ours["epochs"]) == EPOCHS
    for e in range(EPOCHS):
        assert ours["epochs"][e]["train_loss"] == pytest.approx(losses[e], rel=2e-6), e
    state = ours["state"]
    assert state.teacher_synced and state.student.step == 4
    got = port_params(state.student.model)
    for k, w in ref_params.items():
        np.testing.assert_allclose(got[k], w, rtol=0, atol=1e-7 * np.abs(w).max(), err_msg=k)


def test_run_contrastive_fit_validation_matches_jax(fits):
    (_, meters, _, _), ours = fits
    assert ours["served"] == [(0, "student"), (1, "teacher")]
    for e in range(EPOCHS):
        counts = ours["epochs"][e]["val_counts"]
        for k in COUNTS:
            np.testing.assert_array_equal(counts[k], getattr(meters[e], k), err_msg=f"{e} {k}")


def test_run_test_serves_the_model_the_runner_picks(fits, tree):
    _, ours = fits
    state = ours["state"]
    cfg = FitConfig(**{**FIT.__dict__, "limit_test_batches": 1, "test_base_size": 96})
    got = run_test(state, tree, cfg, "contrastive", device="cpu")
    want = run_test(state.teacher, tree, cfg, "supervised", device="cpu")
    assert sorted(got) == sorted(want) and "test_miou_epoch" in got
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    state.teacher_synced = False
    try:
        before = run_test(state, tree, cfg, "contrastive", device="cpu")
        want = run_test(state.student.model, tree, cfg, "supervised", device="cpu")
    finally:
        state.teacher_synced = True
    for k, v in want.items():
        np.testing.assert_array_equal(before[k], v, err_msg=k)
