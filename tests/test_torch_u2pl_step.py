"""The U2PL train steps (floodseg_tpu_torch/train/contrastive.py) against
the JAX package's ``make_u2pl_steps``, jitted under ``jax.enable_x64``, on
the CPU: one trajectory from one initial state of the narrow Segmenter ViT
with its rep head (tests/torch_u2pl_fixtures.py), float64, batch 2 + 2 at
64 px: two ``sup_step``s, the boundary ``sync_teacher``, two
``semi_step``s (the first key's coin takes the cutmix, the second's does
not; epoch_frac 0.5 in float32, rel_step 0 and 1) and a ``true_ema`` semi
step (rel_step 2; the port's teacher synced with ``alias=False`` first,
which copies the values the aliased teacher already has, as JAX's teacher
then holds the student's parameters too).

Every dropout takes flax's mask for its call (the student's r_s, the
teacher's r_t; the eval-mode teacher forward draws none) and every other
draw is JAX's (``JaxDraws``). The bank's caps (24, class 0 32) with 16
keys a class a step at most, so a ring wraps within the trajectory.

Held: sup_loss and unsup_loss within rtol 1e-8; contra_loss and loss
within rtol 2e-6, since the JAX step computes the cosine logits in
float32 even under x64 (its contra loss carries float32 rounding of XLA's
summation order; tests/test_torch_u2pl_ops.py measures it); every student
and teacher parameter within 1e-7 of its tensor's largest magnitude; the
bank's counts and pointers equal and its keys within 1e-10 of their
scale after the first semi step, 1e-6 after the later ones (float32 keys
of float64 reps that the float32 contrastive gradient has moved by then:
KEYS_LATER); the labeled batch's counts equal; after each aliased semi step the
port's teacher parameters are the student's own tensors, and after the
true-EMA step they differ from the student's.

Then the U2PL wiring of ``Runner.fit`` and ``Runner.test`` in the port
(``run_contrastive_fit``, ``run_test(method="contrastive")``,
floodseg_tpu_torch/train/fit.py) against the JAX package's, on the CPU,
in this file so that the fit's JAX loop runs the trajectory's compiled
steps (``oracle().steps``: one compile of each step a process).

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
contrastive loss, as above), the validation counts
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

from floodseg_tpu.cli.runner import Runner, _EvalState
from floodseg_tpu.data.synthetic import generate_synthetic_dataset as jax_generate
from floodseg_tpu.ops.metrics import MetricMeter as JaxMeter
from floodseg_tpu.train import contrastive as jcon

from floodseg_tpu_torch.train import (
    default_fit_config,
    make_u2pl_steps,
    role_datasets,
    run_contrastive_fit,
    run_test,
    sem_transforms,
    sync_teacher,
    train_loaders,
)

from torch_port_fixtures import jax_runner, masks_per_call, one_torch_thread  # noqa: F401
from torch_u2pl_fixtures import (
    B,
    CAPS,
    CCFG,
    CLASSES,
    COUNTS,
    LR,
    MAX_ITER,
    NAMES,
    SIZE,
    JaxDraws,
    bank_of,
    jax_params,
    jax_state,
    oracle,
    port_params,
    port_state_of,
    step_masks,
    t,
    weights,
)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

EF = np.float32(0.5)
# (kind, key): the semi keys' coins are 0.0806 (cutmix taken), 0.8150 (not
# taken) and 0.4023 (taken), jax.random.uniform of split(key, 5)[1]; class 2
# takes 16 keys in the first semi step and 8 in the second, filling its cap
# of 24, so its ring pointer wraps to 0
PLAN = (("sup", 100), ("sup", 101), ("semi", 0), ("semi", 20), ("ema", 3))
F32_REL = 2e-6
# the bank's float32 keys: those of the first semi step come from the synced
# weights, which only float64 arithmetic has touched; after it the weights
# carry the float32 contrastive gradient's rounding, which moves the
# float64 teacher reps by about 1e-8 of their scale, and a key by an ulp
# (measured: 8e-8 of the keys' largest magnitude)
KEYS_FIRST, KEYS_LATER = 1e-10, 1e-6


def _batch(rng):
    labels = rng.integers(0, CLASSES, (B, SIZE, SIZE))
    labels = np.where(rng.random(labels.shape) < 0.05, 255, labels).astype(np.int32)
    frames = [rng.standard_normal((B, SIZE, SIZE, 3)).astype(np.float32) for _ in range(2)]
    # the "u" role's zero labels, as the Runner's unlabeled loader gives them
    # (no step reads them): the fit below feeds the same jitted steps
    return {"l": {"frame_current": frames[0], "label": labels},
            "u": {"frame_current": frames[1], "label": np.zeros_like(labels)}}


@pytest.fixture(scope="module")
def trajectory():
    """(JAX's records, the port's) after each step of PLAN: metrics,
    student and teacher parameters, the bank, the coin."""
    sv, tv = weights(30), weights(31)
    rng = np.random.default_rng(32)
    batches = [_batch(rng) for _ in PLAN]
    keys = [jax.random.PRNGKey(k) for _, k in PLAN]
    o = oracle()
    jsteps = o.steps(MAX_ITER)
    ref, ours = [], []
    with jax.enable_x64(True):
        s = jax_state(o, sv, tv)
        rel = 0
        for (kind, _), key, batch in zip(PLAN, keys, batches):
            jb = {r: {k: jnp.asarray(a) for k, a in b.items()} for r, b in batch.items()}
            if kind == "sup":
                s, m = jsteps.sup(s, jb, key)
            else:
                if rel == 0:
                    s = jcon.sync_teacher(s)
                step = jsteps.semi if kind == "semi" else jsteps.semi_ema
                s, m = step(s, jb, key, jnp.float32(EF), jnp.int32(rel))
                rel += 1
            ref.append(({k: np.asarray(v) for k, v in m.items()},
                        jax_params(jax.device_get(s.student.params)),
                        jax_params(jax.device_get(s.teacher_params)), bank_of(s.bank)))

        state = port_state_of(sv, tv)
        sup, semi = make_u2pl_steps(CLASSES, CCFG, 255, 0.0)
        _, semi_ema = make_u2pl_steps(CLASSES, CCFG, 255, 0.0, true_ema=True)
        rel = 0
        for (kind, _), key, batch in zip(PLAN, keys, batches):
            tb = {r: {k: t(a) for k, a in b.items()} for r, b in batch.items()}
            s_masks, t_masks = step_masks(o, sv["params"], tv["params"], key, kind != "sup")
            with masks_per_call(state.student.model, {"forward": s_masks}, NAMES), \
                    masks_per_call(state.teacher, {"forward": t_masks}, NAMES):
                if kind == "sup":
                    state, m = sup(state, tb, None)
                else:
                    if rel == 0:
                        sync_teacher(state)
                    if kind == "ema":
                        sync_teacher(state, alias=False)
                    step = semi if kind == "semi" else semi_ema
                    state, m = step(state, tb, None, EF, rel, draws=JaxDraws.of_step(key))
                    rel += 1
            student = dict(state.student.model.named_parameters())
            aliased = all(p is student[n] for n, p in state.teacher.named_parameters())
            ours.append(({k: v.numpy() for k, v in m.items()}, port_params(state.student.model),
                         port_params(state.teacher), bank_of(state.bank), aliased))
    return ref, ours, state


@pytest.mark.parametrize("step", range(len(PLAN)))
def test_u2pl_step_losses_match_jax(trajectory, step):
    ref, ours, _ = trajectory
    rm, om = ref[step][0], ours[step][0]
    assert set(om) == set(rm)
    for k in ("sup_loss", "unsup_loss"):
        assert float(om[k]) == pytest.approx(float(rm[k]), rel=1e-8, abs=0.0), k
    for k in ("contra_loss", "loss"):
        assert float(om[k]) == pytest.approx(float(rm[k]), rel=F32_REL, abs=0.0), k
    for k in COUNTS:
        np.testing.assert_array_equal(om[k], rm[k], err_msg=k)
    if PLAN[step][0] != "sup":
        assert float(rm["unsup_loss"]) > 0 and float(rm["contra_loss"]) > 0


@pytest.mark.parametrize("net", ["student", "teacher"])
@pytest.mark.parametrize("step", range(len(PLAN)))
def test_u2pl_step_parameters_match_jax(trajectory, step, net):
    """Each parameter within 1e-7 of its tensor's largest magnitude; the
    student's all moved by the step."""
    ref, ours, _ = trajectory
    i = 1 if net == "student" else 2
    want, got = ref[step][i], ours[step][i]
    assert set(got) == set(want)
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=0, atol=1e-7 * np.abs(w).max(), err_msg=k)
    if net == "student" and step:
        before = ours[step - 1][1]
        assert all(not np.array_equal(got[k], before[k]) for k in got)


@pytest.mark.parametrize("step", range(2, len(PLAN)))
def test_u2pl_bank_and_teacher_match_jax(trajectory, step):
    """The bank after each semi step: counts and pointers equal, keys within
    KEYS_FIRST or KEYS_LATER of their scale, a ring wrapped by the end; the
    teacher aliased to the student after the aliased steps and its own
    after the EMA."""
    ref, ours, _ = trajectory
    (rc, rp, rk), (oc, op, ok) = ref[step][3], ours[step][3]
    np.testing.assert_array_equal(oc, rc)
    np.testing.assert_array_equal(op, rp)
    tol = KEYS_FIRST if step == 2 else KEYS_LATER
    np.testing.assert_allclose(ok, rk, rtol=0, atol=tol * np.abs(rk).max())
    assert oc.sum() > 0
    if step == len(PLAN) - 1:
        assert (op < oc).any(), (oc, op)
    kind = PLAN[step][0]
    assert ours[step][4] == (kind == "semi")
    if kind == "ema":
        assert any(not np.array_equal(ours[step][2][k], ours[step][1][k]) for k in ours[step][1])


# ------------------------------------------------- run_contrastive_fit and run_test

TREE = (128, 160)
EPOCHS, STEPS, SUP_ONLY = 2, 2, 1
FIT = default_fit_config(train_h=SIZE, train_w=SIZE, resize_h=TREE[0], resize_w=TREE[1],
                         frame_delta=5, workers=2, workers_test=2, max_epochs=EPOCHS,
                         limit_train_batches=STEPS, lr=LR, seed=42, aux_weight=0.0,
                         sup_only_epoch=SUP_ONLY, contrastive=CCFG, **CAPS)


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
    cfg = default_fit_config(**{**FIT.__dict__, "limit_train_batches": None})
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
    o = oracle()
    r = jax_runner(tree, "contrastive", FIT)
    tf = Runner._transforms(r)
    loaders, steps = Runner._train_loaders(r, tf)
    steps = min(steps, STEPS)
    jsteps = o.steps(EPOCHS * steps)
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
                        s, m = jsteps.sup(s, batch, key)
                    else:
                        if e == SUP_ONLY and i == 0:
                            s = jcon.sync_teacher(s)
                        s, m = jsteps.semi(s, batch, key, jnp.float32(e / EPOCHS),
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
    cfg = default_fit_config(**{**FIT.__dict__, "limit_test_batches": 1, "test_base_size": 96})
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
