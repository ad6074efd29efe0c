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
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from floodseg_tpu.train import contrastive as jcon

from floodseg_tpu_torch.train import make_u2pl_steps, sync_teacher

from torch_port_fixtures import masks_per_call
from torch_u2pl_fixtures import (
    B,
    CCFG,
    CLASSES,
    COUNTS,
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
    return {"l": {"frame_current": frames[0], "label": labels},
            "u": {"frame_current": frames[1]}}


@pytest.fixture(scope="module")
def trajectory():
    """(JAX's records, the port's) after each step of PLAN: metrics,
    student and teacher parameters, the bank, the coin."""
    sv, tv = weights(30), weights(31)
    rng = np.random.default_rng(32)
    batches = [_batch(rng) for _ in PLAN]
    keys = [jax.random.PRNGKey(k) for _, k in PLAN]
    o = oracle()
    ref, ours = [], []
    with jax.enable_x64(True):
        s = jax_state(o, sv, tv)
        rel = 0
        for (kind, _), key, batch in zip(PLAN, keys, batches):
            jb = {r: {k: jnp.asarray(a) for k, a in b.items()} for r, b in batch.items()}
            if kind == "sup":
                s, m = o.sup(s, jb, key)
            else:
                if rel == 0:
                    s = jcon.sync_teacher(s)
                step = o.semi if kind == "semi" else o.semi_ema
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
