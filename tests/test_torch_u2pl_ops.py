"""U2PL's pieces (floodseg_tpu_torch/ops/u2pl.py, train/memory_bank.py and
the contrastive loss of train/contrastive.py) against the JAX package on
the CPU, float64, small shapes, the same numpy inputs on both sides.

- ``masked_percentile`` at a float32 percent (the step's schedules are
  float32 and meet the float64 count only in the rank), ``softmax_entropy``,
  ``nearest_resize_mask`` and the one-hot labels (train/gan.py's
  ``one_hot_masks``, 255 an all-zero row) within 1e-12 or equal;
- ``compute_unsupervised_loss`` and its gradient within 1e-12, also when
  no pixel survives (0 and a zero gradient);
- ``masked_subset`` on JAX's scores and ``generate_unsup_data`` in the
  cutout, cutmix and classmix modes on JAX's draws (``JaxDraws``): equal;
  ``masked_choice``'s floor(u * count) rule against numpy, and in range on
  an empty mask;
- ``_rank_of_class`` on rows with ties: equal (the stable sort orders tied
  classes by index);
- the bank: enqueue, the ring's wrap, class 0's larger cap, sampling:
  counts and pointers equal, keys equal;
- ``contra_memobank_loss`` (C 5, D 16, Q 8, N 4), without and with a
  momentum prototype, twice on one bank (caps 20, class 0 30; 16 keys a
  class a call at most) so the second call samples keys the first
  enqueued and a ring wraps: the bank equal, the loss and the
  gradient w.r.t. ``rep_all`` within 2e-6 of their scale, since the JAX
  function casts anchors, positives and negatives to float32 before the
  cosine (contrastive.py:198-202) and XLA's float32 sums run in another
  order than torch's (measured: the loss 0 or 7.1e-8 apart, the gradient
  1.2e-7 to 3.3e-7 of its scale); the new prototypes within 1e-12
  (float64).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from floodseg_tpu.ops import u2pl as ju2pl
from floodseg_tpu.train import contrastive as jcon
from floodseg_tpu.train import memory_bank as jbank

from floodseg_tpu_torch.ops import u2pl
from floodseg_tpu_torch.train import (
    ContrastiveConfig,
    contra_memobank_loss,
    create_memory_bank,
    enqueue,
    one_hot_masks,
    sample_negatives,
)
from floodseg_tpu_torch.train.contrastive import _rank_of_class

from torch_u2pl_fixtures import JaxDraws, bank_of, t

C = 5
F32_REL = 2e-6


@pytest.fixture(autouse=True)
def x64():
    with jax.enable_x64(True):
        yield


def _labels(rng, shape, ignore=0.1):
    lab = rng.integers(0, C, shape)
    return np.where(rng.random(shape) < ignore, 255, lab).astype(np.int32)


def test_masked_percentile_matches_jax():
    rng = np.random.default_rng(0)
    values = rng.standard_normal((2, 9, 11))
    mask = rng.random(values.shape) < 0.7
    for p in (np.float32(37.3), np.float32(0.0), np.float32(100.0), np.float32(86.66667)):
        want = float(ju2pl.masked_percentile(jnp.asarray(values), jnp.asarray(mask),
                                             jnp.float32(p)))
        got = float(u2pl.masked_percentile(t(values), t(mask), torch.tensor(p)))
        assert got == pytest.approx(want, rel=1e-12, abs=0.0), p
        # numpy's rank is float64 throughout; the float32 p / 100 moves it
        assert got == pytest.approx(float(np.percentile(values[mask], float(p))), rel=1e-5)


def test_entropy_resize_and_one_hot_match_jax():
    rng = np.random.default_rng(1)
    logits = rng.standard_normal((2, 7, 6, C)) * 3
    np.testing.assert_allclose(u2pl.softmax_entropy(t(logits)).numpy(),
                               np.asarray(ju2pl.softmax_entropy(jnp.asarray(logits))),
                               rtol=1e-12, atol=0)
    masks = (rng.random((2, 7, 9, 3)) < 0.5).astype(np.float32)
    for size in ((14, 18), (5, 4), (7, 9)):
        np.testing.assert_array_equal(u2pl.nearest_resize_mask(t(masks), size).numpy(),
                                      np.asarray(ju2pl.nearest_resize_mask(jnp.asarray(masks),
                                                                           size)))
    labels = _labels(rng, (2, 7, 6))
    np.testing.assert_array_equal(one_hot_masks(t(labels), C).numpy(),
                                  np.asarray(ju2pl.label_onehot(jnp.asarray(labels), C)))


@pytest.mark.parametrize("percent", [np.float32(84.0), np.float32(0.0)])
def test_unsupervised_loss_and_grad_match_jax(percent):
    """Value and gradient w.r.t. the student logits; at percent 0 the
    threshold is the least entropy, so no pixel survives: 0, zero
    gradient."""
    rng = np.random.default_rng(2)
    pred = rng.standard_normal((2, 8, 10, C))
    teacher = rng.standard_normal((2, 8, 10, C)) * 2
    target = _labels(rng, (2, 8, 10))
    want, want_g = jax.value_and_grad(lambda p: ju2pl.compute_unsupervised_loss(
        p, jnp.asarray(target), jnp.float32(percent), jnp.asarray(teacher)))(jnp.asarray(pred))
    x = t(pred).requires_grad_(True)
    got = u2pl.compute_unsupervised_loss(x, t(target), torch.tensor(percent), t(teacher))
    got.backward()
    assert float(got.detach()) == pytest.approx(float(want), rel=1e-12, abs=0.0)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want_g), rtol=0,
                               atol=1e-12 * max(np.abs(np.asarray(want_g)).max(), 1e-300))
    if percent == 0:
        assert float(got) == 0.0 and not x.grad.abs().max()


def test_masked_subset_and_choice():
    rng = np.random.default_rng(3)
    key = jax.random.PRNGKey(5)
    for p in (0.3, 0.002):  # more and fewer entries than n
        mask = rng.random(500) < p
        scores = jax.random.uniform(key, mask.shape)
        want_i, want_ok = ju2pl.masked_subset(key, jnp.asarray(mask), 64)
        got_i, got_ok = u2pl.masked_subset(t(scores), t(mask), 64)
        np.testing.assert_array_equal(got_ok.numpy(), np.asarray(want_ok))
        ok = got_ok.numpy()
        np.testing.assert_array_equal(got_i.numpy()[ok], np.asarray(want_i)[ok])
        assert ok.sum() == min(mask.sum(), 64) and not ok[ok.sum():].any()
        u = rng.random(40)
        got = u2pl.masked_choice(t(u), t(mask)).numpy()
        np.testing.assert_array_equal(got, np.flatnonzero(mask)[np.floor(u * mask.sum())
                                                                .astype(int)])
    empty = u2pl.masked_choice(t(rng.random(8)), torch.zeros(500, dtype=torch.bool))
    assert empty.min() >= 0 and empty.max() < 500


@pytest.mark.parametrize("mode", ["cutout", "cutmix", "classmix"])
def test_generate_unsup_data_matches_jax(mode):
    """The mixed images, targets and logits equal, each sample's box or
    class scores drawn from JAX's keys."""
    rng = np.random.default_rng(4)
    images = rng.standard_normal((3, 16, 20, 3)).astype(np.float32)
    target = rng.integers(0, C, (3, 16, 20)).astype(np.int32)
    target[0] = np.where(target[0] == 4, 1, target[0])  # a class absent from a sample
    logits = rng.random((3, 16, 20))
    r_aug = jax.random.PRNGKey(11)
    want = ju2pl.generate_unsup_data(r_aug, jnp.asarray(images), jnp.asarray(target),
                                     jnp.asarray(logits), mode, C)
    draws = JaxDraws(r_aug, None, jax.random.PRNGKey(0), 3, C)
    got = u2pl.generate_unsup_data(draws, t(images), t(target), t(logits), mode, C)
    for g, w in zip(got, want):
        assert g.dtype == t(np.asarray(w)).dtype
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert (got[0].numpy() != images).any()


def test_rank_of_class_with_ties_matches_jax():
    rng = np.random.default_rng(5)
    prob = rng.dirichlet(np.ones(C), (3, 7))
    prob[0, :, 1] = prob[0, :, 3]          # a tie between classes 1 and 3
    prob[1, :3] = 0.2                      # all five tied
    prob[2, :, 0] = prob[2, :, 4] = prob[2, :, 2]
    for c in range(C):
        np.testing.assert_array_equal(_rank_of_class(t(prob), c).numpy(),
                                      np.asarray(jcon._rank_of_class(jnp.asarray(prob), c)))


def test_bank_enqueue_wrap_and_sampling_match_jax():
    """Enqueues of 6, 0, 5 and 4 valid keys into caps 8 (class 0: 12) from
    the scratch-row layout: counts and pointers equal after each, the keys
    equal; then sampled keys equal for the same indices."""
    rng = np.random.default_rng(6)
    d, m = 4, 6
    jb = jbank.create_memory_bank(3, d, 8, 12)
    pb = create_memory_bank(3, d, 8, 12, max_enqueue=m)
    for c, n in ((0, 6), (1, 6), (1, 0), (1, 5), (0, 5), (1, 4), (2, 6), (0, 4)):
        keys = rng.standard_normal((m, d))
        valid = np.arange(m) < n
        jb = jbank.enqueue(jb, c, jnp.asarray(keys), jnp.asarray(valid))
        enqueue(pb, c, t(keys), t(valid))
        for g, w in zip(bank_of(pb), bank_of(jb)):
            np.testing.assert_array_equal(g, w)
    assert bank_of(pb)[0].tolist() == [12, 8, 6] and bank_of(pb)[1].tolist() == [3, 7, 6]
    key = jax.random.PRNGKey(2)
    for c in range(3):
        idx = jax.random.randint(key, (10,), 0, jnp.maximum(jb.counts[c], 1))
        np.testing.assert_array_equal(sample_negatives(pb, c, t(idx).long()).numpy(),
                                      np.asarray(jbank.sample_negatives(key, jb, c, 10)))
    with pytest.raises(ValueError, match="max_enqueue"):
        create_memory_bank(3, d, 8, 12, max_enqueue=9)


def _contra_inputs(rng, b_l=2, b_u=2, hw=12, d=16):
    b = b_l + b_u
    label_l = _labels(rng, (b_l, hw, hw))
    label_u = _labels(rng, (b_u, hw, hw), ignore=0.0)
    probs = rng.dirichlet(np.full(C, 0.5), (b, hw, hw))
    return dict(
        rep_all=rng.standard_normal((b, hw, hw, d)),
        rep_teacher=rng.standard_normal((b, hw, hw, d)),
        label_l_oh=np.asarray(ju2pl.label_onehot(jnp.asarray(label_l), C), np.float64),
        label_u_oh=np.asarray(ju2pl.label_onehot(jnp.asarray(label_u), C), np.float64),
        prob_l=probs[:b_l], prob_u=probs[b_l:],
        low_mask=(rng.random((b, hw, hw, 1)) < 0.6).astype(np.float64),
        high_mask=(rng.random((b, hw, hw, 1)) < 0.5).astype(np.float64)), label_l


CFG = dict(num_queries=8, num_negatives=4, max_enqueue=16)


@pytest.mark.parametrize("proto", [False, True])
def test_contra_memobank_loss_matches_jax(proto):
    rng = np.random.default_rng(7 + proto)
    jcfg = jcon.ContrastiveConfig(**CFG)
    pcfg = ContrastiveConfig(**CFG)
    jb = jbank.create_memory_bank(C, 16, 20, 30)
    pb = create_memory_bank(C, 16, 20, 30, max_enqueue=16)
    prototype = np.zeros((C, 16))
    for call in range(2):
        x, label_l = _contra_inputs(rng)
        key = jax.random.PRNGKey(20 + call)
        it = np.int32(3 + call)

        def jloss(rep, bank, x=x, label_l=label_l, key=key, it=it):
            args = {k: jnp.asarray(v) for k, v in x.items() if k != "rep_all"}
            out = jcon.contra_memobank_loss(
                key, rep, cfg=jcfg, bank=bank, raw_label_l=jnp.asarray(label_l),
                prototype=jnp.asarray(prototype) if proto else None,
                i_iter=jnp.asarray(it) if proto else None, **args)
            return out[-1], out[:-1]

        (want, aux), want_g = jax.value_and_grad(jloss, has_aux=True)(
            jnp.asarray(x["rep_all"]), jb)
        jb = aux[-1]
        rep = t(x["rep_all"]).requires_grad_(True)
        draws = JaxDraws(None, None, key, 0, C)
        out = contra_memobank_loss(draws, rep, *(t(x[k]) for k in (
            "rep_teacher", "label_l_oh", "label_u_oh", "prob_l", "prob_u", "low_mask",
            "high_mask")), pb, pcfg, prototype=t(prototype) if proto else None,
            i_iter=int(it) if proto else None)
        got = out[-1] if proto else out
        got.backward()
        for g, w in zip(bank_of(pb), bank_of(jb)):
            np.testing.assert_array_equal(g, w)
        assert float(want) > 0
        assert float(got.detach()) == pytest.approx(float(want), rel=F32_REL, abs=0.0)
        wg = np.asarray(want_g)
        np.testing.assert_allclose(rep.grad.numpy(), wg, rtol=0, atol=F32_REL * np.abs(wg).max())
        if proto:
            np.testing.assert_allclose(out[0].numpy(), np.asarray(aux[0]), rtol=0,
                                       atol=1e-12 * np.abs(np.asarray(aux[0])).max())
            prototype = np.asarray(aux[0])
    counts, ptrs, _ = bank_of(pb)
    assert (counts[1:] == 20).any() and (ptrs < counts).any(), (counts, ptrs)
