"""The s4GAN slice's pieces against the JAX package on the CPU.

The discriminator (floodseg_tpu_torch/models/discriminator.py) against
``S4GANDiscriminator`` in float64 at ndf 64 on a 64 px input of
softmax-like maps and an image (8 channels), in eval and in training with
flax's channel masks injected by module path: logit and pooled feature
within 1e-10 relative. Its weight bridge against
``lightning_export.export_s4gan_discriminator``: the same keys, the same
values. The losses it brings (``binary_cross_entropy``,
``feature_matching_loss``, the per-pixel ``weights`` of
``cross_entropy_loss``) and ``one_hot_masks`` with 255 pixels, float64,
within rtol 1e-12. The two optimizers against optax, two steps each on
random gradients in float64: the generator's SGD without the aux heads
(``exclude_subtrees``) over a PSPNet-50 with aux parameter tree drawn in
the init's shapes, the aux's gradients nonzero (aux bit-equal to its
start, every other tensor within 1e-7 of its largest magnitude), and the
discriminator's Adam (betas (0.9, 0.99), no decay, one group) within 1e-7.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from floodseg_tpu.models import build_model as jax_build_model
from floodseg_tpu.models.discriminator import S4GANDiscriminator as JaxDiscriminator
from floodseg_tpu.models.lightning_export import export_s4gan_discriminator
from floodseg_tpu.ops import losses as jl
from floodseg_tpu.train import gan as jgan
from floodseg_tpu.train import optim as jax_optim

from floodseg_tpu_torch.models import S4GANDiscriminator, build_model, convert
from floodseg_tpu_torch.ops import losses
from floodseg_tpu_torch.train import AUX_KEYS, TrainState, make_optimizer, one_hot_masks

from torch_port_fixtures import _numpy_init, flax_keep_masks_fn, numpy_leaves, port_state

B, SIZE, CLASSES = 2, 64, 5
D_MASKS = {f"Dropout_{i}": f"layers.{3 * i + 2}" for i in range(3)}
REL = 1e-10


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def disc():
    """(flax D, its float64 variables drawn in the init's shapes, the port's
    D with the same weights, a float64 input)."""
    jd = JaxDiscriminator(num_classes=CLASSES, dtype=jnp.float64)
    rng = np.random.default_rng(40)
    x = np.concatenate([rng.dirichlet(np.ones(CLASSES), (B, SIZE, SIZE)),
                        rng.uniform(0, 1, (B, SIZE, SIZE, 3))], -1)
    with jax.enable_x64(True):
        shapes = jax.eval_shape(lambda: jd.init({"params": jax.random.PRNGKey(3)},
                                                jnp.zeros((1, SIZE, SIZE, CLASSES + 3)),
                                                train=False))
    v = {"params": numpy_leaves(shapes["params"], rng)}
    port = S4GANDiscriminator(num_classes=CLASSES, dtype=torch.float64).double().eval()
    port.load_state_dict(port_state(v))
    return jd, v, port, x


def _close(got, want, rel=REL):
    want = np.asarray(want)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                               atol=rel * np.abs(want).max())


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_discriminator_matches_jax(disc, train):
    """Logit (B,) and pooled feature (B, 512) within 1e-10 relative; in
    training each of the three channel dropouts takes flax's mask for the
    key (about half of each sample's maps kept)."""
    jd, v, port, x = disc
    key = jax.random.PRNGKey(11)
    with jax.enable_x64(True):
        z, feat = jax.jit(functools.partial(jd.apply, train=train))(
            v, jnp.asarray(x), rngs={"dropout": key})
        masks = flax_keep_masks_fn(jd, x)(v, key) if train else {}
    assert set(masks) == (set(D_MASKS) if train else set())
    for path, mask in masks.items():
        side = SIZE // 2 ** (int(path[-1]) + 1)
        assert mask.shape == (B, side, side, 64 * 2 ** int(path[-1]))
        maps = mask[:, :1, :1]  # channel dropout: one draw a map
        np.testing.assert_array_equal(mask, np.broadcast_to(maps, mask.shape))
        assert 0.3 < maps.mean() < 0.7
        port.get_submodule(D_MASKS[path]).keep = _t(maps.transpose(0, 3, 1, 2))
    port.train(train)
    try:
        gz, gfeat = port(_t(x))
    finally:
        for name in D_MASKS.values():
            port.get_submodule(name).keep = None
        port.eval()
    assert gz.shape == (B,) and gfeat.shape == (B, 512)
    _close(gz, z)
    _close(gfeat, feat)


def test_discriminator_bridge_matches_export(disc):
    """from_jax_variables of a discriminator tree (float32, as a checkpoint
    holds it) gives the keys and values of export_s4gan_discriminator;
    load_jax_variables strict-loads them."""
    v = jax.tree.map(lambda a: np.asarray(a, np.float32), disc[1])
    ours, ref = convert.from_jax_variables(v), export_s4gan_discriminator(v["params"])
    assert sorted(ours) == sorted(ref) == sorted(S4GANDiscriminator().state_dict())
    for k, a in ref.items():
        np.testing.assert_array_equal(ours[k], a, err_msg=k)
    port = convert.load_jax_variables(S4GANDiscriminator(), v)
    assert torch.equal(port.final[0].weight, _t(ref["final.0.weight"]))


def test_bce_and_feature_matching_match_jax():
    rng = np.random.default_rng(41)
    z = rng.normal(0, 4, 16)
    t = (rng.random(16) < 0.5).astype(np.float64)
    fa, fb = rng.normal(size=(3, 512)), rng.normal(size=(3, 512))
    with jax.enable_x64(True):
        want_bce = float(jl.binary_cross_entropy(jnp.asarray(z), jnp.asarray(t)))
        want_fm = float(jl.feature_matching_loss(jnp.asarray(fa), jnp.asarray(fb)))
    assert float(losses.binary_cross_entropy(_t(z), _t(t))) == pytest.approx(want_bce, rel=1e-12)
    assert float(losses.feature_matching_loss(_t(fa), _t(fb))) == pytest.approx(want_fm,
                                                                                 rel=1e-12)


@pytest.mark.parametrize("kept", ["one_sample", "none"])
def test_weighted_cross_entropy_matches_jax(kept):
    """CE with per-pixel weights (the self-training loss: one sample's
    pixels at weight 1, or none, where the denominator is max(., 1)) and
    the ignore index -1, float64, within rtol 1e-12."""
    rng = np.random.default_rng(42)
    logits = rng.normal(size=(B, 9, 9, CLASSES))
    labels = logits.argmax(-1).astype(np.int32)
    sel = np.array([1.0, 0.0]) if kept == "one_sample" else np.zeros(B)
    w = np.broadcast_to(sel[:, None, None], labels.shape).astype(np.float32)
    with jax.enable_x64(True):
        want = float(jl.cross_entropy_loss(jnp.asarray(logits), jnp.asarray(labels), -1,
                                           weights=jnp.asarray(w)))
    got = losses.cross_entropy_loss(_t(logits), _t(labels), -1, weights=_t(w))
    assert float(got) == pytest.approx(want, rel=1e-12, abs=0.0)
    assert (want > 0) == (kept == "one_sample")


def test_one_hot_masks_match_jax():
    """255 (and any label outside the classes) gives an all-zero row."""
    rng = np.random.default_rng(43)
    labels = rng.integers(0, CLASSES, (B, 7, 7)).astype(np.int32)
    labels[rng.random(labels.shape) < 0.2] = 255
    want = np.asarray(jgan.one_hot_masks(jnp.asarray(labels), CLASSES))
    got = one_hot_masks(_t(labels), CLASSES)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got.numpy()[labels == 255] == 0).all()


# ---------------------------------------------------------------- optimizers

LR, MAX_ITER, WD = 1e-2, 10, 5e-4


def _optax_steps(tx, params, grads):
    """Two optax steps, jitted, on each top-level subtree flattened to one
    vector (the transforms are elementwise and mask by top-level key);
    returns the tree of the updated parameters."""
    def flat(tree):
        return {k: jnp.concatenate([jnp.ravel(a) for a in jax.tree.leaves(v)])
                for k, v in tree.items()}

    def steps(params, grads):
        state = tx.init(params)
        for g in grads:
            upd, state = tx.update(g, state, params)
            params = optax.apply_updates(params, upd)
        return params

    out = jax.jit(steps)(flat(params), [flat(g) for g in grads])
    tree = {}
    for k, v in params.items():
        leaves, treedef = jax.tree.flatten(v)
        cuts = np.cumsum([np.size(a) for a in leaves])[:-1]
        parts = np.split(np.asarray(out[k]), cuts)
        tree[k] = jax.tree.unflatten(treedef, [p.reshape(np.shape(a))
                                               for p, a in zip(parts, leaves)])
    return tree


def _port_steps(model, opt, sched, grads_by_key):
    ts = TrainState(0, model, opt, sched)
    for g in grads_by_key:
        opt.zero_grad(set_to_none=True)
        for n, p in model.named_parameters():
            p.grad = g[n].clone()
        ts.apply_gradients()
    assert ts.step == len(grads_by_key)


def _bridge_params(params, stats):
    """A JAX params tree through the bridge (float64 kept): the state_dict
    entries that are parameters."""
    return port_state({"params": params, "batch_stats": stats})


def test_generator_sgd_excludes_aux_as_optax():
    """Two SGD steps (momentum 0.9, weight decay 5e-4, heads at 10x) on a
    PSPNet-50 with aux tree, every gradient random and nonzero, the aux's
    too: the aux head's parameters equal to their start to the bit (not in
    the optimizer), every other parameter within 1e-7 of its tensor's
    largest magnitude of optax's exclude_subtrees(make_optimizer(...))."""
    jm = jax_build_model("pspnet", classes=CLASSES, layers=50, with_aux=True)
    key = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(lambda: jm.init({"params": key, "dropout": key},
                                            jnp.zeros((1, 65, 65, 3)), train=True))
    rng = np.random.default_rng(44)
    v = jax.tree.map(lambda a: np.asarray(a, np.float64), _numpy_init(shapes, rng))
    grads = [jax.tree.map(lambda a: rng.standard_normal(a.shape, np.float32).astype(np.float64),
                          v["params"]) for _ in range(2)]
    with jax.enable_x64(True):
        tx = jax_optim.exclude_subtrees(jax_optim.make_optimizer(LR, MAX_ITER, "sgd", 0.9, WD),
                                        ("aux", "aux_classifier"))
        ref = _optax_steps(tx, v["params"], grads)
    want = _bridge_params(ref, v["batch_stats"])
    port = build_model("pspnet", classes=CLASSES, layers=50, with_aux=True).double()
    port.load_state_dict(port_state(v))
    start = {k: p.detach().clone() for k, p in port.named_parameters()}
    port_grads = [_bridge_params(g, v["batch_stats"]) for g in grads]
    del grads, ref
    opt, sched = make_optimizer(port, LR, MAX_ITER, "sgd", 0.9, WD, exclude=AUX_KEYS)
    _port_steps(port, opt, sched, port_grads)
    aux = [k for k, _ in port.named_parameters() if k.startswith("aux.")]
    assert len(aux) == 5
    for k, p in port.named_parameters():
        got = p.detach()
        if k in aux:
            assert torch.equal(got, start[k]), k
            np.testing.assert_array_equal(want[k].numpy(), start[k].numpy(), err_msg=k)
        else:
            w = want[k].numpy()
            assert not torch.equal(got, start[k]), k
            np.testing.assert_allclose(got.numpy(), w, rtol=0, atol=1e-7 * np.abs(w).max(),
                                       err_msg=k)


def test_discriminator_adam_matches_optax(disc):
    """Two Adam steps (lr_D, betas (0.9, 0.99), no weight decay, one group
    at the base LR) on random gradients: every parameter within 1e-7 of its
    tensor's largest magnitude of optax's make_optimizer(..., "adam")."""
    _, v, _, _ = disc
    rng = np.random.default_rng(45)
    grads = [jax.tree.map(lambda a: rng.standard_normal(a.shape), v["params"])
             for _ in range(2)]
    with jax.enable_x64(True):
        tx = jax_optim.make_optimizer(1e-4, MAX_ITER, "adam", weight_decay=0.0,
                                      head_lr_scale=1.0, betas=(0.9, 0.99))
        ref = _optax_steps(tx, v["params"], grads)
    want = port_state({"params": ref})
    port = S4GANDiscriminator(num_classes=CLASSES).double()
    port.load_state_dict(port_state(v))
    opt, sched = make_optimizer(port, 1e-4, MAX_ITER, "adam", weight_decay=0.0,
                                head_lr_scale=1.0, betas=(0.9, 0.99))
    assert len(opt.param_groups) == 1 and opt.param_groups[0]["lr_scale"] == 1.0
    _port_steps(port, opt, sched, [port_state({"params": g}) for g in grads])
    for k, p in port.named_parameters():
        w = want[k].numpy()
        np.testing.assert_allclose(p.detach().numpy(), w, rtol=0,
                                   atol=1e-7 * np.abs(w).max(), err_msg=k)
