"""Segmenter ViT training against the JAX package on the CPU: one
interpolated, one plain and one eval step at the narrow width of
tests/test_torch_vit.py (d = 128, 2 heads, 2 + 2 layers, patch 32) on
64 px frames, float64; and ``run_flow_fit`` and ``run_fit`` (the
single-frame ``supervised`` method: SemDataset, the rotating train
transform with MEAN padding) for the ViT against JAX wirings of
``Runner.fit`` over two steps.

The 64 px frames give 2x2 token maps and 4x4 block grids, so each chain's
first warp up-samples the token map (K1's plain version, and K1-bwd's in
the backward) and the chain is resized back to 2x2 with
align_corners=True, as the JAX package's ``warp_chain_masked`` does. The
ViT has no BN: nothing is threaded through encode(prev), encode(next) and
decode but the parameters. Dropout runs at the ViT's 0.1 at every flax
site (the tokens after the position embedding, the attention
probabilities, after ``proj`` and after each FeedForward layer, in both
the encoder and the MaskTransformer): the port takes the masks flax draws
in each of the JAX step's calls (encode(prev) with the step key's first
split, encode(next) with the second, decode with the third; the plain
step's encode and decode with the two halves), recorded by flax's module
path and injected by the port's module name (``vit_mask_names``) before
each call.

Tolerances as tests/test_torch_train_flow.py's: the loss within rtol
1e-8; every parameter within 1e-7 of its tensor's largest magnitude; eval
counts equal. The fits with dropout 0 on both sides: each epoch's mean
loss within rtol 1e-5 and the validation counts equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from floodseg_tpu.data.synthetic import generate_synthetic_dataset as jax_generate
from floodseg_tpu.models.vit import SegmenterViT as JaxSegmenterViT
from floodseg_tpu.train import flow as jflow
from floodseg_tpu.train.optim import make_optimizer as jax_make_optimizer
from floodseg_tpu.train.state import TrainState as JaxTrainState
from floodseg_tpu.train.supervised import make_loss_fn as jax_make_loss_fn

from floodseg_tpu_torch.models import SegmenterViT
from floodseg_tpu_torch.train import (
    default_fit_config,
    TrainState,
    make_flow_eval_step,
    make_flow_train_step,
    make_loss_fn,
    make_optimizer,
    run_fit,
    run_flow_fit,
)

from torch_port_fixtures import (
    _perturb_vit,
    _to_dict,
    flax_keep_masks,
    jax_fit,
    masks_per_call,
    port_state,
    vit_mask_names,
)

SIZE, B, T, CLASSES = 64, 2, 4, 5
LR, MAX_ITER, MIN_KEPT = 1e-3, 10, 2000
LEFT, RIGHT = (1, 3), (4, 2)
CONFIG = dict(image_size=SIZE, patch_size=32, d_model=128, n_layers=2, dec_layers=2,
              n_heads=2)
NAMES = vit_mask_names(CONFIG["n_layers"], CONFIG["dec_layers"])


def _batch(rng):
    """Two samples on 4x4 block grids (multiples of 2**-10), labels with 5%
    ignored."""
    gh = SIZE // 16
    base = np.stack(np.meshgrid(np.linspace(-0.75, 0.75, gh), np.linspace(-0.75, 0.75, gh)), -1)

    def grids():
        g = base[None, None] + rng.uniform(-0.2, 0.2, (T, B, gh, gh, 2))
        return (np.round(g * 1024) / 1024).astype(np.float32)

    labels = rng.integers(0, CLASSES, (B, SIZE, SIZE))
    labels = np.where(rng.random(labels.shape) < 0.05, 255, labels).astype(np.int32)
    return {"frame_prev": rng.standard_normal((B, SIZE, SIZE, 3)),
            "frame_next": rng.standard_normal((B, SIZE, SIZE, 3)),
            "frame_current": rng.standard_normal((B, SIZE, SIZE, 3)),
            "mvs_left": grids(), "mvs_right": grids(),
            "left_index": np.array(LEFT, np.int32), "right_index": np.array(RIGHT, np.int32),
            "label": labels}


def _jax_model(dropout=0.1):
    return JaxSegmenterViT(classes=CLASSES, dropout=dropout, dtype=jnp.float64, **CONFIG)


def _port_model(v, dropout=0.1):
    port = SegmenterViT(classes=CLASSES, dropout=dropout, dtype=torch.float64,
                        **CONFIG).double()
    port.load_state_dict(port_state(v))
    return port


def _init(seed, key=0):
    """JAX's float64 ViT variables, LayerNorms, biases and the cls token
    perturbed (flax initialises them to the identity and zeros)."""
    k = jax.random.PRNGKey(key)
    with jax.enable_x64(True):
        v = _to_dict(jax.device_get(jax.jit(lambda: _jax_model().init(
            {"params": k, "dropout": k}, jnp.zeros((B, SIZE, SIZE, 3)), train=False))()))
    _perturb_vit(v["params"], np.random.default_rng(seed))
    return jax.tree.map(lambda a: np.asarray(a, np.float64), v)


def _params(tree):
    return {k: v.numpy() for k, v in port_state({"params": tree}).items()}


@pytest.fixture(scope="module")
def trajectory():
    v = _init(25)
    batch = _batch(np.random.default_rng(26))
    k_interp, k_plain = jax.random.PRNGKey(1), jax.random.PRNGKey(2)
    with jax.enable_x64(True):
        jm = _jax_model()
        tx = jax_make_optimizer(LR, MAX_ITER)
        params = jax.tree.map(jnp.asarray, v["params"])
        state = JaxTrainState(step=jnp.zeros((), jnp.int32), params=params, batch_stats={},
                              opt_state=tx.init(params), tx=tx)
        frames, feat = batch["frame_prev"], np.zeros((B, 2, 2, CONFIG["d_model"]))
        r1, r2, r3 = jax.random.split(k_interp, 3)
        p1, p2 = jax.random.split(k_plain)
        vs = {"params": state.params}
        masks = {"interp": {"encode": [flax_keep_masks(jm, vs, r, frames, "encode")
                                       for r in (r1, r2)],
                            "decode": [flax_keep_masks(jm, vs, r3, feat, "decode")]},
                 "plain": {"encode": [flax_keep_masks(jm, vs, p1, frames, "encode")],
                           "decode": [flax_keep_masks(jm, vs, p2, feat, "decode")]}}
        jb = {k: jnp.asarray(a) for k, a in batch.items()}
        interp, plain = jflow.make_flow_train_step(
            jm, jax_make_loss_fn("ohem", 0.0, 255, 0.7, MIN_KEPT), CLASSES, 255)
        s1, m1 = jax.jit(interp)(state, jb, k_interp)
        s2, m2 = jax.jit(plain)(s1, jb, k_plain)
        ev = jax.jit(jflow.make_flow_eval_step(jm, CLASSES, 255))(s2, jb)
        ref = {"interp": (float(m1["loss"]), _params(s1.params)),
               "plain": (float(m2["loss"]), _params(s2.params)),
               "eval": {k: np.asarray(ev[k]) for k in ("intersection", "union", "target")}}

    port = _port_model(v)
    opt, sched = make_optimizer(port, LR, MAX_ITER)
    st = TrainState(0, port, opt, sched)
    p_interp, p_plain = make_flow_train_step(
        port, make_loss_fn("ohem", 0.0, 255, 0.7, MIN_KEPT), CLASSES, 255)
    tb = {k: (a if k in ("left_index", "right_index") else torch.from_numpy(a))
          for k, a in batch.items()}
    ours = {}
    for name, step in (("interp", p_interp), ("plain", p_plain)):
        with masks_per_call(port, masks[name], NAMES):
            st, m = step(st, tb, None)
        ours[name] = (float(m["loss"]),
                      {k: t.detach().numpy().copy() for k, t in port.state_dict().items()})
    ev = make_flow_eval_step(port, CLASSES, 255)(st, tb)
    ours["eval"] = {k: ev[k].numpy() for k in ("intersection", "union", "target")}
    return ref, ours, masks


@pytest.mark.parametrize("step", ["interp", "plain"])
def test_train_step_loss_matches_jax(trajectory, step):
    ref, ours, _ = trajectory
    assert ours[step][0] == pytest.approx(ref[step][0], rel=1e-8)


@pytest.mark.parametrize("part", ["encoder", "decoder"])
@pytest.mark.parametrize("step", ["interp", "plain"])
def test_train_step_updates_match_jax(trajectory, step, part):
    """Each parameter after the step within 1e-7 of its largest magnitude
    (the encoder's at the trunk's LR, the decoder's at 10x)."""
    ref, ours, _ = trajectory
    want, got = ref[step][1], ours[step][1]
    assert set(got) == set(want)
    keys = [k for k in want if k.startswith(part + ".")]
    assert len(keys) > 20
    for k in keys:
        w = np.asarray(want[k], np.float64)
        np.testing.assert_allclose(got[k], w, rtol=0, atol=1e-7 * np.abs(w).max(), err_msg=k)


def test_eval_step_counts_match_jax(trajectory):
    ref, ours, _ = trajectory
    for k in ("intersection", "union", "target"):
        np.testing.assert_array_equal(ours["eval"][k], ref["eval"][k], err_msg=k)


def test_every_dropout_site_drew_a_mask(trajectory):
    """Each encode call draws at the position embedding and at four sites a
    block (2 blocks), each decode call at four sites in each of its 2
    blocks: 9 and 8 masks, each keeping about 90% of its elements, and the
    two encode calls' masks differ (two keys)."""
    _, _, masks = trajectory
    enc, dec = masks["interp"]["encode"], masks["interp"]["decode"][0]
    assert [len(m) for m in enc] == [9, 9] and len(dec) == 8
    attn = enc[0]["encoder/block0/attn/Dropout_0"]
    assert attn.shape == (B, 2, 5, 5)  # (batch, heads, 1 + 4 tokens, 1 + 4)
    keep = np.concatenate([m.reshape(-1) for m in list(enc[0].values()) + list(dec.values())])
    assert 0.85 < keep.mean() < 0.95
    assert not np.array_equal(enc[0]["encoder/Dropout_0"], enc[1]["encoder/Dropout_0"])


# ---------------------------------------------------------------- run_flow_fit

TREE = (128, 160)
FIT = default_fit_config(train_h=SIZE, train_w=SIZE, resize_h=TREE[0], resize_w=TREE[1],
                         frame_delta=5, workers=2, max_epochs=1, limit_train_batches=2, lr=1e-3,
                         seed=42)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """One synthetic tree: 30 frames of 128x160, 8 labeled."""
    return jax_generate(str(tmp_path_factory.mktemp("vit_tree")), num_frames=30, size=TREE,
                        frame_delta=5, num_labeled=8)


@pytest.fixture(scope="module", params=["flow_supervised", "supervised"])
def fits(request, tree):
    """run_flow_fit or run_fit and the JAX wiring, one epoch of two steps
    and a validation pass, dropout 0 on both sides."""
    v = _init(27, key=1)
    with jax.enable_x64(True):
        ref = jax_fit(tree, _jax_model(dropout=0.0), v, FIT, request.param, SIZE)
    run = run_flow_fit if request.param == "flow_supervised" else run_fit
    return ref, run(_port_model(v, dropout=0.0), tree, FIT, device="cpu")


def test_run_fit_vit_matches_jax(fits):
    (ref_loss, ref_meter, steps), ours = fits
    assert ours["steps"] == steps == 2 and len(ours["epochs"]) == 1
    assert ours["epochs"][0]["train_loss"] == pytest.approx(ref_loss, rel=1e-5)
    counts = ours["epochs"][0]["val_counts"]
    for k in ("intersection", "union", "target"):
        np.testing.assert_array_equal(counts[k], getattr(ref_meter, k), err_msg=k)
