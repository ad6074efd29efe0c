"""The Segmenter stack's model side against the JAX package on the CPU:
``ViTClassifier`` (models/vit.py) through the weight bridge, the attention
maps (segm/attn.py) and the sliding-window inference and evaluation
(segm/inference.py), with the same weights on both sides.

Tolerances, the network bounds of tests/test_torch_vit.py: float32 logits
within NET_SHARE (1e-4) of their largest magnitude, bf16 within 24 bf16
ulps of it (the full-width forward's bound); attention probabilities
within 1e-5 (they lie in [0, 1]: F32_SHARE of 1); the sliding window's
probabilities within PROB_ATOL = 1e-5 and its argmax equal (the logits
agree to 1e-4 of their scale, so a probability moves by no more than about
that times its softmax slope); ``evaluate_dataset``'s mmseg summary equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from floodseg_tpu.models import vit as jvit
from floodseg_tpu.segm import attn as jattn
from floodseg_tpu.segm import data as jdata
from floodseg_tpu.segm import inference as jinf

from floodseg_tpu_torch.data.image import write_jpeg, write_png
from floodseg_tpu_torch.models import ViTClassifier, load_jax_variables
from floodseg_tpu_torch.models.vit import Attention
from floodseg_tpu_torch.segm import attn, data, inference

from torch_port_fixtures import numpy_leaves, one_torch_thread, vit_pair  # noqa: F401

NET_SHARE = 1e-4
BF16_ULP = 2.0 ** -8
PROB_ATOL = 1e-5
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(scope="module")
def pair(one_torch_thread):  # noqa: F811
    """The narrow float32 ViT/32 of tests/test_torch_vit.py (d = 128, 2 + 2
    layers, 5 classes) and its jitted JAX forward."""
    jm, v, port = vit_pair(size=64)
    fwd = jax.jit(lambda variables, x: jm.apply(variables, x, train=False)["pred"])
    return jm, v, port, fwd


@pytest.mark.parametrize("tag", list(DTYPES))
def test_vit_classifier_matches_jax(tag):
    """ViT/16 classifier at d = 64, 2 layers, 7 classes, 32 px, weights
    drawn in the init's shapes; the bridge carries the tree (``encoder``,
    ``head``) strict into the port's."""
    jdt, tdt = DTYPES[tag]
    cfg = dict(n_cls=7, image_size=32, patch_size=16, d_model=64, n_layers=2)
    jm = jvit.ViTClassifier(dtype=jdt, **cfg)
    x0 = jnp.zeros((1, 32, 32, 3))
    shapes = jax.eval_shape(lambda: jm.init({"params": jax.random.PRNGKey(0)}, x0))
    v = jax.tree.map(lambda a: np.asarray(a, np.float32),
                     numpy_leaves(dict(shapes), np.random.default_rng(3)))
    port = load_jax_variables(ViTClassifier(dtype=tdt, **cfg), v)
    assert port.encoder.blocks[0].attn.heads == 1 and port.head.weight.shape == (7, 64)
    x = np.random.default_rng(4).standard_normal((3, 32, 48, 3)).astype(np.float32)
    ref = np.asarray(jnp.asarray(jm.apply(v, jnp.asarray(x)), jnp.float32))
    with torch.no_grad():
        ours = port(torch.from_numpy(x)).float().numpy()
    assert ours.shape == ref.shape == (3, 7)
    bound = NET_SHARE if tag == "f32" else 24 * BF16_ULP
    assert np.abs(ours - ref).max() <= bound * np.abs(ref).max()


def test_attention_maps_and_head_maps_match_jax(pair):
    jm, v, port, _ = pair
    x = np.random.default_rng(5).standard_normal((1, 64, 96, 3)).astype(np.float32)
    ref = jattn.attention_maps(jm, v, jnp.asarray(x))
    ours = attn.attention_maps(port, torch.from_numpy(x))
    assert [len(ours[k]) for k in ("encoder", "decoder")] == [2, 2]
    for part in ("encoder", "decoder"):
        for a, b in zip(ours[part], ref[part]):
            assert a.shape == b.shape and a.dtype == np.float32
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)
    assert ours["encoder"][0].shape == (1, 2, 7, 7) and ours["decoder"][1].shape == (1, 2, 11, 11)
    for kw in (dict(query="cls"), dict(query="patch", xy_patch=(2, 1)),
               dict(query="cls", n_cls=5, is_decoder=True),
               dict(query="patch", xy_patch=(1, 0), n_cls=5, is_decoder=True)):
        part = "decoder" if kw.get("is_decoder") else "encoder"
        got = attn.head_maps(ours[part][1], (2, 3), 32, **kw)
        want = jattn.head_maps(ref[part][1], (2, 3), 32, **kw)
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
        np.testing.assert_array_equal(attn.head_maps(ref[part][1], (2, 3), 32, **kw), want)


def test_attention_capture_is_off_by_default(pair):
    """After attention_maps, and in any plain forward, no Attention keeps a
    tensor or has capture on."""
    _, _, port, _ = pair
    mods = [m for m in port.modules() if isinstance(m, Attention)]
    with torch.no_grad():
        port(torch.zeros(1, 64, 64, 3))
    attn.attention_maps(port, torch.zeros(1, 64, 64, 3))
    assert mods and all(not m.keep_attn and m.attn_map is None for m in mods)


@pytest.mark.parametrize("case", [dict(window=64, stride=48, ori=(80, 130), flip=False),
                                  dict(window=64, stride=48, ori=None, flip=True),
                                  dict(window=64, stride=100, ori=(96, 160), flip=True)],
                         ids=["resized", "flip", "stride_beyond_window"])
def test_sliding_inference_matches_jax(pair, case):
    jm, v, port, fwd = pair
    im = np.random.default_rng(6).standard_normal((96, 160, 3)).astype(np.float32)
    ref = jinf.sliding_inference(fwd, v, im, 5, case["window"], case["stride"],
                                 ori_shape=case["ori"], flip=case["flip"])
    ours = inference.sliding_inference(port, im, 5, case["window"], case["stride"],
                                       ori_shape=case["ori"], flip=case["flip"]).numpy()
    assert ours.shape == ref.shape and np.isfinite(ours).all()
    np.testing.assert_allclose(ours, ref, rtol=0, atol=PROB_ATOL)
    np.testing.assert_array_equal(ours.argmax(-1), ref.argmax(-1))


def test_window_anchors_equal_jax():
    for length, window, stride in ((96, 64, 48), (160, 64, 48), (64, 64, 48), (513, 512, 480),
                                   (1000, 64, 7)):
        assert inference.window_anchors(length, window, stride) == jinf.window_anchors(
            length, window, stride)


def test_evaluate_dataset_matches_jax(pair, tmp_path):
    """The mmseg-protocol evaluation of a 2-image ADE20K-layout folder (the
    eval pipeline resizes the 72x100 and 50x90 frames, the labels stay) on
    the same weights: the summary equal."""
    jm, v, port, fwd = pair
    rng = np.random.default_rng(7)
    for d in ("img", "ann"):
        (tmp_path / d).mkdir()
    for i, (h, w) in enumerate(((72, 100), (50, 90))):
        write_jpeg(str(tmp_path / "img" / f"{i}.jpg"), rng.integers(0, 256, (h, w, 3), np.uint8))
        lab = np.kron(rng.integers(0, 6, (4, 5)), np.ones((h // 4 + 1, w // 5 + 1)))[:h, :w]
        write_png(str(tmp_path / "ann" / f"{i}.png"), lab.astype(np.uint8))
    args = (str(tmp_path / "img"), str(tmp_path / "ann"))
    ours = inference.evaluate_dataset(
        port, data.SegFolderDataset(*args, transform=data.build_eval_pipeline(64),
                                    reduce_zero_label=True), 5, 64, 48)
    ref = jinf.evaluate_dataset(
        fwd, v, jdata.SegFolderDataset(*args, transform=jdata.build_eval_pipeline(64),
                                       reduce_zero_label=True), 5, 64, 48)
    assert ours.keys() == ref.keys()
    for k in ("miou", "macc", "allacc"):
        assert ours[k] == ref[k], k
    np.testing.assert_array_equal(ours["iou_class"], ref["iou_class"])
    np.testing.assert_array_equal(ours["acc_class"], ref["acc_class"])
