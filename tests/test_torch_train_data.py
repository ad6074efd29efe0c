"""The training slice's host data path and ``run_flow_fit`` against the JAX
package's, on the CPU.

The port reproduces cv2's arithmetic without cv2 (the machine with the
card has none): ``cv2_resize_linear`` (uint8 fixed point and float32),
``cv2_resize_nearest`` and ``cv2_gaussian_blur_5`` are held to cv2 itself,
the train and val transforms to the JAX package's on FlowDataset items of
one synthetic tree with the same generators (frames within 1 grey level,
labels and grids equal; they come out equal), and ``run_flow_fit`` to a
JAX wiring of ``Runner.fit``'s flow_supervised loop: one epoch of two steps
and a validation pass, PSPNet-50 at 33 px crops in float64 (JAX under
``jax.enable_x64``), dropout 0 and OHEM's min_kept above the pixel count
(so no pixel selection can flip): the epoch's mean loss within rtol 1e-5
and the validation counts equal.
"""

import copy

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from floodseg_tpu.data import transforms as jax_tf
from floodseg_tpu.data.dataset import FlowDataset as JaxFlowDataset
from floodseg_tpu.data.loader import DataLoader as JaxLoader
from floodseg_tpu.data.synthetic import generate_synthetic_dataset as jax_generate
from floodseg_tpu.models.pspnet import PSPNet as JaxPSPNet
from floodseg_tpu.ops.metrics import MetricMeter as JaxMeter
from floodseg_tpu.train import flow as jflow
from floodseg_tpu.train.optim import make_optimizer as jax_make_optimizer
from floodseg_tpu.train.state import TrainState as JaxTrainState
from floodseg_tpu.train.supervised import make_loss_fn as jax_make_loss_fn

from floodseg_tpu_torch.data import FlowDataset, transforms
from floodseg_tpu_torch.models import PSPNet
from floodseg_tpu_torch.train import default_fit_config, flow_transforms, run_flow_fit

from torch_port_fixtures import _perturb_bn, _to_dict, port_state
from torch_port_fixtures import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

N = 5
SIZE = (96, 128)
CROP = 33


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """The JAX package's synthetic tree: 30 frames, 8 labeled (6 train,
    1 val, 1 test)."""
    root = str(tmp_path_factory.mktemp("train_tree"))
    return jax_generate(root, num_frames=30, size=SIZE, frame_delta=N, num_labeled=8)


def _frame(seed, shape):
    """A smooth uint8 frame with noise (the synthetic frames' character)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:shape[0], 0:shape[1]]
    base = 120 + 60 * np.sin(xx * 0.13)[..., None] * np.cos(yy * 0.07)[..., None]
    return np.clip(base + rng.normal(0, 20, shape + (3,)), 0, 255).astype(np.uint8)


# ------------------------------------------------------------- cv2's arithmetic

@pytest.mark.parametrize("scale", [0.5371, 0.73, 1.0, 1.234567, 1.9, 2.0])
def test_cv2_resize_linear_matches_cv2_uint8(scale):
    """uint8 frames by a scale factor (cv2.resize(None, fx, fy)): equal."""
    im = _frame(1, (107, 193))
    ref = cv2.resize(im, None, fx=scale, fy=scale, interpolation=cv2.INTER_LINEAR)
    ours = transforms.cv2_resize_linear(im, ref.shape[:2], (scale, scale))
    np.testing.assert_array_equal(ours, ref)


@pytest.mark.parametrize("out_hw", [(27, 27), (40, 13), (5, 9)])
def test_cv2_resize_linear_matches_cv2_float32(out_hw):
    """float32 arrays (grids) to a size: equal."""
    m = np.random.default_rng(2).uniform(-1.3, 1.3, (18, 19, 2)).astype(np.float32)
    ref = cv2.resize(m, out_hw[::-1], interpolation=cv2.INTER_LINEAR)
    np.testing.assert_array_equal(transforms.cv2_resize_linear(m, out_hw), ref)


def test_cv2_resize_linear_window_is_the_full_resize_cut():
    im = _frame(3, (61, 83))
    full = transforms.cv2_resize_linear(im, (97, 130), (1.59, 1.57))
    rows, cols = np.array([0, 5, 5, 96, 40]), np.array([129, 0, 7, 8])
    np.testing.assert_array_equal(
        transforms.cv2_resize_linear(im, (97, 130), (1.59, 1.57), rows=rows, cols=cols),
        full[rows][:, cols])


@pytest.mark.parametrize("scale", [0.61, 1.3, 1.97])
def test_cv2_resize_nearest_matches_cv2(scale):
    lab = np.random.default_rng(4).integers(0, 6, (50, 71)).astype(np.uint8)
    ref = cv2.resize(lab, None, fx=scale, fy=scale, interpolation=cv2.INTER_NEAREST)
    np.testing.assert_array_equal(transforms.cv2_resize_nearest(lab, ref.shape, (scale, scale)),
                                  ref)


@pytest.mark.parametrize("shape", [(37, 52), (3, 5)])
def test_cv2_gaussian_blur_matches_cv2(shape):
    """uint8 frames equal (cv2's fixed point), also where the reflected
    border reaches across the whole frame; other dtypes raise."""
    im = _frame(5, shape)
    np.testing.assert_array_equal(transforms.cv2_gaussian_blur_5(im),
                                  cv2.GaussianBlur(im, (5, 5), 0))
    with pytest.raises(TypeError, match="uint8"):
        transforms.cv2_gaussian_blur_5(im.astype(np.float32))


# ------------------------------------------------------------- the transforms

def _compare(ours, ref):
    assert set(ours) == set(ref)
    for k, v in ref.items():
        if k in ("mvs_left", "mvs_right"):
            assert len(ours[k]) == len(v)
            for a, b in zip(ours[k], v):
                np.testing.assert_array_equal(a, b, err_msg=k)
        elif k.startswith("frame_"):
            d = np.abs(np.asarray(ours[k], np.float64) - np.asarray(v, np.float64)).max()
            assert ours[k].shape == v.shape and d <= 1.0, (k, d)
        else:
            np.testing.assert_array_equal(np.asarray(ours[k]), np.asarray(v), err_msg=k)


@pytest.mark.parametrize("item", [0, 1, 2, 3, 4, 5])
def test_train_transform_matches_jax(tree, item):
    """The flow train pipeline (ignore class 5, resize, random scale 0.5-2,
    blur, flip, 33 px random crop, float32 without normalising) on a train
    item with the loader's generator for it: frames within 1 grey level,
    labels, grids and the chain lengths equal."""
    args = dict(classes_ignore=[5], scale_min=0.5, scale_max=2.0, resize=SIZE,
                with_rotate=False, crop_padding=None, normalize=False)
    lst = f"{tree}/list/all/train.txt"
    ref = JaxFlowDataset("train", tree, lst, type="l", frame_delta=N,
                         transform=jax_tf.build_train_transform(CROP, CROP, **args))
    ours = FlowDataset("train", tree, lst, type="l", frame_delta=N,
                       transform=transforms.build_train_transform(CROP, CROP, **args))
    _compare(ours.get(item, np.random.default_rng((7, 0, item))),
             ref.get(item, np.random.default_rng((7, 0, item))))


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_train_crop_pads_as_jax(seed):
    """A scaled frame smaller than the crop is padded with the mean (frames,
    rounded to uint8) and the ignore label, as cv2.copyMakeBorder pads it."""
    rng = np.random.default_rng(seed)
    sample = {"frame_prev": _frame(seed, (40, 44)), "frame_next": _frame(seed + 9, (40, 44)),
              "label": rng.integers(0, 5, (40, 44)).astype(np.uint8),
              "mvs_left": [rng.uniform(-1, 1, (2, 2, 2)).astype(np.float32) for _ in range(3)]}
    args = dict(scale_min=0.7, scale_max=1.2, resize=(40, 44), with_rotate=False,
                normalize=False)
    ref = jax_tf.build_train_transform(49, 49, **args)(copy.deepcopy(sample),
                                                       np.random.default_rng(seed))
    ours = transforms.build_train_transform(49, 49, **args)(copy.deepcopy(sample),
                                                            np.random.default_rng(seed))
    _compare(ours, ref)


@pytest.mark.parametrize("name", ["RandScale", "RandomGaussianBlur", "RandomHorizontalFlip",
                                  "Crop-rand", "Crop-center"])
def test_single_train_transforms_match_jax(name):
    """Each train transform on its own, with one generator: equal to the
    JAX transform (frames within 1 grey level, labels and grids equal)."""
    rng = np.random.default_rng(11)
    sample = {"frame_prev": _frame(12, (64, 80)), "frame_next": _frame(13, (64, 80)),
              "label": rng.integers(0, 5, (64, 80)).astype(np.uint8),
              "mvs_left": [rng.uniform(-1, 1, (4, 5, 2)).astype(np.float32) for _ in range(3)]}
    args = {"RandScale": ([0.6, 1.7],), "RandomGaussianBlur": (), "RandomHorizontalFlip": (),
            "Crop-rand": ([33, 49], "rand"), "Crop-center": ([33, 49], "center")}[name]
    cls = name.split("-")[0]
    for seed in range(4):
        ref = getattr(jax_tf, cls)(*args)(copy.deepcopy(sample), np.random.default_rng(seed))
        ours = getattr(transforms, cls)(*args)(copy.deepcopy(sample),
                                               np.random.default_rng(seed))
        _compare(ours, ref)


@pytest.mark.parametrize("item", [0])
def test_val_transform_matches_jax(tree, item):
    lst = f"{tree}/list/all/val.txt"
    ref = JaxFlowDataset("val", tree, lst, type="l", frame_delta=N,
                         transform=jax_tf.build_val_transform(CROP, CROP, [5], SIZE,
                                                              crop_padding=None))
    ours = FlowDataset("val", tree, lst, type="l", frame_delta=N,
                       transform=transforms.build_val_transform(CROP, CROP, [5], SIZE,
                                                                crop_padding=None))
    _compare(ours.get(item, np.random.default_rng(0)), ref.get(item, np.random.default_rng(0)))


def test_flow_transforms_sizing_rules():
    """Runner._transforms' flow rules: no_cropping resizes the train frames
    to 1.5x the crop + 1 and val to the crop; resize_factor pins scale_min
    to 1."""
    tf = flow_transforms(default_fit_config(train_h=33, train_w=65, no_cropping=True))
    resize = next(t for t in tf["train"].transforms if isinstance(t, transforms.Resize))
    scale = next(t for t in tf["train"].transforms
                 if isinstance(t, transforms.ScaleBlurFlipCrop)).scale.scale
    assert resize.size == (50, 98) and scale == [1 / 1.5 + 0.001, 1.0]
    assert not any(isinstance(t, transforms.Crop) for t in tf["val"].transforms)
    tf = flow_transforms(default_fit_config(resize_factor=0.5))
    resize = next(t for t in tf["train"].transforms if isinstance(t, transforms.Resize))
    scale = next(t for t in tf["train"].transforms
                 if isinstance(t, transforms.ScaleBlurFlipCrop)).scale.scale
    assert resize.size == (536, 960) and scale == [1.0, 2.0]


# ---------------------------------------------------------------- run_flow_fit

FIT = default_fit_config(train_h=CROP, train_w=CROP, resize_h=SIZE[0], resize_w=SIZE[1],
                         frame_delta=N, workers=2, max_epochs=1, limit_train_batches=2, lr=1e-3,
                         seed=42)


def _jax_fit(tree, variables, cfg):
    """Runner.fit's flow_supervised loop on one device (no logger, no
    checkpoints): the same transforms, loaders, optimizer, steps, coin and
    step keys, validation through the eval step."""
    jm = JaxPSPNet(classes=5, layers=50, dropout=0.0, with_aux=True, dtype=jnp.float64)
    train = jax_tf.build_train_transform(cfg.train_h, cfg.train_w, [5], cfg.scale_min,
                                         cfg.scale_max, (cfg.resize_h, cfg.resize_w),
                                         with_rotate=False, crop_padding=None)
    val = jax_tf.build_val_transform(cfg.train_h, cfg.train_w, [5], (cfg.resize_h, cfg.resize_w),
                                     crop=True, crop_padding=None)
    ds = JaxFlowDataset("train", tree, f"{tree}/list/all/train.txt", type="l", transform=train,
                        frame_delta=cfg.frame_delta)
    loader = JaxLoader(ds, batch_size=cfg.batch_size, shuffle=True, num_workers=cfg.workers,
                       seed=cfg.seed, infinite=True, drop_last=True)
    vds = JaxFlowDataset("val", tree, f"{tree}/list/all/val.txt", type="l", transform=val,
                         frame_delta=cfg.frame_delta)
    vloader = JaxLoader(vds, batch_size=cfg.batch_size_val, num_workers=cfg.workers,
                        seed=cfg.seed)
    steps = min(len(ds) // cfg.batch_size, cfg.limit_train_batches)
    tx = jax_make_optimizer(cfg.lr, steps * cfg.max_epochs, "sgd", cfg.momentum,
                            cfg.weight_decay, power=cfg.power)
    params = jax.tree.map(jnp.asarray, variables["params"])
    state = JaxTrainState(step=jnp.zeros((), jnp.int32), params=params,
                          batch_stats=jax.tree.map(jnp.asarray, variables["batch_stats"]),
                          opt_state=tx.init(params), tx=tx)
    loss_fn = jax_make_loss_fn("ohem", 0.0, 255, cfg.ohem_thresh, cfg.ohem_min_kept)
    interp, _ = jflow.make_flow_train_step(jm, loss_fn, 5, 255)
    interp = jax.jit(interp)
    ev = jax.jit(jflow.make_flow_eval_step(jm, 5, 255))
    rng = jax.random.PRNGKey(cfg.seed)
    it = iter(loader)
    losses = []
    for step in range(steps):
        batch = {k: jnp.asarray(v) for k, v in next(it).items()}
        state, m = interp(state, batch, jax.random.fold_in(rng, step))
        losses.append(float(m["loss"]))
    meter = JaxMeter(5)
    for vb in vloader:
        m = ev(state, {k: jnp.asarray(v) for k, v in vb.items()})
        meter.update(m["intersection"], m["union"], m["target"])
    return float(np.mean(losses)), meter, steps


@pytest.fixture(scope="module")
def fits(tree):
    key = jax.random.PRNGKey(0)
    with jax.enable_x64(True):
        jm = JaxPSPNet(classes=5, layers=50, dropout=0.0, with_aux=True, dtype=jnp.float64)
        v = _to_dict(jax.device_get(jax.jit(lambda: jm.init(
            {"params": key, "dropout": key}, jnp.zeros((2, CROP, CROP, 3)), train=True))()))
        _perturb_bn(v["params"], v["batch_stats"], np.random.default_rng(31))
        v = jax.tree.map(lambda a: np.asarray(a, np.float64), v)
        ref = _jax_fit(tree, v, FIT)
    port = PSPNet(classes=5, layers=50, dropout=0.0, with_aux=True, dtype=torch.float64).double()
    port.load_state_dict(port_state(v))
    ours = run_flow_fit(port, tree, FIT, device="cpu")
    return ref, ours


def test_run_flow_fit_loss_matches_jax(fits):
    (ref_loss, _, steps), ours = fits
    assert ours["steps"] == steps == 2 and len(ours["epochs"]) == 1
    assert ours["epochs"][0]["train_loss"] == pytest.approx(ref_loss, rel=1e-5)


def test_run_flow_fit_validation_matches_jax(fits):
    (_, ref_meter, _), ours = fits
    counts = ours["epochs"][0]["val_counts"]
    for k in ("intersection", "union", "target"):
        np.testing.assert_array_equal(counts[k], getattr(ref_meter, k), err_msg=k)
    assert ours["epochs"][0]["val_miou"] == pytest.approx(ref_meter.summary()["miou"], rel=1e-12)
    assert ours["best_epoch"] == 0 and ours["state"].step == 2
