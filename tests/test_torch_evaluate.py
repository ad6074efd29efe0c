"""The port's test path (train/evaluate.py, ``run_test``) against the JAX
package's, on the CPU.

PSPNet-50 (49 px crops, its 8k + 1 rule) only for the crop forward with
the flip; the narrow ViT/32 (tests/torch_port_fixtures.py::vit_pair, 64 px
crops) for everything else: a synthetic tree of 64x96 frames, n = 5, both
held-out lists (test.txt with 2 items, test2.txt with 1).

Tolerances: probabilities within 1e-4 in float32 (the network's parity
bound); class maps equal wherever the top-2 gap of the averaged
probabilities exceeds twice that, at least 99% of pixels clear; cv2's
float32 resize to the bit. ``run_test``: the same keys, maps agreeing on
at least 99.9% of pixels (the whole-frame route: each class's counts
within 0.1% of the pixels), and the metrics equal whenever every map (or
count) is equal.
"""

import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from floodseg_tpu.cli.runner import Runner, _EvalState, _iter_single_samples
from floodseg_tpu.core.config import load_config
from floodseg_tpu.data import DataLoader as JaxLoader
from floodseg_tpu.data import FlowDataset as JaxFlowDataset
from floodseg_tpu.data import SemDataset as JaxSemDataset
from floodseg_tpu.data.synthetic import generate_synthetic_dataset as jax_generate
from floodseg_tpu.data.transforms import Normalize as JaxNormalize
from floodseg_tpu.data.transforms import Resize as JaxResize
from floodseg_tpu.ops import metrics as jax_metrics
from floodseg_tpu.train import evaluate as jax_evaluate
from floodseg_tpu.train import flow as jax_flow

from floodseg_tpu_torch.data import FlowDataset, collate
from floodseg_tpu_torch.data.transforms import Normalize, Resize
from floodseg_tpu_torch.ops import launch_counts, reset_launch_counts
from floodseg_tpu_torch.ops.cv2_compat import cv2_resize_linear
from floodseg_tpu_torch.train import (
    FitConfig,
    fit,
    flow_sliding_window_test,
    flow_transforms,
    make_crop_forward,
    make_flow_test_crop_fn,
    multi_scale_test,
    run_test,
    sem_transforms,
    sliding_window_predict,
)

from torch_port_fixtures import pspnet50_pair, vit_pair

N = 5
SIZE = (64, 96)
CROP = 64
CLASSES = 5
TOL = 1e-4


@pytest.fixture(scope="module")
def vit():
    return vit_pair(size=CROP)


@pytest.fixture(scope="module")
def psp():
    """PSPNet-50 (its weights drawn in the init's shapes, no compiled init)
    and the JAX crop forward with the flip."""
    jm, variables, port = pspnet50_pair(size=65, compiled_init=False)
    return jm, variables, port, jax_evaluate.make_crop_forward(jm, CLASSES, flip=True)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """24 frames, 12 labeled: test.txt has 2 items, test2.txt 1."""
    root = str(tmp_path_factory.mktemp("test_tree"))
    return jax_generate(root, num_frames=24, size=SIZE, frame_delta=N, num_labeled=12)


def _image(shape, seed):
    return np.random.default_rng(seed).uniform(0, 255, shape).astype(np.float32)


def _clear(probs):
    """Pixels whose top-2 probability gap exceeds twice the tolerance."""
    top2 = np.sort(probs, axis=-1)[..., -2:]
    return (top2[..., 1] - top2[..., 0]) > 2 * TOL


# ------------------------------------------------------------ crop forward

@pytest.mark.parametrize("arch,flip", [("pspnet", True), ("vit", False), ("vit", True)],
                         ids=["pspnet-flip", "vit-plain", "vit-flip"])
def test_crop_forward_matches_jax(request, arch, flip):
    """make_crop_forward's (N, ch, cw, C) probabilities from raw crops;
    PSPNet-50 with the flip only (the ViT covers both modes)."""
    if arch == "pspnet":
        jm, variables, port, jfn = request.getfixturevalue("psp")
        crop = 49
    else:
        jm, variables, port = request.getfixturevalue("vit")
        jfn, crop = jax_evaluate.make_crop_forward(jm, CLASSES, flip=flip), CROP
    crops = _image((2, crop, crop, 3), seed=1)
    ref = np.asarray(jfn(variables, jnp.asarray(crops)))
    ours = make_crop_forward(port, CLASSES, flip=flip, device="cpu")(port.state_dict(), crops)
    assert ours.dtype == torch.float32 and ours.shape == ref.shape == (2, crop, crop, CLASSES)
    np.testing.assert_allclose(ours.numpy(), ref, rtol=0, atol=TOL)


# ------------------------------------------------------------ sliding window

@pytest.mark.parametrize("shape,out", [((40, 50), (40, 50)), ((80, 120), (64, 96))],
                         ids=["padded", "larger_resized"])
def test_sliding_window_predict_matches_jax(vit, shape, out):
    """An image smaller than the crop (MEAN padding) and one larger, its
    map resized: probabilities within 1e-4."""
    jm, variables, port = vit
    image = _image(shape + (3,), seed=2)
    ref = jax_evaluate.sliding_window_predict(
        jax_evaluate.make_crop_forward(jm, CLASSES), variables, image, CLASSES, CROP, CROP,
        *out)
    ours = sliding_window_predict(make_crop_forward(port, CLASSES, device="cpu"),
                                  port.state_dict(), image, CLASSES, CROP, CROP, *out)
    assert ours.dtype == np.float32 and ours.shape == ref.shape == out + (CLASSES,)
    np.testing.assert_allclose(ours, ref, rtol=0, atol=TOL)


def test_multi_scale_test_matches_jax(vit):
    """Two scales (0.75 pads the scaled image, 1.0 slides) over base 96:
    maps equal away from near-ties of the averaged probabilities."""
    import cv2

    jm, variables, port = vit
    image = _image(SIZE + (3,), seed=3)
    scales, base = (0.75, 1.0), 96
    jfn = jax_evaluate.make_crop_forward(jm, CLASSES)
    ref = jax_evaluate.multi_scale_test(jfn, variables, image, CLASSES, CROP, CROP, scales, base)
    ours = multi_scale_test(make_crop_forward(port, CLASSES, device="cpu"), port.state_dict(),
                            image, CLASSES, CROP, CROP, scales, base)
    assert ours.shape == ref.shape == SIZE
    acc = np.zeros(SIZE + (CLASSES,))
    for scale in scales:
        long_size = round(scale * base)
        hw = (round(long_size / SIZE[1] * SIZE[0]), long_size)
        scaled = cv2.resize(image, hw[::-1], interpolation=cv2.INTER_LINEAR)
        acc += jax_evaluate.sliding_window_predict(jfn, variables, scaled, CLASSES, CROP, CROP,
                                                   *SIZE)
    clear = _clear(acc / len(scales))
    assert clear.mean() > 0.99
    np.testing.assert_array_equal(ours[clear], np.asarray(ref)[clear])


@pytest.mark.parametrize("channels", [3, 5])
@pytest.mark.parametrize("shape,out", [((40, 50), (64, 96)), ((97, 130), (64, 96)),
                                       ((64, 96), (48, 72))])
def test_cv2_resize_linear_float32_matches_cv2(channels, shape, out):
    """The test's float32 resizes: the 3-channel image to a scale and the
    5-channel canvas to the output, equal to cv2.resize(INTER_LINEAR) to
    the bit."""
    cv2 = pytest.importorskip("cv2")
    im = np.random.default_rng(4).uniform(0, 255, shape + (channels,)).astype(np.float32)
    ref = cv2.resize(im, out[::-1], interpolation=cv2.INTER_LINEAR)
    ours = cv2_resize_linear(im, out)
    assert ours.dtype == np.float32
    np.testing.assert_array_equal(ours.view(np.int32), ref.view(np.int32))


# ------------------------------------------------------------ flow test

def test_flow_test_crop_fn_matches_jax(vit, tree):
    """make_flow_test_crop_fn's probabilities on the first test sample's
    crops within 1e-4, and flow_sliding_window_test's map equal to JAX's
    away from near-ties; no kernel launch on the CPU."""
    jm, variables, port = vit
    cfg = FitConfig(train_h=CROP, train_w=CROP, resize_h=SIZE[0], resize_w=SIZE[1],
                    frame_delta=N)
    ds = FlowDataset("test", tree, os.path.join(tree, "list", "all", "test.txt"),
                     transform=flow_transforms(cfg, "vit")["test"], frame_delta=N)
    batch = collate([ds.get(0, np.random.default_rng(0))])
    jfn = jax_flow.make_flow_test_crop_fn(jm, CLASSES)
    seen = {}

    def recording(*args):
        seen["probs"] = np.asarray(jfn(*args))
        return seen["probs"]

    ref = jax_evaluate.flow_sliding_window_test(recording, variables, batch, CLASSES, CROP,
                                                CROP)
    reset_launch_counts()
    fn = make_flow_test_crop_fn(port, CLASSES, device="cpu")
    got = {}

    def port_recording(*args):
        got["probs"] = fn(*args)
        return got["probs"]

    ours = flow_sliding_window_test(port_recording, port.state_dict(), batch, CLASSES, CROP,
                                    CROP)
    assert set(launch_counts().values()) == {0}
    assert got["probs"].dtype == torch.float32
    assert got["probs"].shape == seen["probs"].shape == (2, CROP, CROP, CLASSES)
    np.testing.assert_allclose(got["probs"].numpy(), seen["probs"], rtol=0, atol=TOL)
    offs = jax_evaluate.crop_offsets(*SIZE, CROP, CROP)
    canvas, count = np.zeros(SIZE + (CLASSES,)), np.zeros(SIZE + (1,))
    for (h, w), p in zip(offs, seen["probs"]):
        canvas[h:h + CROP, w:w + CROP] += p
        count[h:h + CROP, w:w + CROP] += 1
    clear = _clear(canvas / count)
    assert ours.shape == ref.shape == SIZE and clear.mean() > 0.99
    np.testing.assert_array_equal(ours[clear], np.asarray(ref)[clear])


# ------------------------------------------------------------ transforms

def _jax_config(cfg: FitConfig, method: str, arch: str):
    """The JAX package's linked config for the settings in ``cfg``."""
    return load_config([], {
        "method": method, "model.arch": arch, "model.no_cropping": cfg.no_cropping,
        "data.train_h": cfg.train_h, "data.train_w": cfg.train_w,
        "data.resize_h": cfg.resize_h, "data.resize_w": cfg.resize_w,
        "data.resize_factor": cfg.resize_factor,
        "data.resize_factor_test": cfg.resize_factor_test,
        "data.data_classes_ignore": list(cfg.classes_ignore),
        "data.frame_delta": cfg.frame_delta, "data.batch_size_test": cfg.batch_size_test,
        "data.workers_test": cfg.workers_test, "trainer.seed": cfg.seed,
        "trainer.limit_test_batches": cfg.limit_test_batches})


def _jax_test_transform(cfg: FitConfig, method: str, arch: str):
    jcfg = _jax_config(cfg, method, arch)
    return Runner._transforms(SimpleNamespace(cfg=jcfg, is_flow=method != "supervised"))["test"]


@pytest.mark.parametrize("method,arch,no_cropping,train,factor,expect", [
    ("flow_supervised", "pspnet", False, 433, 1.0, (1072, 1920)),
    ("flow_supervised", "pspnet", True, 433, 1.0, (433, 650)),
    ("flow_supervised", "pspnet", False, 433, 0.5, (536, 960)),
    ("flow_supervised", "vit", False, 433, 0.3, (320, 576)),
    ("flow_supervised", "vit", True, 433, 1.0, (416, 608)),
    ("supervised", "pspnet", False, 873, 1.0, (1072, 1920)),
], ids=["flow_crop", "flow_no_cropping", "flow_factor", "vit_crop", "vit_no_cropping",
        "supervised"])
def test_test_transforms_match_runner(method, arch, no_cropping, train, factor, expect):
    """The "test" transform's resize and normalisation, and the test crop,
    as Runner._transforms and apply_links give them."""
    cfg = FitConfig(train_h=train, train_w=train, no_cropping=no_cropping,
                    resize_factor_test=factor)
    ours = (sem_transforms if method == "supervised" else flow_transforms)(cfg, arch)["test"]
    ref = _jax_test_transform(cfg, method, arch)
    sizes = [t.size for t in ours.transforms if isinstance(t, Resize)]
    assert sizes == [t.size for t in ref.transforms if isinstance(t, JaxResize)] == [expect]
    assert (any(isinstance(t, Normalize) for t in ours.transforms)
            == any(isinstance(t, JaxNormalize) for t in ref.transforms)
            == (method != "supervised"))
    jcfg = _jax_config(cfg, method, arch)
    assert fit._test_crop(cfg, arch) == (jcfg.model.test_h, jcfg.model.test_w)


# ------------------------------------------------------------ run_test

def _jax_runner_test(jm, variables, root, cfg: FitConfig, method: str, record: list):
    """The JAX package's Runner.test wiring (floodseg_tpu/cli/runner.py)
    on one device for the ViT; each sample's map (or each whole-frame
    batch's counts) is appended to ``record``."""
    jcfg = _jax_config(cfg, method, "vit")
    if jcfg.trainer.limit_test_batches == 0:
        return {}
    flow = method != "supervised"
    tf = _jax_test_transform(cfg, method, "vit")
    crop_fn = jax_flow.make_flow_test_crop_fn(jm, CLASSES)
    eval_whole = jax.jit(jax_flow.make_flow_eval_step(jm, CLASSES, 255))
    crop_forward = jax_evaluate.make_crop_forward(jm, CLASSES)
    results = {}
    for idx, name in enumerate(["test.txt", "test2.txt"]):
        path = os.path.join(root, "list", "all", name)
        ds = (JaxFlowDataset("test", root, path, type="l", transform=tf, frame_delta=N)
              if flow else JaxSemDataset("val", root, path, tf))
        loader = JaxLoader(ds, jcfg.data.batch_size_test, num_workers=jcfg.data.workers_test,
                           seed=jcfg.trainer.seed)
        meter = jax_metrics.MetricMeter(CLASSES)
        for bi, batch in enumerate(loader):
            if jcfg.trainer.limit_test_batches is not None \
                    and bi >= jcfg.trainer.limit_test_batches:
                break
            if flow and jcfg.model.no_cropping:
                m = eval_whole(_EvalState(variables["params"], {}),
                               {k: jnp.asarray(v) for k, v in batch.items()})
                record.append([np.asarray(m[k]) for k in ("intersection", "union", "target")])
                meter.update(m["intersection"], m["union"], m["target"])
                continue
            for sub in _iter_single_samples(batch):
                if flow:
                    pred = jax_evaluate.flow_sliding_window_test(
                        crop_fn, variables, sub, CLASSES, jcfg.model.test_h, jcfg.model.test_w)
                else:
                    pred = jax_evaluate.multi_scale_test(
                        crop_forward, variables, np.asarray(sub["frame_current"])[0], CLASSES,
                        jcfg.model.test_h, jcfg.model.test_w, scales=cfg.test_scales,
                        base_size=cfg.test_base_size)
                record.append(np.asarray(pred))
                meter.update(*jax_metrics.intersection_and_union(
                    jnp.asarray(pred), jnp.asarray(sub["label"])[0], CLASSES, 255))
        s = meter.summary()
        results[f"test_miou{idx + 1}_epoch"] = s["miou"]
        results[f"test_macc{idx + 1}_epoch"] = s["macc"]
        results[f"test_accuracy{idx + 1}_epoch"] = s["allacc"]
        results[f"test_miou{idx + 1}_epoch_classes"] = s["iou_class"]
    if "test_miou2_epoch" in results:
        results["test_miou_epoch"] = (results["test_miou1_epoch"]
                                      + results["test_miou2_epoch"]) / 2
    return results


def _recording_run_test(monkeypatch, port, tree, cfg, method, record):
    """run_test with each sample's map (or each whole-frame batch's counts)
    appended to ``record``."""
    for name in ("flow_sliding_window_test", "multi_scale_test"):
        orig = getattr(fit, name)

        def wrapped(*args, _orig=orig, **kw):
            record.append(_orig(*args, **kw))
            return record[-1]

        monkeypatch.setattr(fit, name, wrapped)
    orig_step = fit.make_flow_eval_step

    def make_step(*args, **kw):
        step = orig_step(*args, **kw)

        def recorded(state, batch):
            m = step(state, batch)
            record.append([m[k].numpy() for k in ("intersection", "union", "target")])
            return m

        return recorded

    monkeypatch.setattr(fit, "make_flow_eval_step", make_step)
    return run_test(port, tree, cfg, method, device="cpu")


@pytest.mark.parametrize("method,no_cropping,limit", [
    ("flow_supervised", False, None), ("flow_supervised", True, None),
    ("supervised", False, None), ("flow_supervised", False, 1)],
    ids=["flow_crop_route", "flow_no_cropping", "supervised", "limit_1"])
def test_run_test_matches_jax_runner(vit, tree, monkeypatch, method, no_cropping, limit):
    """run_test against the JAX wiring of Runner.test over both lists (so
    test_miou_epoch too): the same keys and number of samples, the maps
    (or whole-frame counts) in agreement, the metrics equal when they are
    equal. The single-frame case runs two scales over base 96."""
    jm, variables, port = vit
    cfg = FitConfig(train_h=CROP, train_w=CROP, resize_h=SIZE[0], resize_w=SIZE[1],
                    frame_delta=N, no_cropping=no_cropping, workers_test=2,
                    limit_test_batches=limit, test_scales=(0.75, 1.0), test_base_size=96)
    ref_rec, our_rec = [], []
    ref = _jax_runner_test(jm, variables, tree, cfg, method, ref_rec)
    ours = _recording_run_test(monkeypatch, port, tree, cfg, method, our_rec)
    assert sorted(ours) == sorted(ref)
    assert "test_miou_epoch" in ours and "test_miou2_epoch_classes" in ours
    assert len(our_rec) == len(ref_rec) == (2 if limit == 1 else 3)
    equal = True
    for a, b in zip(our_rec, ref_rec):
        if no_cropping:
            pixels = float(np.sum(b[2]))
            for x, y in zip(a, b):
                assert np.abs(np.asarray(x, np.float64) - y).max() <= 1e-3 * pixels
                equal &= np.array_equal(np.asarray(x, np.float64), np.asarray(y, np.float64))
        else:
            assert a.shape == b.shape == SIZE
            assert (a == b).mean() >= 0.999
            equal &= np.array_equal(a, b)
    if equal:
        for k, v in ref.items():
            np.testing.assert_allclose(ours[k], v, rtol=1e-12, atol=1e-12, err_msg=k)


def test_run_test_limit_zero_returns_nothing(vit, tree):
    """limit_test_batches = 0 turns the pass off, as in Runner.test, for
    every method the port tests (contrastive too); a method that does not
    exist raises."""
    jm, variables, port = vit
    cfg = FitConfig(train_h=CROP, train_w=CROP, limit_test_batches=0)
    assert run_test(port, tree, cfg, device="cpu") == {}
    assert _jax_runner_test(jm, variables, tree, cfg, "flow_supervised", []) == {}
    for method in ("supervised", "gan", "flow_gan", "contrastive"):
        assert run_test(port, tree, cfg, method, device="cpu") == {}
    with pytest.raises(ValueError, match="contrastive"):
        run_test(port, tree, cfg, "mean_teacher", device="cpu")
