"""The port's predict from files against the JAX package's, on the CPU.

PSPNet-50 (tests/torch_port_fixtures.py, float32 weights through the
bridge) over a synthetic tree of 64x96 frames, n = 5, 48 px crops (6 a
window, as the CLI's default sliding window cuts them), 4x6 block grids.

Tolerances: crop probabilities within 1e-4 in float32 (the network's parity
bound); in bf16 within 2**-6 (four bf16 ulps of the largest probability,
the repo's bf16 decode bound, tests/test_torch_deeplabv3.py; 9.2e-3
measured); with the int8 decoder within 5e-3, the int8 logits' bound
(tests/test_torch_flow_int8.py; 2.9e-4 measured). Class maps equal wherever
the top-2 gap of the averaged probabilities exceeds twice the tolerance.
The JAX route normalizes frames on the host (its runner's predict
transform); the port's reads raw pixels and normalizes on the device, so
equal outputs also pin that the port normalizes once.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from floodseg_tpu.data import DataLoader as JaxLoader
from floodseg_tpu.data import FlowDataset as JaxFlowDataset
from floodseg_tpu.data import build_test_transform as jax_test_transform
from floodseg_tpu.data.synthetic import generate_synthetic_dataset as jax_generate
from floodseg_tpu.models import build_model as jax_build_model
from floodseg_tpu.ops import metrics as jax_metrics
from floodseg_tpu.train import evaluate as jax_evaluate
from floodseg_tpu.train import predict as jax_predict
from floodseg_tpu.train.flow import make_cached_flow_predict_fn as jax_cached_fns
from floodseg_tpu.train.flow import make_flow_predict_crop_fn as jax_crop_fn
from floodseg_tpu.train.flow import make_flow_predict_fn as jax_predict_fn
from floodseg_tpu.video import grid as jax_grid

from floodseg_tpu_torch.data import FlowDataset, build_test_transform, collate, read_mjpg_avi
from floodseg_tpu_torch.models import build_model, load_jax_variables
from floodseg_tpu_torch.ops import launch_counts, metrics, reset_launch_counts
from floodseg_tpu_torch.train import (
    colorize,
    crop_offsets,
    flow_sliding_window_predict,
    make_flow_predict_crop_fn,
    run_flow_predict,
    run_predict,
)
from floodseg_tpu_torch.video import grid

from torch_port_fixtures import jnorm, pspnet50_pair
from torch_port_fixtures import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

N = 5
SIZE = (64, 96)
CROP = 48
CLASSES = 5
TOL = {"float32": 1e-4, "bfloat16": 2.0 ** -6, "int8": 5e-3}


@pytest.fixture(scope="module")
def pair():
    return pspnet50_pair(size=65)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """The JAX package's synthetic tree: 16 frames, so 3 predict windows."""
    root = str(tmp_path_factory.mktemp("predict_tree"))
    return jax_generate(root, num_frames=16, size=SIZE, frame_delta=N, num_labeled=2)


@pytest.fixture(scope="module")
def window(tree):
    """The first predict window, raw pixels (port) and normalized (JAX)."""
    ds = FlowDataset("predict", tree, type="u", frame_delta=N, predict_v_id="synth",
                     transform=build_test_transform(None, SIZE, normalize=False))
    return collate([ds.get(0, np.random.default_rng(0))]), ds.default_grid


def _crops(batch):
    """The window's crops and crop grids, as flow_sliding_window_predict
    cuts them."""
    fp, fn = batch["frame_prev"][0], batch["frame_next"][0]
    offs = crop_offsets(*SIZE, CROP, CROP)
    cut = [np.stack([f[h:h + CROP, w:w + CROP] for h, w in offs]) for f in (fp, fn)]
    grids = [np.stack([grid.crop_motion_vectors_stack_np(batch[k][:, 0], *SIZE, CROP, CROP,
                                                         h, w) for h, w in offs], axis=1)
             for k in ("mvs_left", "mvs_right")]
    return offs, cut, grids


# ------------------------------------------------------------- metrics

@pytest.mark.parametrize("ignore", [False, True], ids=["all_valid", "ignore_index"])
def test_metrics_match_jax(ignore):
    rng = np.random.default_rng(3)
    pred = rng.integers(0, CLASSES, (4, 33, 47))
    target = rng.integers(0, CLASSES, (4, 33, 47))
    target[:, :, :5] = 4  # a class that pred rarely hits
    if ignore:
        target[rng.random(target.shape) < 0.2] = 255
    ours = metrics.intersection_and_union(torch.from_numpy(pred), torch.from_numpy(target),
                                          CLASSES)
    ref = jax_metrics.intersection_and_union(jnp.asarray(pred), jnp.asarray(target), CLASSES)
    for a, b in zip(ours, ref):
        assert a.dtype == torch.float32
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    m, jm = metrics.MetricMeter(CLASSES), jax_metrics.MetricMeter(CLASSES)
    for meter, counts in ((m, ours), (jm, ref)):
        meter.update(*counts)
        meter.update(*counts)
    assert m.summary() == jm.summary()
    np.testing.assert_equal(m.summary_mmseg(), jm.summary_mmseg())
    logits = rng.standard_normal((16, 7)).astype(np.float32)
    labels = rng.integers(0, 7, 16)
    got = metrics.topk_accuracy(torch.from_numpy(logits), torch.from_numpy(labels), (1, 3))
    want = jax_metrics.topk_accuracy(jnp.asarray(logits), jnp.asarray(labels), (1, 3))
    np.testing.assert_allclose([float(g) for g in got], [float(w) for w in want], rtol=1e-6)
    a, b = metrics.AverageMeter(), jax_metrics.AverageMeter()
    for v, k in ((1.5, 2), (3.0, 1), (0.25, 4)):
        a.update(v, k)
        b.update(v, k)
    assert (a.val, a.avg, a.sum, a.count) == (b.val, b.avg, b.sum, b.count)


# ------------------------------------------------------------- crop algebra

@pytest.mark.parametrize("frame,crop", [((64, 96), (48, 48)), ((1072, 1920), (433, 433)),
                                        ((65, 65), (65, 65)), ((100, 77), (33, 50))])
def test_crop_offsets_match_jax(frame, crop):
    ours = crop_offsets(*frame, *crop)
    assert ours == jax_evaluate.crop_offsets(*frame, *crop)
    if frame == (1072, 1920):
        assert len(ours) == 28  # the CLI's default at PSPNet's 433 px train size


@pytest.mark.parametrize("frame,crop", [((64, 96), (48, 48)), ((1072, 1920), (433, 433))])
def test_crop_motion_vectors_match_jax(frame, crop):
    """The crop renormalisation, list and stacked forms, against the JAX
    package's (cv2 per grid, the einsum stack) within 1e-6."""
    rng = np.random.default_rng(5)
    gh, gw = frame[0] // 16, frame[1] // 16
    grids = (jax_grid.default_grid(*frame)[None]
             + rng.uniform(-0.05, 0.05, (3, gh, gw, 2))).astype(np.float32)
    for h, w in crop_offsets(*frame, *crop):
        args = (*frame, *crop, h, w)
        stack = grid.crop_motion_vectors_stack_np(grids, *args)
        np.testing.assert_allclose(stack, jax_grid.crop_motion_vectors_stack_np(grids, *args),
                                   rtol=0, atol=1e-6)
        listed = grid.crop_motion_vectors_np(list(grids), *args)
        ref = jax_grid.crop_motion_vectors_np(list(grids), *args)
        for a, b in zip(listed, ref):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(grid.flip_grid_np(grids[0]), jax_grid.flip_grid_np(grids[0]))


# ------------------------------------------------------------- crop predict

def _models(pair, mode):
    jm, variables, port = pair
    if mode != "bfloat16":
        return jm, variables, port
    jm = jax_build_model("pspnet", classes=CLASSES, layers=50, with_aux=False,
                         dtype=jnp.bfloat16)
    half = build_model("pspnet", classes=CLASSES, layers=50, with_aux=False,
                       dtype=torch.bfloat16)
    return jm, variables, load_jax_variables(half, variables)


@pytest.mark.parametrize("mode", ["float32", "bfloat16", "int8"])
def test_crop_fn_matches_jax(pair, window, mode):
    """make_flow_predict_crop_fn's (N, n, ch, cw, C) probabilities on the
    first window's 6 crops; no kernel launch on the CPU."""
    jm, variables, port = _models(pair, mode)
    batch, dg = window
    _, (fp, fn), (ml, mr) = _crops(batch)
    int8 = mode == "int8"
    ref = np.asarray(jax_crop_fn(jm, N, CLASSES, default_grid=dg, int8_decode=int8)(
        variables, jnorm(fp), jnorm(fn), ml, mr))
    reset_launch_counts()
    ours = make_flow_predict_crop_fn(port, N, CLASSES, default_grid=dg, int8_decode=int8,
                                     device="cpu")(port.state_dict(), fp, fn, ml, mr)
    assert ours.dtype == torch.float32 and ours.shape == ref.shape == (6, N, CROP, CROP, CLASSES)
    np.testing.assert_allclose(ours.numpy(), ref, rtol=0, atol=TOL[mode])
    assert set(launch_counts().values()) == {0}


def test_sliding_window_predict_matches_jax(pair, window):
    """The canvas average and the argmax: maps equal away from near-ties
    of the averaged probabilities (out_size is the frame's, so no resize)."""
    jm, variables, port = pair
    batch, dg = window
    jbatch = dict(batch, frame_prev=jnorm(batch["frame_prev"]),
                  frame_next=jnorm(batch["frame_next"]))
    jfn = jax_crop_fn(jm, N, CLASSES, default_grid=dg)
    ref = jax_evaluate.flow_sliding_window_predict(jfn, variables, jbatch, CLASSES, CROP, CROP,
                                                   SIZE)
    fn = make_flow_predict_crop_fn(port, N, CLASSES, default_grid=dg, device="cpu")
    ours = flow_sliding_window_predict(fn, port.state_dict(), batch, CLASSES, CROP, CROP, SIZE)
    assert ours.dtype == torch.int32 and ours.shape == ref.shape == (N,) + SIZE
    offs, (fp, fnn), (ml, mr) = _crops(batch)
    probs = np.asarray(jfn(variables, jnorm(fp), jnorm(fnn), ml, mr), np.float64)
    canvas, count = np.zeros((N,) + SIZE + (CLASSES,)), np.zeros(SIZE + (1,))
    for (h, w), p in zip(offs, probs):
        canvas[:, h:h + CROP, w:w + CROP] += p
        count[h:h + CROP, w:w + CROP] += 1
    top2 = np.sort(canvas / count, axis=-1)[..., -2:]
    clear = (top2[..., 1] - top2[..., 0]) > 2 * TOL["float32"]
    assert clear.mean() > 0.99
    np.testing.assert_array_equal(ours.numpy()[clear], np.asarray(ref)[clear])


# ------------------------------------------------------------- run_predict

def _jax_runner_predict(jm, variables, root, no_cropping, out_dir):
    """The JAX package's Runner.predict wiring (floodseg_tpu/cli/runner.py,
    one device): the predict transform normalizes on the host."""
    ds = JaxFlowDataset("predict", root, None, type="u", frame_delta=N, predict_v_id="synth",
                        transform=jax_test_transform(None, SIZE, normalize=True))
    colors = np.loadtxt(os.path.join(root, "list", "colors.txt")).astype("uint8")
    cached_fns = None
    if not no_cropping:
        crop_fn = jax_crop_fn(jm, N, CLASSES, default_grid=ds.default_grid)

        def predict_fn(v, fp, fn_, ml, mr):
            batch = {"frame_prev": fp, "frame_next": fn_, "mvs_left": ml, "mvs_right": mr}
            return jax_evaluate.flow_sliding_window_predict(crop_fn, v, batch, CLASSES, CROP,
                                                            CROP, SIZE)
    else:
        predict_fn = jax_predict_fn(jm, N, out_size=SIZE, default_grid=ds.default_grid)
        cached_fns = jax_cached_fns(jm, N, out_size=SIZE, default_grid=ds.default_grid)
    return jax_predict.run_predict(predict_fn, variables, JaxLoader(ds, 1, num_workers=2),
                                   CLASSES, colors=colors, save_images_dir=out_dir,
                                   cached_fns=cached_fns)


@pytest.mark.parametrize("no_cropping", [False, True], ids=["crop_route", "cached_route"])
def test_run_flow_predict_matches_jax_runner(pair, tree, tmp_path, no_cropping):
    """The port's Runner.predict wiring (run_flow_predict) against the JAX
    package's, on both routes: the same summary keys and frames, palette
    PNGs that PIL reads to the same maps, the temporal-consistency mIoU
    equal when the maps are equal; and an AVI that cv2 and the port's own
    reader both read as the 15 frames."""
    cv2 = pytest.importorskip("cv2")
    jm, variables, port = pair
    ref = _jax_runner_predict(jm, variables, tree, no_cropping, str(tmp_path / "jax"))
    video = str(tmp_path / "video" / "synth.avi")
    ours = run_flow_predict(port, port.state_dict(), tree, "synth", frame_delta=N, resize=SIZE,
                            crop=(CROP, CROP), no_cropping=no_cropping, workers=2,
                            save_images_dir=str(tmp_path / "port"), video_path=video,
                            device="cpu")
    assert sorted(ours) == sorted(ref)
    assert ours["frames"] == ref["frames"] == 15
    names = sorted(os.listdir(tmp_path / "jax"))
    assert sorted(os.listdir(tmp_path / "port")) == names and len(names) == 15
    maps = []
    for name in names:
        a = np.asarray(Image.open(tmp_path / "port" / name))
        b = np.asarray(Image.open(tmp_path / "jax" / name))
        assert Image.open(tmp_path / "port" / name).mode == "P"
        maps.append(a)
        assert (a == b).mean() > 0.999, name
    if all((np.asarray(Image.open(tmp_path / "port" / n)) ==
            np.asarray(Image.open(tmp_path / "jax" / n))).all() for n in names):
        for k in ("predict_miou1_epoch", "predict_macc1_epoch", "predict_accuracy1_epoch"):
            assert ours[k] == pytest.approx(ref[k], rel=1e-12, abs=1e-12), k
    frames = read_mjpg_avi(video)
    assert len(frames) == 15 and frames[0].shape == SIZE + (3,)
    colors = np.loadtxt(os.path.join(tree, "list", "colors.txt")).astype("uint8")
    order = sorted(range(15), key=lambda i: int(names[i].split(".")[0]))
    for f, i in zip(frames, order):
        mse = np.mean((f.astype(float) - colorize(maps[i], colors).astype(float)) ** 2)
        assert 10 * np.log10(255 ** 2 / max(mse, 1e-9)) > 30
    cap = cv2.VideoCapture(video)
    count = 0
    while cap.read()[0]:
        count += 1
    cap.release()
    assert count == 15


def test_run_predict_cache_keys_on_resolved_ids():
    """The cached encoding is reused only when a window's resolved prev key
    is the frame the previous window resolved as its next key."""
    calls = []

    def full(v, fp, fn, ml, mr):
        calls.append("full")
        return torch.zeros((N,) + SIZE, dtype=torch.int32), torch.ones(1)

    def cached(v, enc, fn, ml, mr):
        calls.append("cached")
        return torch.zeros((N,) + SIZE, dtype=torch.int32), enc

    def batch(fid, prev, nxt):
        z = np.zeros((1,) + SIZE + (3,), np.float32)
        g = np.zeros((N - 1, 1, 4, 6, 2), np.float32)
        return {"frame_prev": z, "frame_next": z, "mvs_left": g, "mvs_right": g,
                "frame_id": np.array([fid]), "prev_frame_id": np.array([prev]),
                "next_frame_id": np.array([nxt])}

    loader = [batch(0, 0, 5), batch(5, 5, 9), batch(10, 12, 15), batch(15, 15, 20)]
    s = run_predict(None, {}, loader, CLASSES, cached_fns=(full, cached))
    assert calls == ["full", "cached", "full", "cached"]
    assert s["frames"] == 4 * N and s["predict_miou1_epoch"] == pytest.approx(0.2)


def test_colorize_matches_jax():
    colors = np.array([[0, 0, 0], [30, 95, 170], [65, 117, 5]], np.uint8)
    m = np.random.default_rng(0).integers(0, 3, (7, 9))
    np.testing.assert_array_equal(colorize(m, colors), jax_predict.colorize(m, colors))


def test_phase_profiler_matches_jax():
    """PhaseProfiler's regions, means, sums and summary as the JAX
    package's, the sync run at each region's end."""
    from floodseg_tpu.core.profiler import PhaseProfiler as JaxProfiler

    from floodseg_tpu_torch.core.profiler import PhaseProfiler

    synced = []
    ours, ref = PhaseProfiler(sync=lambda: synced.append(1)), JaxProfiler()
    for prof in (ours, ref):
        for name in ("a", "a", "b"):
            with prof.profile(name):
                pass
    assert len(synced) == 3
    assert sorted(ours.summary()) == sorted(ref.summary()) == ["a", "b"]
    assert [v["count"] for v in ours.summary().values()] == [2, 1]
    assert ours.mean("missing") == ref.mean("missing") == 0.0
    assert ours.sum("a") >= 0.0
