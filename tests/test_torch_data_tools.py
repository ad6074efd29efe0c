"""The port's dataset tools (floodseg_tpu_torch/data/tools/) and
``RandScale(aspect_ratio=...)`` against the JAX package's, on the CPU.

``build_lists`` on a small tree (masks as PNG, frame files present) with
clip tables of its own (a piecewise playback speed among them) against
the JAX tool: every list file and ``dataset.csv`` byte-equal (the JAX tool
writes the CSV with pandas, the port with the csv module), the class
distribution equal; ``get_global_frame_id`` on the UAV-5 tables equal.

``extract`` with a frame source (BGR frames and motion vectors in
mvextractor's layout, some not 16x16, some out of the frame) against the
JAX tool run with fake ``mvextractor`` and ``cv2`` modules in
``sys.modules`` (``VideoCap`` yields the same frames; ``cv2.imwrite``
writes the BGR frame as an RGB JPEG at cv2's quality 95 through PIL):
``grids/*.npy`` and ``inv_grids/*.npy`` equal, each frame of the port
(its q92 JPEG) above 35 dB against JAX's (the codec's rule,
tests/test_torch_image.py; 37.5 dB measured) and above 30 dB against the
noisy 64x96 source (32.1 dB measured). Without mvextractor the port stops
with the JAX tool's message, before it writes anything.

``RandScale`` with an aspect ratio draws s, then the ratio, and scales by
fx = s * sqrt(ar), fy = s / sqrt(ar): the port's draws and frames (within
1 grey level, cv2 5.0's arithmetic) and labels against the JAX transform
on the same generator.

About 5 s alone.
"""

import copy
import io
import os
import sys
import types

import numpy as np
import pytest
from PIL import Image

from floodseg_tpu.data import transforms as jax_tf
from floodseg_tpu.data.tools import extract_motion_vectors as jax_extract
from floodseg_tpu.data.tools import make_flow as jax_make_flow

from floodseg_tpu_torch.data import synthetic_clip, transforms
from floodseg_tpu_torch.data.image import decode_jpeg
from floodseg_tpu_torch.data.tools import extract_motion_vectors, make_flow

from test_torch_train_data import _compare, _frame

VIDEOS = {"alpha-01": "train", "alpha-02": "val", "beta-01": "test", "beta-02": "test2",
          "alpha-03": "train", "gamma-01": "valtest"}
SPEEDS = {"alpha-01": 1.0, "alpha-02": 1.5, "beta-01": 3.0, "beta-02": 1.0,
          "alpha-03": [{"start": 0, "speed": 3.0}, {"start": 50, "speed": 1.5},
                       {"start": 100, "speed": 2.0}], "gamma-01": 1.0}
STARTS = {"alpha-01": 0, "alpha-02": 700, "beta-01": 11, "beta-02": 0, "alpha-03": 1400,
          "gamma-01": 3000}
UNSUP = {"alpha-01": [2, 9], "beta-01": [4], "alpha-03": [7]}


def _tree(root):
    """Masks of 1-6 labels a clip (PNG, classes 0-6 so some are out of
    range) and an empty file for each frame they name."""
    rng = np.random.default_rng(4)
    for video in VIDEOS:
        if video == "beta-02":
            continue  # a clip without masks
        d = os.path.join(root, "masks", video)
        os.makedirs(d)
        for i in rng.choice(np.arange(1, 12), rng.integers(1, 7), replace=False):
            lab = rng.integers(0, 7, (9, 13)).astype(np.uint8)
            Image.fromarray(lab, mode="L").save(os.path.join(d, f"{i}.png"))
            fid = jax_make_flow.get_global_frame_id(video, int(i), SPEEDS, STARTS)
            img = os.path.join(root, "frames", video.split("-")[0], "images")
            os.makedirs(img, exist_ok=True)
            open(os.path.join(img, f"{fid}.jpg"), "wb").close()
    return root


def test_build_lists_matches_jax(tmp_path):
    kw = dict(variant="v1", videos=VIDEOS, unsupervised_index=UNSUP, num_classes=5,
              speeds=SPEEDS, starts=STARTS)
    ref_root, ours_root = (_tree(str(tmp_path / d)) for d in ("jax", "port"))
    ref_lists, ref_dist = jax_make_flow.build_lists(ref_root, **kw)
    lists, dist = make_flow.build_lists(ours_root, **kw)
    assert lists == ref_lists and sum(map(len, lists.values())) > 8 and lists["train_u"]
    np.testing.assert_array_equal(dist, ref_dist)
    names = sorted(os.listdir(os.path.join(ref_root, "list", "v1")))
    assert names == sorted(os.listdir(os.path.join(ours_root, "list", "v1")))
    assert "dataset.csv" in names and len(names) == 6
    for name in names:
        with open(os.path.join(ref_root, "list", "v1", name), "rb") as f:
            want = f.read()
        with open(os.path.join(ours_root, "list", "v1", name), "rb") as f:
            assert f.read() == want, name
    os.remove(os.path.join(ours_root, "frames", "alpha", "images",
                           f"{lists['train'][0][2]}.jpg"))
    with pytest.raises(FileNotFoundError):
        make_flow.build_lists(ours_root, **kw)


def test_global_frame_ids_match_jax():
    for video in jax_make_flow.VIDEO_SPEED:
        for i in range(1, 60):
            assert (make_flow.get_global_frame_id(video, i)
                    == jax_make_flow.get_global_frame_id(video, i)), (video, i)


def _source(n=4, hw=(64, 96), seed=0):
    """(BGR frame, motion vectors) pairs: (N, 10) rows in mvextractor's
    layout (source, w, h, src_x, src_y, dst_x, dst_y, ...), some 8x8 and
    some outside the frame."""
    rng = np.random.default_rng(seed)
    frames = synthetic_clip(n, size=hw, seed=seed)["frames"]
    out = []
    for k, rgb in sorted(frames.items()):
        m = 0 if k == 1 else 30
        mvs = np.zeros((m, 10), np.int32)
        mvs[:, 0] = -1
        mvs[:, 1] = mvs[:, 2] = rng.choice([8, 16, 16, 16], m)
        mvs[:, 3:5] = rng.integers(-8, max(hw) + 8, (m, 2))
        mvs[:, 5:7] = rng.integers(-8, max(hw) + 8, (m, 2))
        out.append((np.ascontiguousarray(rgb[..., ::-1]), mvs))
    return out


def _psnr(a, b):
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return 10 * np.log10(255.0 ** 2 / mse)


def test_extract_matches_jax(tmp_path, monkeypatch):
    source = _source()

    class VideoCap:
        def open(self, path):
            self.items = iter(source)
            return True

        def read(self):
            item = next(self.items, None)
            if item is None:
                return False, None, None, None, None
            return True, item[0], item[1], "P", 0.0

        def release(self):
            pass

    def imwrite(path, bgr):
        buf = io.BytesIO()
        Image.fromarray(np.ascontiguousarray(bgr[..., ::-1])).save(buf, format="JPEG",
                                                                     quality=95)
        with open(path, "wb") as f:
            f.write(buf.getvalue())
        return True

    mv = types.ModuleType("mvextractor")
    mv.videocap = types.ModuleType("mvextractor.videocap")
    mv.videocap.VideoCap = VideoCap
    monkeypatch.setitem(sys.modules, "mvextractor", mv)
    monkeypatch.setitem(sys.modules, "mvextractor.videocap", mv.videocap)
    monkeypatch.setitem(sys.modules, "cv2", types.SimpleNamespace(imwrite=imwrite))
    ref_root, ours_root = str(tmp_path / "jax"), str(tmp_path / "port")
    assert jax_extract.extract("clip.mp4", ref_root) == len(source)
    assert extract_motion_vectors.extract("clip.mp4", ours_root,
                                          source=iter(source)) == len(source)
    moved = 0
    for i, (bgr, _) in enumerate(source):
        for sub in ("grids", "inv_grids"):
            want = np.load(os.path.join(ref_root, "clip", sub, f"{i}.npy"))
            got = np.load(os.path.join(ours_root, "clip", sub, f"{i}.npy"))
            assert got.dtype == want.dtype == np.float32 and got.shape == want.shape == (4, 6, 2)
            np.testing.assert_array_equal(got, want)
            moved += int((got != np.load(os.path.join(ref_root, "clip", sub, "1.npy"))).any())
        with open(os.path.join(ours_root, "clip", "images", f"{i}.jpg"), "rb") as f:
            ours = decode_jpeg(f.read())
        with open(os.path.join(ref_root, "clip", "images", f"{i}.jpg"), "rb") as f:
            ref = np.asarray(Image.open(io.BytesIO(f.read())).convert("RGB"))
        assert ours.shape == ref.shape == bgr.shape
        assert _psnr(ours, ref) > 35 and _psnr(ours, bgr[..., ::-1]) > 30
    assert moved > 0
    # the decoder in place of the source: the same files again
    again = str(tmp_path / "again")
    assert extract_motion_vectors.extract("clip.mp4", again) == len(source)
    for sub in ("grids", "inv_grids"):
        np.testing.assert_array_equal(np.load(os.path.join(again, "clip", sub, "2.npy")),
                                      np.load(os.path.join(ours_root, "clip", sub, "2.npy")))


def test_extract_without_mvextractor_exits(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "mvextractor", None)
    monkeypatch.setitem(sys.modules, "mvextractor.videocap", None)
    with pytest.raises(SystemExit, match="mvextractor is required"):
        extract_motion_vectors.extract("clip.mp4", str(tmp_path))
    assert not os.listdir(tmp_path)
    with pytest.raises(SystemExit, match="mvextractor is required"):
        jax_extract.extract("clip.mp4", str(tmp_path))


def test_rand_scale_aspect_ratio_matches_jax():
    rng = np.random.default_rng(11)
    sample = {"frame_prev": _frame(12, (64, 80)), "frame_next": _frame(13, (64, 80)),
              "label": rng.integers(0, 5, (64, 80)).astype(np.uint8),
              "mvs_left": [rng.uniform(-1, 1, (4, 5, 2)).astype(np.float32) for _ in range(3)]}
    for seed in range(4):
        ref = jax_tf.RandScale([0.6, 1.7], aspect_ratio=[0.5, 2.0])(
            copy.deepcopy(sample), np.random.default_rng(seed))
        port = transforms.RandScale([0.6, 1.7], aspect_ratio=[0.5, 2.0])
        ours = port(copy.deepcopy(sample), np.random.default_rng(seed))
        _compare(ours, ref)
        g = np.random.default_rng(seed)
        s = 0.6 + 1.1 * g.random()
        ar = float(np.sqrt(0.5 + 1.5 * g.random()))
        assert port.draw(np.random.default_rng(seed)) == (s / ar, s * ar)
        assert ours["label"].shape == (int(np.rint(64 * s / ar)), int(np.rint(80 * s * ar)))
    plain = transforms.RandScale([0.6, 1.7])
    s = 0.6 + 1.1 * np.random.default_rng(3).random()
    assert plain.draw(np.random.default_rng(3)) == (s, s)
