"""The port's host data path against the JAX package's, on the CPU.

The same dataset tree goes through floodseg_tpu.data and
floodseg_tpu_torch.data: list parsing, FlowDataset in every split and type
(also over a tree with missing frames), collate, the DataLoader's order,
seeds, early break and error surfacing, the synthetic writer, and the
predict transforms. Frames are read by PIL in the JAX package and by the
port's own codec, which gives PIL's pixels (tests/test_torch_image.py), so
every key must be equal.
"""

import os
import threading

import numpy as np
import pytest
import torch

from floodseg_tpu.data import transforms as jax_tf
from floodseg_tpu.data.dataset import ConcatDataset as JaxConcat
from floodseg_tpu.data.dataset import FlowDataset as JaxFlowDataset
from floodseg_tpu.data.dataset import collate as jax_collate
from floodseg_tpu.data.dataset import parse_list as jax_parse_list
from floodseg_tpu.data.loader import DataLoader as JaxLoader
from floodseg_tpu.data.synthetic import generate_synthetic_dataset as jax_generate

from floodseg_tpu_torch.data import (
    ConcatDataset,
    DataLoader,
    FlowDataset,
    build_test_transform,
    collate,
    device_put,
    generate_synthetic_dataset,
    imread,
    parse_list,
    transforms,
)

N = 5
SIZE = (64, 96)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """The JAX package's synthetic tree (PIL-written), 31 frames."""
    root = str(tmp_path_factory.mktemp("jax_tree"))
    return jax_generate(root, num_frames=31, size=SIZE, frame_delta=N, num_labeled=6)


@pytest.fixture(scope="module")
def holey_tree(tmp_path_factory):
    """The same tree without the images of frames 10, 11, 19 and 30, so the
    nearest-existing fallback moves keys both ways (the predict split reads
    every grid of a window, so grids stay)."""
    root = str(tmp_path_factory.mktemp("holey_tree"))
    jax_generate(root, num_frames=31, size=SIZE, frame_delta=N, num_labeled=6)
    frames = os.path.join(root, "frames", "synth")
    for i in (10, 11, 19, 30):
        os.remove(os.path.join(frames, "images", f"{i}.jpg"))
    return root


def assert_samples_equal(ours, ref):
    assert sorted(ours) == sorted(ref)
    for k, v in ref.items():
        if isinstance(v, list):
            assert len(ours[k]) == len(v), k
            for a, b in zip(ours[k], v):
                np.testing.assert_array_equal(a, b, err_msg=k)
        else:
            np.testing.assert_array_equal(np.asarray(ours[k]), np.asarray(v), err_msg=k)
            assert np.asarray(ours[k]).dtype == np.asarray(v).dtype, k


@pytest.mark.parametrize("name,min_id", [("train.txt", None), ("val.txt", 2),
                                         ("train_u.txt", N // 2)])
def test_parse_list_matches_jax(tree, name, min_id, tmp_path):
    path = os.path.join(tree, "list", "all", name)
    assert parse_list(path, min_id) == jax_parse_list(path, min_id)
    bad = tmp_path / "bad.txt"
    bad.write_text("a b\n")
    with pytest.raises(RuntimeError, match="read line error"):
        parse_list(str(bad))


CASES = [("predict", "u"), ("val", "l"), ("test", "l"), ("train", "l"), ("train", "u"),
         ("train", "gt"), ("val", "gt")]


def _datasets(root, split, type_, **kw):
    lst = None if split == "predict" else os.path.join(
        root, "list", "all", {"train": "train.txt", "val": "val.txt",
                              "test": "test.txt"}[split])
    args = dict(type=type_, frame_delta=N, predict_v_id="synth", **kw)
    return FlowDataset(split, root, lst, **args), JaxFlowDataset(split, root, lst, **args)


@pytest.mark.parametrize("holey", [False, True], ids=["tree", "missing_frames"])
@pytest.mark.parametrize("split,type_", CASES, ids=[f"{s}-{t}" for s, t in CASES])
def test_flow_dataset_matches_jax(tree, holey_tree, holey, split, type_):
    root = holey_tree if holey else tree
    ours, ref = _datasets(root, split, type_)
    assert len(ours) == len(ref) > 0
    np.testing.assert_array_equal(ours.default_grid, ref.default_grid)
    for i in range(len(ref)):
        a = ours.get(i, np.random.default_rng((0, 0, i)))
        b = ref.get(i, np.random.default_rng((0, 0, i)))
        assert_samples_equal(a, b)


def test_flow_dataset_resolved_key_ids_on_missing_frames(holey_tree):
    """Window 1's next key (10) is missing: it resolves down to 9, and
    window 2's prev key up to 12 (11 is missing too)."""
    ours, _ = _datasets(holey_tree, "predict", "u")
    rng = np.random.default_rng(0)
    s1, s2 = ours.get(1, rng), ours.get(2, rng)
    assert (s1["prev_frame_id"], s1["next_frame_id"]) == (5, 9)
    assert (s2["prev_frame_id"], s2["next_frame_id"]) == (12, 15)
    assert s2["frame_id"] == 10


@pytest.mark.parametrize("kw", [dict(no_warp=True), dict(no_random_frame_delta=True)],
                         ids=["no_warp", "no_random_frame_delta"])
def test_flow_dataset_options_match_jax(tree, kw):
    for split, type_ in (("predict", "u"), ("train", "l")):
        ours, ref = _datasets(tree, split, type_, **kw)
        for i in range(len(ref)):
            assert_samples_equal(ours.get(i, np.random.default_rng(i)),
                                 ref.get(i, np.random.default_rng(i)))


def test_default_grid_probe_matches_jax(tree):
    """The identity padding grid is sized by a probed grid file (4x6 here),
    not the reference's 67x120."""
    ours, ref = _datasets(tree, "train", "l")
    assert ours.default_grid.shape == ref.default_grid.shape == (4, 6, 2)


@pytest.mark.parametrize("split,type_", [("predict", "u"), ("train", "l")])
def test_collate_matches_jax(tree, split, type_):
    ours, ref = _datasets(tree, split, type_)
    a = [ours.get(i, np.random.default_rng(i)) for i in range(2)]
    b = [ref.get(i, np.random.default_rng(i)) for i in range(2)]
    ca, cb = collate(a), jax_collate(b)
    assert_samples_equal(ca, cb)
    if "mvs_left" in ca:
        assert ca["mvs_left"].shape == (N - 1, 2) + ca["mvs_left"].shape[2:]


def test_concat_dataset_matches_jax(tree):
    parts = [_datasets(tree, s, "l") for s in ("val", "test")]
    ours = ConcatDataset([p[0] for p in parts])
    ref = JaxConcat([p[1] for p in parts])
    assert len(ours) == len(ref)
    for i in list(range(len(ref))) + [-1]:
        assert_samples_equal(ours.get(i, np.random.default_rng(0)),
                             ref.get(i, np.random.default_rng(0)))


class _Draws:
    """A dataset whose items record their index and a draw of their rng."""

    def __init__(self, n, fail_at=None, delay=None):
        self.n, self.fail_at, self.delay = n, fail_at, delay

    def __len__(self):
        return self.n

    def get(self, i, rng):
        if i == self.fail_at:
            raise KeyError(f"item {i}")
        if self.delay is not None:
            self.delay.wait(0.001 * ((i * 7) % 5))
        return {"target": i, "x": rng.standard_normal(3)}


@pytest.mark.parametrize("shuffle,batch_size,drop_last", [(False, 1, False), (True, 3, False),
                                                         (True, 4, True)])
def test_loader_order_and_seeds_match_jax(shuffle, batch_size, drop_last):
    ds = _Draws(10, delay=threading.Event())
    kw = dict(batch_size=batch_size, shuffle=shuffle, drop_last=drop_last, num_workers=4,
              seed=3)
    ours, ref = DataLoader(ds, **kw), JaxLoader(ds, **kw)
    assert len(ours) == len(ref)
    for _ in range(2):  # two epochs: the shuffle and the draws move on
        a, b = list(ours), list(ref)
        assert len(a) == len(b) == len(ref)
        for x, y in zip(a, b):
            assert_samples_equal(x, y)


def test_loader_early_break_claims_the_epoch():
    ds = _Draws(6)
    ours, ref = DataLoader(ds, shuffle=True, seed=1), JaxLoader(ds, shuffle=True, seed=1)
    for loader in (ours, ref):
        for _ in loader:
            break
    assert ours.epoch == ref.epoch == 1
    for x, y in zip(list(ours), list(ref)):
        assert_samples_equal(x, y)


def test_loader_surfaces_item_errors():
    with pytest.raises(RuntimeError, match="DataLoader worker failed") as info:
        list(DataLoader(_Draws(8, fail_at=5), num_workers=2))
    assert isinstance(info.value.__cause__, KeyError)


def test_loader_infinite_and_device_put_on_cpu(tree):
    ds, _ = _datasets(tree, "predict", "u")
    loader = DataLoader(ds, batch_size=2, num_workers=2, infinite=True,
                        device_put=lambda b: device_put(b, "cpu"))
    it = iter(loader)
    batches = [next(it) for _ in range(len(loader) + 1)]
    it.close()
    b = batches[0]
    assert isinstance(b["frame_prev"], torch.Tensor) and b["frame_prev"].device.type == "cpu"
    assert b["frame_prev"].dtype == torch.float32 and b["frame_prev"].shape == (2,) + SIZE + (3,)
    assert b["mvs_left"].shape == (N - 1, 2, 4, 6, 2)
    assert isinstance(b["prev_frame_id"], np.ndarray)
    ref = collate([ds.get(i, np.random.default_rng(0)) for i in range(2)])
    for k, v in ref.items():
        np.testing.assert_array_equal(np.asarray(b[k]), v)
    # the epoch after the last one starts over
    np.testing.assert_array_equal(np.asarray(batches[-1]["frame_id"]), ref["frame_id"])


def test_device_put_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default resolves to it")
    with pytest.raises(RuntimeError, match="CUDA"):
        device_put({"frame_prev": np.zeros((1, 2, 2, 3), np.float32)})


def test_synthetic_dataset_matches_jax(tree, tmp_path):
    """The port's writer gives the JAX writer's tree: the same files, lists,
    names and colours, bit-equal grids, the same JPEG bytes (the encoder
    writes PIL's bytes at q92) and masks that read back equal."""
    ours = generate_synthetic_dataset(str(tmp_path), num_frames=31, size=SIZE,
                                      frame_delta=N, num_labeled=6)

    def files(root):
        return sorted(os.path.relpath(os.path.join(d, f), root)
                      for d, _, fs in os.walk(root) for f in fs)

    assert files(ours) == files(tree)
    for rel in files(tree):
        a, b = os.path.join(ours, rel), os.path.join(tree, rel)
        if rel.endswith(".npy"):
            np.testing.assert_array_equal(np.load(a), np.load(b))
            assert np.load(a).dtype == np.load(b).dtype
        elif rel.endswith(".png"):
            np.testing.assert_array_equal(imread(a), imread(b))
        else:
            with open(a, "rb") as fa, open(b, "rb") as fb:
                assert fa.read() == fb.read(), rel


@pytest.mark.parametrize("normalize", [False, True])
def test_test_transform_matches_jax(tree, normalize):
    """At a resize to the frame's own size (where cv2 is exact) with a
    class ignored."""
    ours, ref = _datasets(tree, "val", "l")
    a = ours.get(0, np.random.default_rng(0))
    b = ref.get(0, np.random.default_rng(0))
    ta = build_test_transform([3], SIZE, normalize)(a, None)
    tb = jax_tf.build_test_transform([3], SIZE, normalize)(b, None)
    assert_samples_equal(ta, tb)
    assert not (ta["label"] == 3).any()


def test_resize_transform_against_jax_at_other_sizes(tree):
    """Labels resize as cv2.INTER_NEAREST exactly; frames within 1 grey
    level of cv2.INTER_LINEAR."""
    ours, _ = _datasets(tree, "val", "l")
    s = ours.get(0, np.random.default_rng(0))
    for size in ((65, 97), (33, 50)):
        a = transforms.Resize(size)(dict(s), None)
        b = jax_tf.Resize(size)(dict(s), None)
        np.testing.assert_array_equal(a["label"], b["label"])
        for k in ("frame_prev", "frame_next"):
            assert a[k].dtype == b[k].dtype == np.uint8
            assert np.abs(a[k].astype(int) - b[k].astype(int)).max() <= 1
