"""The Segmenter stack's data side (floodseg_tpu_torch/segm/{pipeline,data,
catalog}.py) against the JAX package's on the same files and the same
generators, on the CPU.

Bit for bit, images and labels, and the generator left in the same state
(the same draws in the same order): every mmseg pipeline op
(``RatioRangeResize`` with and without a ratio range, ``RandomCropCatMax``
with its redraws, ``PhotoMetricDistortion`` on many seeds so that every
branch runs, ``PadToSize``), ``_rescale_size``, ``_stats255``'s rounding,
both mmseg pipelines, ``build_eval_pipeline``, ``SegFolderDataset``
(``reduce_zero_label``, ``recursive``), the ``segm_dataset`` presets,
``pascal_context_dataset`` and the catalog. ``build_train_pipeline``'s
``Resize`` is the port's torch bilinear (data/transforms.py), within 1e-5
of the normalized value as tests/test_torch_data.py holds it, the labels
and draws equal. ``ImageFolderClsDataset`` resizes with INTER_CUBIC, which the port matches
but at near-ties (tests/test_torch_segm_cv2.py): its items are held to
one uint8 level (1 / (255 * std) after normalization) at no more than
CUBIC_SHARE of the values.
"""

import os

import numpy as np
import pytest

from floodseg_tpu.segm import catalog as jcatalog
from floodseg_tpu.segm import data as jdata
from floodseg_tpu.segm import pipeline as jpipe

from floodseg_tpu_torch.data.image import write_jpeg, write_png
from floodseg_tpu_torch.segm import catalog, data, pipeline

from test_torch_segm_cv2 import CUBIC_SHARE


def _labels(rng, h, w, n_cls, zero=True):
    lab = np.full((h, w), 0 if zero else rng.integers(0, n_cls), np.uint8)
    for _ in range(5):
        y, x = rng.integers(0, h), rng.integers(0, w)
        lab[y:y + h // 2, x:x + w // 2] = rng.integers(0, n_cls)
    return lab


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """ADE20K (images/annotations by split, labels 0..150), Cityscapes
    (per-city subdirectories), PascalContext (VOC split lists) and an
    ImageFolder tree (RGB and gray JPEGs, an RGB PNG), written by the
    port's codec."""
    root = tmp_path_factory.mktemp("segm_trees")
    rng = np.random.default_rng(0)
    ade = root / "ade"
    for split, n, hw in (("training", 3, (45, 70)), ("validation", 2, (52, 38))):
        os.makedirs(ade / "images" / split)
        os.makedirs(ade / "annotations" / split)
        for i in range(n):
            write_jpeg(str(ade / "images" / split / f"a{i}.jpg"),
                       rng.integers(0, 256, hw + (3,), dtype=np.uint8))
            write_png(str(ade / "annotations" / split / f"a{i}.png"),
                      _labels(rng, *hw, 151))
    cs = root / "cs"
    for split in ("train", "val"):
        for city in ("aachen", "bonn"):
            os.makedirs(cs / "leftImg8bit" / split / city)
            os.makedirs(cs / "gtFine" / split / city)
            write_png(str(cs / "leftImg8bit" / split / city / f"{city}_0_leftImg8bit.png"),
                      rng.integers(0, 256, (32, 64, 3), dtype=np.uint8))
            write_png(str(cs / "gtFine" / split / city / f"{city}_0_gtFine_labelTrainIds.png"),
                      _labels(rng, 32, 64, 19))
    voc = root / "voc" / "VOCdevkit" / "VOC2010"
    for d in ("JPEGImages", "SegmentationClassContext", "ImageSets/SegmentationContext"):
        os.makedirs(voc / d)
    for i in range(3):
        write_jpeg(str(voc / "JPEGImages" / f"v{i}.jpg"),
                   rng.integers(0, 256, (40, 60, 3), dtype=np.uint8))
        write_png(str(voc / "SegmentationClassContext" / f"v{i}.png"), _labels(rng, 40, 60, 60))
    for split, stems in (("train", "v0\nv1\nmissing\n"), ("val", "v2\n")):
        (voc / "ImageSets" / "SegmentationContext" / f"{split}.txt").write_text(stems)
    cls = root / "cls"
    for c, n in (("cat", 3), ("dog", 2)):
        os.makedirs(cls / c)
        for i in range(n):
            hw = tuple(int(v) for v in rng.integers(20, 90, 2))
            write_jpeg(str(cls / c / f"{i}.jpg"), rng.integers(0, 256, hw + (3,), np.uint8))
        im = rng.integers(0, 256, (50, 30), np.uint8)
        write_jpeg(str(cls / c / "gray.jpg"), np.repeat(im[..., None], 3, 2))
        write_png(str(cls / c / "rgb.png"), rng.integers(0, 256, (33, 47, 3), np.uint8))
    return {"ade": str(ade), "cs": str(cs), "voc": str(root / "voc"), "cls": str(cls)}


def _assert_samples_equal(ours, ref, what, frame_atol=0.0, share=0.0):
    """Every key equal; ``frame_current`` within ``frame_atol`` at no more
    than ``share`` of its values when those are given."""
    assert sorted(ours) == sorted(ref), what
    for k in ref:
        a, b = np.asarray(ours[k]), np.asarray(ref[k])
        assert a.dtype == b.dtype and a.shape == b.shape, (what, k, a.dtype, b.dtype)
        if k == "frame_current" and frame_atol:
            d = np.abs(a - b)
            assert d.max() <= frame_atol, (what, float(d.max()))
            assert (d > 0).sum() <= share * d.size, (what, int((d > 0).sum()), d.size)
        else:
            np.testing.assert_array_equal(a, b, err_msg=f"{what}: {k}")


def _run_both(op_ours, op_ref, sample, seed):
    """Both ops on copies of ``sample`` with one seed each; the outputs and
    the next draw of each generator (so the draws were the same)."""
    ro, rr = np.random.default_rng(seed), np.random.default_rng(seed)
    ours = op_ours({k: np.array(v) for k, v in sample.items()}, ro)
    ref = op_ref({k: np.array(v) for k, v in sample.items()}, rr)
    assert ro.random() == rr.random(), "the draws differ"
    return ours, ref


def _sample(rng, h=45, w=70, n_cls=6):
    return {"frame_current": rng.integers(0, 256, (h, w, 3)).astype(np.float32),
            "label": _labels(rng, h, w, n_cls).astype(np.int32)}


def test_catalog_equals_jax():
    for name in ("ADE20K_NAMES", "ADE20K_PALETTE", "CITYSCAPES_NAMES", "CITYSCAPES_PALETTE",
                 "PASCAL_CONTEXT_NAMES", "PASCAL_CONTEXT_PALETTE"):
        assert getattr(catalog, name) == getattr(jcatalog, name), name
    assert len(catalog.ADE20K_NAMES) == 150 and len(catalog.PASCAL_CONTEXT_PALETTE) == 60


def test_rescale_size_and_stats255_equal_jax():
    for h, w, scale in ((45, 70, (2048, 512)), (512, 683, (1024, 256)), (7, 3, (33, 9))):
        assert pipeline._rescale_size(h, w, scale) == jpipe._rescale_size(h, w, scale)
    for norm in ("vit", "deit"):
        assert pipeline._stats255(norm) == jpipe._stats255(norm)
    mean, std = pipeline._stats255("deit")
    assert mean == [123.68, 116.28, 103.53] and std == [58.4, 57.12, 57.38]


@pytest.mark.parametrize("ratio_range", [None, (0.5, 2.0)], ids=["eval", "ratio"])
def test_ratio_range_resize_equals_jax(ratio_range):
    rng = np.random.default_rng(1)
    for seed in range(4):
        s = _sample(rng)
        ours, ref = _run_both(pipeline.RatioRangeResize((256, 64), ratio_range),
                              jpipe.RatioRangeResize((256, 64), ratio_range), s, seed)
        _assert_samples_equal(ours, ref, seed)


def test_random_crop_cat_max_equals_jax_with_redraws():
    """A label of one big class makes the crop redraw: the port must redraw
    as often and land on the same window."""
    rng = np.random.default_rng(2)
    redraw_seen = False
    for seed in range(8):
        s = _sample(rng, 40, 40)
        s["label"][:, :34] = 3
        s["label"][0, 0] = 255
        op = pipeline.RandomCropCatMax((16, 16), cat_max_ratio=0.75)
        ours, ref = _run_both(op, jpipe.RandomCropCatMax((16, 16), cat_max_ratio=0.75), s,
                              seed)
        _assert_samples_equal(ours, ref, seed)
        probe = np.random.default_rng(seed)
        op._bbox(40, 40, probe)
        op._bbox(40, 40, probe)
        redraw_seen |= probe.random() != np.random.default_rng(seed).random()
    assert redraw_seen


def test_photometric_distortion_equals_jax():
    rng = np.random.default_rng(3)
    for seed in range(24):
        s = _sample(rng, 20, 24)
        ours, ref = _run_both(pipeline.PhotoMetricDistortion(),
                              jpipe.PhotoMetricDistortion(), s, seed)
        _assert_samples_equal(ours, ref, seed)


def test_pad_to_size_equals_jax():
    rng = np.random.default_rng(4)
    for hw in ((10, 12), (40, 3), (50, 50)):
        s = _sample(rng, *hw)
        ours, ref = _run_both(pipeline.PadToSize((32, 32)), jpipe.PadToSize((32, 32)), s, 0)
        _assert_samples_equal(ours, ref, hw)


@pytest.mark.parametrize("norm", ["vit", "deit"])
def test_mmseg_pipelines_equal_jax(norm):
    rng = np.random.default_rng(5)
    for seed in range(6):
        s = _sample(rng, 45, 70)
        ours, ref = _run_both(pipeline.build_mmseg_train_pipeline(32, 24, 4, norm),
                              jpipe.build_mmseg_train_pipeline(32, 24, 4, norm), s, seed)
        _assert_samples_equal(ours, ref, seed)
        ours, ref = _run_both(pipeline.build_mmseg_eval_pipeline(32, 4, norm),
                              jpipe.build_mmseg_eval_pipeline(32, 4, norm), s, seed)
        _assert_samples_equal(ours, ref, seed)


def test_flood_style_pipelines_equal_jax():
    rng = np.random.default_rng(6)
    for seed in range(4):
        s = _sample(rng, 45, 70)
        ours, ref = _run_both(data.build_train_pipeline(48, 32), jdata.build_train_pipeline(48, 32),
                              s, seed)
        _assert_samples_equal(ours, ref, seed, 1e-5, 1.0)
        ours, ref = _run_both(data.build_eval_pipeline(32), jdata.build_eval_pipeline(32), s, seed)
        _assert_samples_equal(ours, ref, seed)


def _items_equal(ours, ref, seeds=(0, 1)):
    assert len(ours) == len(ref) and ours.items == ref.items
    for i in range(len(ref)):
        for seed in seeds:
            a = ours.get(i, np.random.default_rng(seed))
            b = ref.get(i, np.random.default_rng(seed))
            _assert_samples_equal(a, b, (i, seed))


@pytest.mark.parametrize("zero", [False, True], ids=["plain", "reduce_zero_label"])
def test_seg_folder_dataset_equals_jax(trees, zero):
    args = (os.path.join(trees["ade"], "images", "training"),
            os.path.join(trees["ade"], "annotations", "training"))
    _items_equal(data.SegFolderDataset(*args, reduce_zero_label=zero),
                 jdata.SegFolderDataset(*args, reduce_zero_label=zero))


def test_seg_folder_dataset_recursive_equals_jax(trees):
    args = (os.path.join(trees["cs"], "leftImg8bit", "train"),
            os.path.join(trees["cs"], "gtFine", "train"), "_leftImg8bit.png",
            "_gtFine_labelTrainIds.png")
    ours = data.SegFolderDataset(*args, recursive=True)
    assert ours.items == ["aachen/aachen_0", "bonn/bonn_0"]
    _items_equal(ours, jdata.SegFolderDataset(*args, recursive=True))


@pytest.mark.parametrize("name", ["ade20k", "cityscapes", "pascal_context"])
@pytest.mark.parametrize("split", ["train", "val"])
def test_segm_dataset_presets_equal_jax(trees, name, split):
    root = {"ade20k": trees["ade"], "cityscapes": trees["cs"], "pascal_context": trees["voc"]}
    kw = dict(image_size=32, crop_size=24, normalization="deit")
    ours = data.segm_dataset(name, root[name], split, **kw)
    ref = jdata.segm_dataset(name, root[name], split, **kw)
    for attr in ("n_cls", "ignore_label", "names", "palette", "max_ratio"):
        assert getattr(ours, attr) == getattr(ref, attr), attr
    _items_equal(ours, ref)


def test_pascal_context_dataset_equals_jax(trees):
    ours = data.pascal_context_dataset(trees["voc"], "train")
    assert ours.items == ["v0", "v1"] and ours.n_cls == 60
    _items_equal(ours, jdata.pascal_context_dataset(trees["voc"], "train"))
    with pytest.raises(ValueError, match="Test split is not valid"):
        data.pascal_context_dataset(trees["voc"], "test")


@pytest.mark.parametrize("split", ["train", "val"])
def test_image_folder_cls_dataset_against_jax(trees, split):
    kw = dict(image_size=24, crop_size=24, split=split, normalization="deit")
    ours, ref = data.ImageFolderClsDataset(trees["cls"], **kw), jdata.ImageFolderClsDataset(
        trees["cls"], **kw)
    assert ours.items == ref.items and ours.classes == ref.classes == ["cat", "dog"]
    level = 1.0 / (255.0 * np.asarray(data.CLS_STATS["deit"]["std"], np.float32))
    off = total = 0
    for i in range(len(ref)):
        for seed in range(3):
            ro, rr = np.random.default_rng(seed), np.random.default_rng(seed)
            a, b = ours.get(i, ro), ref.get(i, rr)
            assert ro.random() == rr.random()
            assert a["target"] == b["target"] and a["im"].shape == b["im"].shape == (24, 24, 3)
            d = np.abs(a["im"] - b["im"])
            assert (d <= level * 1.0001 + 1e-6).all(), (i, seed, float(d.max()))
            off += int((d > 1e-6).sum())
            total += d.size
    assert off <= max(1, CUBIC_SHARE * total), (off, total)
