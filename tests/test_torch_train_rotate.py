"""The single-frame training data path against cv2 and the JAX package on
the CPU: ``rotation_matrix_2d`` and ``warp_affine`` (ops/cv2_compat.py)
against cv2.getRotationMatrix2D and cv2.warpAffine, ``RandRotate`` and
``build_train_transform(with_rotate=True)`` against the JAX transforms on
the same generators, the crop-window form against the whole-frame chain,
and ``SemDataset`` against the JAX package's on one synthetic tree.

cv2 is only the oracle here (the machine with the card has none). The
rotation is held EQUAL: frames (uint8, bilinear, the MEAN border rounded
to uint8) and labels (nearest, the ignore border) on odd sizes, both angle
signs, angle 0, scales below and above 1, and widths on both sides of
warpAffine's 16-column vector body (its scalar tail forms the source
coordinate in another order). The transforms' frames, labels and draws
are equal too.
"""

import copy

import cv2
import numpy as np
import pytest

from floodseg_tpu.data import transforms as jax_tf
from floodseg_tpu.data.dataset import SemDataset as JaxSemDataset
from floodseg_tpu.data.synthetic import generate_synthetic_dataset as jax_generate

from floodseg_tpu_torch.data import SemDataset, transforms
from floodseg_tpu_torch.ops import cv2_compat
from floodseg_tpu_torch.train import FitConfig, flow_transforms, round_train, sem_transforms

MEAN = list(jax_tf.MEAN)


def _frame(seed, shape):
    """A smooth uint8 frame with noise (the synthetic frames' character)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:shape[0], 0:shape[1]]
    base = 120 + 60 * np.sin(xx * 0.13)[..., None] * np.cos(yy * 0.07)[..., None]
    return np.clip(base + rng.normal(0, 20, shape + (3,)), 0, 255).astype(np.uint8)


# (h, w, angle, scale): odd sizes, widths below, at and past multiples of 16
WARPS = [(37, 53, -9.7, 1.0), (64, 80, 7.77, 1.0), (101, 99, 0.0, 1.0), (101, 99, 0.0, 0.8),
         (45, 56, 8.700137016996255, 1.0), (209, 154, -1.7214614816853828, 1.2985051000230083),
         (250, 333, 3.3, 0.62), (31, 15, 10.0, 1.9), (96, 128, -0.004, 1.0)]


@pytest.mark.parametrize("h,w,angle,scale", WARPS)
def test_warp_affine_matches_cv2(h, w, angle, scale):
    """The matrix equal to cv2's; uint8 frames with the MEAN border and
    uint8 labels with 255 equal to cv2.warpAffine."""
    rng = np.random.default_rng(h * w)
    im = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
    lab = rng.integers(0, 6, (h, w)).astype(np.uint8)
    ref_m = cv2.getRotationMatrix2D((w / 2, h / 2), angle, scale)
    m = cv2_compat.rotation_matrix_2d((w / 2, h / 2), angle, scale)
    np.testing.assert_array_equal(m, ref_m)
    ref = cv2.warpAffine(im, ref_m, (w, h), flags=cv2.INTER_LINEAR,
                         borderMode=cv2.BORDER_CONSTANT, borderValue=MEAN)
    np.testing.assert_array_equal(cv2_compat.warp_affine(im, m, (w, h), border_value=MEAN),
                                  ref)
    ref = cv2.warpAffine(lab, ref_m, (w, h), flags=cv2.INTER_NEAREST,
                         borderMode=cv2.BORDER_CONSTANT, borderValue=255)
    np.testing.assert_array_equal(
        cv2_compat.warp_affine(lab, m, (w, h), nearest=True, border_value=255), ref)


def test_warp_affine_window_is_the_full_warp_cut():
    """Rows and columns in any order, from a source given as (shape, fetch)
    of the block the taps read: the full warp's pixels; other dtypes raise
    for bilinear."""
    im = _frame(3, (61, 83))
    m = cv2_compat.rotation_matrix_2d((41.5, 30.5), -6.1, 1.0)
    full = cv2_compat.warp_affine(im, m, (83, 61), border_value=MEAN)
    rows, cols = np.array([0, 5, 5, 60, 40]), np.array([82, 0, 7, 8, 80, 81])
    fetched = []

    def fetch(r, c):
        fetched.append((len(r), len(c)))
        return im[r][:, c]

    got = cv2_compat.warp_affine(((61, 83), fetch), m, (83, 61), border_value=MEAN,
                                 rows=rows, cols=cols)
    np.testing.assert_array_equal(got, full[rows][:, cols])
    assert fetched and fetched[0][1] <= 83
    with pytest.raises(TypeError, match="uint8"):
        cv2_compat.warp_affine(im.astype(np.float32), m, (83, 61))


def test_resize_nearest_to_the_same_size_is_a_copy():
    """cv2.resize copies when the output size equals the input's, whatever
    the factors (a scale within half a pixel of 1)."""
    lab = np.random.default_rng(4).integers(0, 6, (50, 71)).astype(np.uint8)
    ref = cv2.resize(lab, None, fx=1.0015, fy=1.0015, interpolation=cv2.INTER_NEAREST)
    assert ref.shape == lab.shape
    np.testing.assert_array_equal(
        transforms.cv2_resize_nearest(lab, ref.shape, (1.0015, 1.0015)), ref)


def _compare(ours, ref):
    assert set(ours) == set(ref)
    for k, v in ref.items():
        np.testing.assert_array_equal(np.asarray(ours[k]), np.asarray(v), err_msg=k)


@pytest.mark.parametrize("seed", range(6))
def test_rand_rotate_matches_jax(seed):
    """RandRotate alone on frames and a label: the same coin and angle
    draws (the generators end in the same state) and equal pixels."""
    rng = np.random.default_rng(seed)
    shape = (int(rng.integers(40, 90)), int(rng.integers(40, 90)))
    sample = {"frame_current": _frame(seed, shape),
              "label": rng.integers(0, 6, shape).astype(np.uint8)}
    jr, pr = np.random.default_rng(seed), np.random.default_rng(seed)
    ref = jax_tf.RandRotate([-10, 10], padding=MEAN, ignore_label=255)(copy.deepcopy(sample),
                                                                         jr)
    ours = transforms.RandRotate([-10, 10], padding=MEAN, ignore_label=255)(
        copy.deepcopy(sample), pr)
    _compare(ours, ref)
    assert jr.random() == pr.random()


@pytest.mark.parametrize("seed", range(8))
def test_train_transform_with_rotate_matches_jax(seed):
    """The single-frame train pipeline (ignore class 5, resize, scale
    0.5-2, rotate, blur, flip, 49 px crop padded with MEAN and 255, float32
    without normalising): equal to the JAX transform, on the crop-window
    route and, where the scaled frame is smaller than the crop, the padded
    whole-frame one."""
    rng = np.random.default_rng(seed)
    shape = (int(rng.integers(40, 90)), int(rng.integers(40, 90)))
    sample = {"frame_current": _frame(seed, shape),
              "label": rng.integers(0, 6, shape).astype(np.uint8)}
    args = dict(classes_ignore=[5], scale_min=0.5, scale_max=2.0, resize=shape,
                with_rotate=True, normalize=False)
    ref = jax_tf.build_train_transform(49, 49, **args)(copy.deepcopy(sample),
                                                       np.random.default_rng(seed))
    ours = transforms.build_train_transform(49, 49, **args)(copy.deepcopy(sample),
                                                            np.random.default_rng(seed))
    _compare(ours, ref)


@pytest.mark.parametrize("seed", range(4))
def test_crop_window_equals_the_whole_frame_chain(seed):
    """ScaleBlurFlipCrop with a rotation computes only the crop window: the
    same pixels as RandScale, RandRotate, RandomGaussianBlur,
    RandomHorizontalFlip and Crop on whole frames with one generator, near
    the frame's border too (the 96x128 frame scaled at 0.55-0.7 leaves a
    53-89 px frame around the 49 px crop)."""
    rng = np.random.default_rng(seed)
    sample = {"frame_current": _frame(seed, (96, 128)),
              "label": rng.integers(0, 6, (96, 128)).astype(np.uint8)}
    rotate = transforms.RandRotate([-10, 10], padding=MEAN, p=1.0)
    fused = transforms.ScaleBlurFlipCrop([0.55, 0.7], [49, 49], padding=MEAN, rotate=rotate)
    chain = transforms.Compose([transforms.RandScale([0.55, 0.7]), rotate,
                                transforms.RandomGaussianBlur(),
                                transforms.RandomHorizontalFlip(),
                                transforms.Crop([49, 49], "rand", padding=MEAN)])
    _compare(fused(copy.deepcopy(sample), np.random.default_rng(seed)),
             chain(copy.deepcopy(sample), np.random.default_rng(seed)))


def test_sem_and_flow_transform_sizes():
    """round_train links the crop to the architecture as apply_links does:
    433 -> 433 for the CNNs and 416 for the ViT, 873 stays 873; the
    single-frame pipelines rotate and pad with MEAN, the flow ones rotate
    only with no_warp."""
    assert (round_train(433, "pspnet"), round_train(433, "vit"),
            round_train(873, "deeplabv3")) == (433, 416, 873)
    cfg = FitConfig(train_h=873, train_w=873)
    tf = sem_transforms(cfg, "pspnet")["train"]
    fused = next(t for t in tf.transforms if isinstance(t, transforms.ScaleBlurFlipCrop))
    assert isinstance(fused.rotate, transforms.RandRotate)
    assert (fused.crop.crop_h, fused.crop.padding) == (873, MEAN)
    for arch, size in (("vit", 416), ("deeplabv3", 433)):
        fused = next(t for t in flow_transforms(FitConfig(), arch)["train"].transforms
                     if isinstance(t, transforms.ScaleBlurFlipCrop))
        assert fused.rotate is None and (fused.crop.crop_h, fused.crop.crop_w) == (size, size)
    fused = next(t for t in flow_transforms(FitConfig(no_warp=True))["train"].transforms
                 if isinstance(t, transforms.ScaleBlurFlipCrop))
    assert fused.rotate is not None


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("sem_tree"))
    return jax_generate(root, num_frames=30, size=(96, 128), frame_delta=5, num_labeled=8)


@pytest.mark.parametrize("split", ["train", "val", "test"])
def test_sem_dataset_matches_jax(tree, split):
    """SemDataset items through the single-frame train transform (train),
    the val transform (val) and none (test, an all-zero uint8 label turned
    int32): equal to the JAX package's on the same generators."""
    lst = f"{tree}/list/all/{'train' if split == 'test' else split}.txt"
    if split == "train":
        args = dict(classes_ignore=[5], resize=(96, 128), normalize=False)
        jt, pt = (jax_tf.build_train_transform(49, 49, **args),
                  transforms.build_train_transform(49, 49, **args))
    elif split == "val":
        jt, pt = (jax_tf.build_val_transform(49, 49, [5], (96, 128)),
                  transforms.build_val_transform(49, 49, [5], (96, 128)))
    else:
        jt = pt = None
    ref, ours = JaxSemDataset(split, tree, lst, jt), SemDataset(split, tree, lst, pt)
    assert len(ours) == len(ref) > 0
    for i in range(len(ref)):
        a, b = ours.get(i, np.random.default_rng((3, i))), ref.get(i, np.random.default_rng((3, i)))
        assert a["label"].dtype == np.int32
        if split == "test":
            assert not a["label"].any()
        _compare(a, b)
