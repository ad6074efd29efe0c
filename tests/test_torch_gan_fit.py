"""The s4GAN wiring of ``Runner.fit`` and ``Runner.test`` in the port
(floodseg_tpu_torch/train/fit.py) against the JAX package's, on the CPU.

One synthetic tree from the JAX package's writer (30 frames of 128x160, 8
labeled: 6 train items, 4 in train_u.txt, 1 val), and a list variant of it
without train_u.txt. The role loaders (``role_datasets``,
``train_loaders``) against ``Runner._train_loaders`` itself, run on a
Runner made without its constructor (the config, one device, no mesh):
the first batch of each role, "l", "u" and "gt", equal for both methods,
and the steps an epoch; the ``data_ratio`` split of train.txt when there
is no train_u.txt equal to ``Runner._train_datasets``', with its two
raising cases (a side empty) and a role smaller than the batch raising on
both sides. ``run_test`` with "flow_gan" and "gan" equal to
"flow_supervised" and "supervised". (``run_gan_fit`` is held against a JAX
wiring of ``Runner.fit`` in tests/test_torch_gan_step.py, which shares its
jitted JAX step.)
"""

import os
import shutil

import numpy as np
import pytest
import torch

from floodseg_tpu.cli.runner import Runner
from floodseg_tpu.data.synthetic import generate_synthetic_dataset as jax_generate

from floodseg_tpu_torch.models import SegmenterViT, init_from_generator_
from floodseg_tpu_torch.train import (
    default_fit_config,
    flow_transforms,
    role_datasets,
    run_test,
    sem_transforms,
    train_loaders,
)

from torch_port_fixtures import jax_runner

SIZE, TREE, N, CLASSES = 64, (128, 160), 5, 5
CONFIG = dict(image_size=SIZE, patch_size=32, d_model=128, n_layers=2, dec_layers=2,
              n_heads=2)  # the narrow ViT of tests/test_torch_train_vit.py
FIT = default_fit_config(train_h=SIZE, train_w=SIZE, resize_h=TREE[0], resize_w=TREE[1],
                         frame_delta=N, workers=2, max_epochs=1, limit_train_batches=2, lr=1e-3,
                         seed=42)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """The tree, and under list/nou its lists without train_u.txt."""
    root = jax_generate(str(tmp_path_factory.mktemp("gan_tree")), num_frames=30, size=TREE,
                        frame_delta=N, num_labeled=8)
    os.makedirs(os.path.join(root, "list", "nou"))
    for name in ("train.txt", "val.txt"):
        shutil.copy(os.path.join(root, "list", "all", name), os.path.join(root, "list", "nou"))
    return root


def _transforms(cfg, method):
    return (flow_transforms if method == "flow_gan" else sem_transforms)(cfg, "vit")


def _first(loader):
    it = iter(loader)
    try:
        return {k: np.asarray(v) for k, v in next(it).items()}
    finally:
        it.close()


@pytest.mark.parametrize("method", ["flow_gan", "gan"])
def test_role_loaders_match_runner(tree, method):
    """Each role's first batch equal to Runner._train_loaders' (frames,
    labels, grids and chain lengths), the gt role over the labeled items,
    the roles' seeds 42, 43 and 44, and the steps an epoch (the longer
    role, then limit_train_batches)."""
    cfg = default_fit_config(**{**FIT.__dict__, "limit_train_batches": None})
    r = jax_runner(tree, method, cfg)
    ref, ref_steps = Runner._train_loaders(r, Runner._transforms(r))
    roles = role_datasets(cfg, tree, method, _transforms(cfg, method)["train"])
    assert [x[2] for x in roles["gt"].items] == [x[2] for x in roles["l"].items]
    loaders, steps = train_loaders(cfg, roles, "cpu")
    assert sorted(loaders) == sorted(ref) == ["gt", "l", "u"]
    assert steps == ref_steps == 3 and [loaders[k].seed for k in ("l", "u", "gt")] == [42, 43, 44]
    for k in ("l", "u", "gt"):
        ours, want = _first(loaders[k]), _first(ref[k])
        assert sorted(ours) == sorted(want), k
        for key, v in want.items():
            np.testing.assert_array_equal(ours[key], v, err_msg=f"{k} {key}")
    cfg.limit_train_batches = 2
    assert train_loaders(cfg, roles, "cpu")[1] == 2


@pytest.mark.parametrize("method", ["flow_gan", "gan"])
def test_data_ratio_split_matches_runner(tree, method):
    """Without train_u.txt, train.txt splits into disjoint l and u sets by
    data_ratio with the seed's permutation, as Runner._train_datasets
    splits it; the gt role takes the l items."""
    cfg = default_fit_config(**{**FIT.__dict__, "data_variant": "nou", "data_ratio": 0.5})
    r = jax_runner(tree, method, cfg)
    tf = Runner._transforms(r)["train"]
    ref_l, ref_u = Runner._train_datasets(r, tf, need_unlabeled=True)
    roles = role_datasets(cfg, tree, method, _transforms(cfg, method)["train"])
    assert roles["l"].items == ref_l.items and roles["u"].items == ref_u.items
    assert len(roles["l"]) == 3 and len(roles["u"]) == 3
    assert not set(roles["l"].items) & set(roles["u"].items)
    assert roles["gt"].items == roles["l"].items


@pytest.mark.parametrize("ratio", [1.0, 0.1])
def test_data_ratio_split_raises_on_an_empty_side(tree, ratio):
    cfg = default_fit_config(**{**FIT.__dict__, "data_variant": "nou", "data_ratio": ratio})
    r = jax_runner(tree, "flow_gan", cfg)
    with pytest.raises(ValueError, match="data_ratio"):
        Runner._train_datasets(r, None, need_unlabeled=True)
    with pytest.raises(ValueError, match="data_ratio"):
        role_datasets(cfg, tree, "flow_gan")


def test_role_smaller_than_the_batch_raises(tree):
    """data_ratio 0.9 leaves one unlabeled item for a batch of two: both
    wirings raise."""
    cfg = default_fit_config(**{**FIT.__dict__, "data_variant": "nou", "data_ratio": 0.9})
    r = jax_runner(tree, "gan", cfg)
    with pytest.raises(ValueError, match="unlabeled"):
        Runner._train_loaders(r, Runner._transforms(r))
    with pytest.raises(ValueError, match="unlabeled"):
        train_loaders(cfg, role_datasets(cfg, tree, "gan"), "cpu")


# ------------------------------------------------------------------ the test

@pytest.mark.parametrize("method,same_as", [("flow_gan", "flow_supervised"),
                                            ("gan", "supervised")])
def test_run_test_takes_the_gan_methods(tree, method, same_as):
    """run_test routes flow_gan as flow_supervised (the flow crop sliding
    window) and gan as supervised (the multi-scale flip test): the same
    results on one model and tree."""
    port = init_from_generator_(SegmenterViT(classes=CLASSES, **CONFIG),
                                torch.Generator().manual_seed(5))
    cfg = default_fit_config(train_h=SIZE, train_w=SIZE, resize_h=TREE[0], resize_w=TREE[1],
                             frame_delta=N, workers_test=2, limit_test_batches=1, test_base_size=96)
    ours, want = (run_test(port, tree, cfg, m, device="cpu") for m in (method, same_as))
    assert sorted(ours) == sorted(want) and "test_miou_epoch" in ours
    for k, v in want.items():
        np.testing.assert_array_equal(ours[k], v, err_msg=k)
