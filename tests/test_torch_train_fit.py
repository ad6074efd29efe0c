"""``run_flow_fit`` for DeepLabV3 against a JAX wiring of ``Runner.fit``
on the CPU (``run_fit`` is held in tests/test_torch_train_vit.py, and
DeepLabV3's supervised step in tests/test_torch_train_deeplabv3.py).

One synthetic tree from the JAX package's writer (30 frames of 96x128, 8
labeled: 6 train, 1 val, 1 test); DeepLabV3-50 with its aux head, float64
(JAX under ``jax.enable_x64``), 33 px crops, FlowDataset items through the
interpolated step, one epoch of two steps and a validation pass, dropout
off on both sides (the port's rates set to 0, JAX's ``dropout_scale`` 0:
the two packages' dropout draws cannot match inside a loop), OHEM's
min_kept above the pixel count (so no pixel selection can flip). The
epoch's mean loss within rtol 1e-5 and the validation counts equal.

Both sides' train and val transforms end by putting the cropped grids on
multiples of 2**-10 (``round_grids``), as the float64 step tests' grids
are: XLA fuses the JAX warp chain's float32 tap
arithmetic, which moves a tap weight by an ulp, and at 5x5 feature maps
BN's backward amplifies that (the port itself moves DeepLabV3's ASPP
weights by 2.5e-5 of their scale after one step when its grids move by
1e-7); on such grids both packages' tap arithmetic is exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from floodseg_tpu.data.synthetic import generate_synthetic_dataset as jax_generate
from floodseg_tpu.models.deeplabv3 import DeepLabV3 as JaxDeepLabV3

from floodseg_tpu_torch.models import build_model
from floodseg_tpu_torch.models.layers import Dropout
from floodseg_tpu_torch.train import default_fit_config, fit, run_flow_fit

from torch_port_fixtures import _perturb_bn, _to_dict, jax_fit, port_state, round_grids

CROP = 33
FIT = default_fit_config(train_h=CROP, train_w=CROP, resize_h=96, resize_w=128, frame_delta=5,
                         workers=2, max_epochs=1, limit_train_batches=2, lr=1e-3, seed=42)


def _jax_model():
    return JaxDeepLabV3(classes=5, layers=50, with_aux=True, dropout_scale=0.0,
                        dtype=jnp.float64)


def _port_model(v):
    port = build_model("deeplabv3", layers=50, with_aux=True, dtype=torch.float64).double()
    port.load_state_dict(port_state(v))
    for m in port.modules():
        if isinstance(m, Dropout):
            m.rate = 0.0
    return port


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    tree = jax_generate(str(tmp_path_factory.mktemp("fit_tree")), num_frames=30,
                        size=(96, 128), frame_delta=5, num_labeled=8)
    key = jax.random.PRNGKey(0)
    with jax.enable_x64(True):
        v = _to_dict(jax.device_get(jax.jit(lambda: _jax_model().init(
            {"params": key, "dropout": key}, jnp.zeros((2, CROP, CROP, 3)), train=True))()))
    _perturb_bn(v["params"], v["batch_stats"], np.random.default_rng(33))
    return tree, jax.tree.map(lambda a: np.asarray(a, np.float64), v)


def _flow_transforms_on_exact_grids(cfg, arch):
    tf = FLOW_TRANSFORMS(cfg, arch)
    for t in tf.values():
        t.transforms.append(round_grids)
    return tf


FLOW_TRANSFORMS = fit.flow_transforms


@pytest.fixture(scope="module")
def fits(setup):
    tree, v = setup
    with jax.enable_x64(True):
        ref = jax_fit(tree, _jax_model(), v, FIT, "flow_supervised", CROP, extra=round_grids)
    fit.flow_transforms = _flow_transforms_on_exact_grids
    try:
        return ref, run_flow_fit(_port_model(v), tree, FIT, device="cpu")
    finally:
        fit.flow_transforms = FLOW_TRANSFORMS


def test_fit_loss_matches_jax(fits):
    (ref_loss, _, steps), ours = fits
    assert ours["steps"] == steps == 2 and len(ours["epochs"]) == 1
    assert ours["epochs"][0]["train_loss"] == pytest.approx(ref_loss, rel=1e-5)


def test_fit_validation_matches_jax(fits):
    (_, ref_meter, _), ours = fits
    counts = ours["epochs"][0]["val_counts"]
    for k in ("intersection", "union", "target"):
        np.testing.assert_array_equal(counts[k], getattr(ref_meter, k), err_msg=k)
    assert ours["epochs"][0]["val_miou"] == pytest.approx(ref_meter.summary()["miou"],
                                                          rel=1e-12)
    assert ours["best_epoch"] == 0 and ours["state"].step == 2
