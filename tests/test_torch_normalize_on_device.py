"""``data.normalize_on_device`` (train/fit.py) against the JAX Runner's
wiring of it, on the CPU.

The JAX Runner then builds the train transform without ``Normalize``
(``ToFloat``), casts the frame keys of every training loader's batch to
float16 before they cross to the device (``_device_batch``), and
normalises ``(x.float32 - MEAN) / STD`` the frame keys of each step's
(nested) batch inside the jitted step (``_norm_wrap``); validation and
test batches keep the host's normalisation.

Held: the single-frame raw train transform (rotation, MEAN padding) equals
JAX's ``build_train_transform(normalize=False)`` on the same draws (the
flow one: tests/test_torch_train_data.py); a fit of the narrow ViT of
tests/test_torch_train_vit.py (``run_flow_fit``, two steps and a
validation pass, float64, dropout 0) with ``normalize_on_device`` against
``torch_port_fixtures.jax_fit(normalize_on_device=True)``, which runs the
Runner's own ``_device_batch`` and ``_norm_wrap``, within that file's fit
tolerance (the mean loss to rtol 1e-5, the validation counts equal); the
frames reach the step as float16 from the training loader and as float32
from the validation loader; and the fit equals the host-normalised fit
bit for bit, since the train frames are whole grey levels (uint8 through
every transform, the MEAN padding rounded to uint8 as cv2 pads a uint8
frame), which float16 holds exactly.

About 20 s alone (one JAX jit of the ViT's flow step).
"""

import jax
import numpy as np
import pytest
import torch

from floodseg_tpu.data import transforms as jax_tf
from floodseg_tpu.data.dataset import SemDataset as JaxSemDataset
from floodseg_tpu.data.synthetic import generate_synthetic_dataset as jax_generate

from floodseg_tpu_torch.data import SemDataset, transforms
from floodseg_tpu_torch.train import default_fit_config, run_flow_fit
from floodseg_tpu_torch.train import fit as port_fit

from test_torch_train_data import _compare
from test_torch_train_vit import FIT, SIZE, TREE, _init, _jax_model, _port_model
from torch_port_fixtures import jax_fit, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """One synthetic tree: 30 frames of 128x160, 8 labeled."""
    return jax_generate(str(tmp_path_factory.mktemp("norm_tree")), num_frames=30, size=TREE,
                        frame_delta=5, num_labeled=8)


@pytest.mark.parametrize("item", [0, 1, 2])
def test_single_frame_raw_train_transform_matches_jax(tree, item):
    """The single-frame train pipeline without normalising (rotation padded
    with MEAN, blur, flip, a 97 px random crop larger than some scaled
    frames, padded with MEAN) on a train item with the loader's generator:
    frames within 1 grey level, labels equal, every frame float32 holding
    whole grey levels only."""
    args = dict(classes_ignore=[5], scale_min=0.5, scale_max=0.8, resize=TREE,
                normalize=False)
    lst = f"{tree}/list/all/train.txt"
    ref = JaxSemDataset("train", tree, lst, jax_tf.build_train_transform(97, 97, **args))
    ours = SemDataset("train", tree, lst, transforms.build_train_transform(97, 97, **args))
    got = ours.get(item, np.random.default_rng((3, 0, item)))
    _compare(got, ref.get(item, np.random.default_rng((3, 0, item))))
    frame = got["frame_current"]
    assert frame.dtype == np.float32 and np.array_equal(frame, np.round(frame))


@pytest.fixture(scope="module")
def fits(tree, monkeypatch_module):
    """``run_flow_fit`` with normalize_on_device (the dtypes of the frames
    each train and each eval step sees recorded), the same fit normalised
    on the host, and the JAX Runner's wiring."""
    cfg = default_fit_config(**{**FIT.__dict__, "normalize_on_device": True})
    v = _init(27, key=1)
    with jax.enable_x64(True):
        ref = jax_fit(tree, _jax_model(dropout=0.0), v, cfg, "flow_supervised", SIZE,
                      normalize_on_device=True)
    seen = {"train": [], "eval": []}
    normalize, eval_step_for = port_fit.normalize_frames, port_fit.eval_step_for

    def recording_normalize(batch):
        seen["train"].append({k: v.dtype for k, v in batch.items() if k.startswith("frame_")})
        return normalize(batch)

    def recording_eval_step_for(*a):
        step = eval_step_for(*a)

        def run(state, batch):
            seen["eval"].append({k: v.dtype for k, v in batch.items()
                                 if k.startswith("frame_")})
            return step(state, batch)
        return run

    monkeypatch_module.setattr(port_fit, "normalize_frames", recording_normalize)
    monkeypatch_module.setattr(port_fit, "eval_step_for", recording_eval_step_for)
    ours = run_flow_fit(_port_model(v, dropout=0.0), tree, cfg, device="cpu")
    monkeypatch_module.undo()
    host = run_flow_fit(_port_model(v, dropout=0.0), tree, FIT, device="cpu")
    return ref, ours, host, seen


@pytest.fixture(scope="module")
def monkeypatch_module():
    mp = pytest.MonkeyPatch()
    yield mp
    mp.undo()


def test_run_flow_fit_normalize_on_device_matches_jax(fits):
    (ref_loss, ref_meter, steps), ours, _, _ = fits
    assert ours["steps"] == steps == 2 and len(ours["epochs"]) == 1
    assert ours["epochs"][0]["train_loss"] == pytest.approx(ref_loss, rel=1e-5)
    counts = ours["epochs"][0]["val_counts"]
    for k in ("intersection", "union", "target"):
        np.testing.assert_array_equal(counts[k], getattr(ref_meter, k), err_msg=k)


def test_frames_reach_the_step_as_float16_from_the_training_loaders_only(fits):
    """Each train step's frames arrive as float16 (three keys: the flow
    item's current, previous and next frames); each validation batch's as
    float32, normalised on the host."""
    *_, seen = fits
    assert len(seen["train"]) == 2 and len(seen["eval"]) >= 1
    for dtypes in seen["train"]:
        assert set(dtypes) == {"frame_current", "frame_prev", "frame_next"}
        assert all(d == torch.float16 for d in dtypes.values())
    for dtypes in seen["eval"]:
        assert dtypes and all(d == torch.float32 for d in dtypes.values())


def test_normalize_on_device_fit_equals_the_host_normalised_fit(fits):
    """Whole grey levels survive float16, and ``(x.float() - MEAN) / STD``
    on the device is the host's float32 arithmetic: the two fits' losses,
    validation counts and final weights are equal."""
    _, ours, host, _ = fits
    assert ours["epochs"][0]["train_loss"] == host["epochs"][0]["train_loss"]
    for k in ("intersection", "union", "target"):
        np.testing.assert_array_equal(ours["epochs"][0]["val_counts"][k],
                                      host["epochs"][0]["val_counts"][k])
    a, b = ours["state"].model.state_dict(), host["state"].model.state_dict()
    for k in a:
        assert torch.equal(a[k], b[k]), k
