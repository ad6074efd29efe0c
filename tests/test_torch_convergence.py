"""The convergence gates of tests/test_convergence.py for the port, on the
CPU: the same synthetic tree, config, seed and floors, each fit through the
port's ``Runner.fit``, then ``restore_best`` and ``test``.

- supervised PSPNet-50: best val mIoU >= 0.40, test-on-best
  ``test_miou1_epoch`` >= 0.30 (tests/test_convergence.py:26);
- flow_supervised PSPNet-50: best val mIoU >= 0.12 (:112); its
  test-on-best is printed, as the JAX gate sets no floor for it.

Both fits are ``slow`` (about 30 epochs of a full-width PSPNet-50 at 65 px),
as the JAX ones are: ``python -m pytest -m slow -s
tests/test_torch_convergence.py``. The fast case holds the resolved config
of each gate, and of chip_smoke.py's phase 27 which runs the same gates on
the card, equal field by field to the JAX package's ``load_config`` of the
gate's YAML.
"""

import json
import os
import time

import pytest
import yaml

from floodseg_tpu.core import config as jax_config

from floodseg_tpu_torch.cli.runner import Runner
from floodseg_tpu_torch.core import config
from floodseg_tpu_torch.data.synthetic import generate_synthetic_dataset

import chip_smoke
from test_torch_config import _same

GATES = {"supervised": {"best_val_miou": 0.40, "test_miou1_epoch": 0.30},
         "flow_supervised": {"best_val_miou": 0.12}}


def gate_cfg(method, root, log_dir, run_name):
    """tests/test_convergence.py's config (:33-47, :118-132), unchanged."""
    return {
        "method": method,
        "trainer": {"max_epochs": 30, "seed": 1,
                    "log_dir": log_dir, "run_name": run_name,
                    "num_devices": 1, "early_stopping_patience": 1000},
        "model": {"arch": "pspnet", "layers": 50, "classes": 5,
                  "test_base_size": 128, "optim": {"lr": 0.01},
                  "loss": {"min_kept": 200}, "pretrained": False,
                  "save_video": False, "save_images": False},
        "data": {"data_root": root, "data_variant": "all", "batch_size": 4,
                 "train_w": 65, "workers": 2, "resize_h": 96, "resize_w": 128,
                 "scale_min": 0.8, "scale_max": 1.2, "frame_delta": 5,
                 "predict_v_id": "synth"},
    }


def _gate_yaml(tmp_path, method, root="data", log_dir="logs", run_name="conv"):
    path = tmp_path / f"{method}.yaml"
    path.write_text(yaml.dump(gate_cfg(method, root, log_dir, run_name)))
    return str(path)


@pytest.mark.parametrize("method", sorted(GATES))
def test_gate_configs_match_jax(tmp_path, method):
    """The port's Config of each gate, from its YAML, equals the JAX
    package's field by field; so does chip_smoke.py's phase 27 config, which
    the script builds without PyYAML."""
    path = _gate_yaml(tmp_path, method, root="/data", log_dir="/logs", run_name="conv")
    ref = jax_config.config_to_dict(jax_config.load_config([path]))
    _same(config.config_to_dict(config.load_config([path])), ref)
    card = chip_smoke.converge_config(method, "/data", "/logs", "conv")
    _same(config.config_to_dict(card), ref)
    assert chip_smoke.CONVERGE_FLOORS[method] == GATES[method]


def _fit_gate(tmp_path, method):
    root = generate_synthetic_dataset(str(tmp_path / "data"), num_frames=30, frame_delta=5,
                                      size=(96, 128), num_labeled=20)
    path = _gate_yaml(tmp_path, method, root, str(tmp_path / "logs"), "conv")
    runner = Runner(config.load_config([path]), device="cpu")
    t0 = time.perf_counter()
    state = runner.fit()
    seconds = time.perf_counter() - t0
    best = runner.logger.summary.get("best_val_miou", 0.0)
    state = runner.restore_best(state)
    results = runner.test(state)
    with open(os.path.join(runner.logger.log_dir, "metrics.jsonl")) as f:
        curve = [r["val_miou_epoch"] for r in map(json.loads, f) if "val_miou_epoch" in r]
    print(f"\n{method} gate (CPU, float32): best val mIoU {best:.4f} at epoch "
          f"{runner.fit_summary['best_epoch']}, test-on-best "
          f"{results['test_miou1_epoch']:.4f}, fit {seconds:.1f} s; val mIoU by epoch "
          f"{[round(v, 4) for v in curve]}")
    runner.logger.close()
    return best, results


@pytest.mark.slow
def test_supervised_fit_converges(tmp_path):
    best, results = _fit_gate(tmp_path, "supervised")
    assert best >= 0.40, (
        f"supervised fit failed to converge: best val mIoU {best:.3f} < 0.40 "
        f"(the JAX gate's floor)")
    assert results["test_miou1_epoch"] >= 0.30, results["test_miou1_epoch"]


@pytest.mark.slow
def test_flow_supervised_fit_converges(tmp_path):
    best, _ = _fit_gate(tmp_path, "flow_supervised")
    assert best >= 0.12, (
        f"flow_supervised fit failed to converge: best val mIoU {best:.3f} < 0.12 "
        f"(the JAX gate's floor)")
