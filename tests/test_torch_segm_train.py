"""The standalone Segmenter trainer (floodseg_tpu_torch/segm/train.py)
against the JAX package's (floodseg_tpu/segm/train.py) on the CPU.

Both trainers run ``--dataset ade20k`` on one synthetic ADE20K-layout tree
(4 training images of 48x64, 2 validation images of 40x56, labels 0..150,
written by the port's codec), with a narrow Segmenter chosen by the flags
both parsers share (d = 64, one head, 1 + 1 layers, patch 32, 64 px crops,
150 classes from the preset), batch 2, dropout 0, one device, and the same
initial weights: JAX's ``create_train_state`` is given variables drawn in
the init's shapes and the port's ``init_model`` loads them through the
bridge. One epoch of 2 steps with its evaluation, then a resume to a second
epoch.

- ``log.txt``: the same keys; each train loss within LOSS_RTOL (1e-5; the
  two packages sum the cross entropy in other orders); the val mIoU and
  mAcc equal.
- The parameters after each epoch (the port's ``last`` checkpoint, JAX's
  saved state): what the epoch changed, p_end - p_start, tensor by tensor
  within STEP_SHARE (1e-3) of its largest change, and every parameter
  within 1e-5 of the tensor's scale.
- The checkpoint directory holds JAX's entries: ``last``,
  ``last-{epoch}.pt`` and the top-k files named by ``val_miou``; an epoch
  without an eval saves only ``last``, and the next run resumes from it.
- The parser takes the JAX trainer's flags with their defaults; a global
  batch beyond the train set and a missing ``--n-cls`` exit as JAX's do;
  without a device the trainer raises on a machine with no card.
- scripts/segm_plot_logs.py reads the port's log.txt.
"""

import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import floodseg_tpu.core.checkpoint as jckpt
import floodseg_tpu.train.state as jstate
from floodseg_tpu.models.vit import SegmenterViT as JaxSegmenterViT
from floodseg_tpu.segm import train as jtrain

from floodseg_tpu_torch.core.checkpoint import read_model_state
from floodseg_tpu_torch.models import from_jax_variables, load_jax_variables
from floodseg_tpu_torch.segm import train

from torch_port_fixtures import numpy_leaves, one_torch_thread, write_ade_tree  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOSS_RTOL = 1e-5
STEP_SHARE = 1e-3
NARROW = ["--im-size", "64", "--patch-size", "32", "--d-model", "64", "--n-layers", "1",
          "--dec-layers", "1", "--batch-size", "2", "--workers", "2", "--num-devices", "1"]


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return write_ade_tree(str(tmp_path_factory.mktemp("ade")))


@pytest.fixture(scope="module")
def init_vars():
    """Float32 variables in the shapes of JAX's init of the narrow model."""
    jm = JaxSegmenterViT(classes=150, image_size=64, patch_size=32, d_model=64, n_layers=1,
                         dec_layers=1, dropout=0.0)
    key = jax.random.PRNGKey(42)
    shapes = jax.eval_shape(lambda: jm.init({"params": key, "dropout": key},
                                            jnp.zeros((1, 64, 64, 3)), train=True))
    return jax.tree.map(lambda a: np.asarray(a, np.float32),
                        numpy_leaves(dict(shapes), np.random.default_rng(9)))


def _jax_run(argv, init_vars, monkeypatch):
    """JAX's main(argv) from ``init_vars``; the params of each epoch's save."""
    saved = []
    orig_state, orig_save = jstate.create_train_state, jckpt.CheckpointManager.save

    def create(model, rng, x, tx, **kw):
        return orig_state(model, rng, x, tx, pretrained_variables=init_vars)

    def save(self, state, epoch, metrics):
        saved.append(jax.tree.map(np.asarray, jax.device_get(
            {"params": state.params, "batch_stats": state.batch_stats})))
        return orig_save(self, state, epoch, metrics)

    monkeypatch.setattr(jstate, "create_train_state", create)
    monkeypatch.setattr(jckpt.CheckpointManager, "save", save)
    assert jtrain.main(argv) == 0
    monkeypatch.undo()
    return saved


def _read_log(log_dir):
    with open(os.path.join(log_dir, "log.txt")) as f:
        return [json.loads(ln) for ln in f]


@pytest.fixture(scope="module")
def runs(tree, init_vars, tmp_path_factory, one_torch_thread):  # noqa: F811
    """Each package's first epoch and its resume to a second one."""
    mp = pytest.MonkeyPatch()
    out = {}
    for name in ("jax", "port"):
        log_dir = str(tmp_path_factory.mktemp(f"segm_{name}"))
        argv = ["--log-dir", log_dir, "--dataset", "ade20k", "--data-root", tree] + NARROW
        if name == "jax":
            saved = _jax_run(argv + ["--epochs", "1"], init_vars, mp)
            saved += _jax_run(argv + ["--epochs", "2"], init_vars, mp)
            params = [from_jax_variables(s) for s in saved]
        else:
            mp.setattr(train, "init_model", lambda model, seed: load_jax_variables(model,
                                                                                   init_vars))
            params = []
            for epochs in ("1", "2"):
                assert train.main(argv + ["--epochs", epochs], device="cpu") == 0
                params.append({k: v.numpy() for k, v in read_model_state(
                    os.path.join(log_dir, "checkpoints", "last")).items()})
            mp.undo()
        out[name] = dict(log_dir=log_dir, log=_read_log(log_dir), params=params)
    return out


def test_log_matches_jax(runs):
    ours, ref = runs["port"]["log"], runs["jax"]["log"]
    assert [sorted(e) for e in ours] == [sorted(e) for e in ref]
    assert [e["epoch"] for e in ours] == [0, 1]
    for a, b in zip(ours, ref):
        np.testing.assert_allclose(a["train_loss"], b["train_loss"], rtol=LOSS_RTOL)
        assert a["val_mean_iou"] == b["val_mean_iou"] and a["val_mean_acc"] == b["val_mean_acc"]


def test_parameters_match_jax_epoch_by_epoch(runs, init_vars):
    start = from_jax_variables(init_vars)
    for epoch, (ours, ref) in enumerate(zip(runs["port"]["params"], runs["jax"]["params"])):
        assert ours.keys() == ref.keys()
        for k in ref:
            scale = float(np.abs(ref[k]).max())
            assert np.abs(ours[k] - ref[k]).max() <= 1e-5 * scale, (epoch, k)
            step = ref[k] - start[k]
            gap = float(np.abs((ours[k] - start[k]) - step).max())
            assert gap <= STEP_SHARE * max(float(np.abs(step).max()), 1e-30), (epoch, k, gap)
        start = ref


def test_checkpoints_match_jax(runs):
    """The same entries as JAX's orbax directory (each a ``.pt`` file):
    ``last``, the last two ``last-{epoch}`` (the older one goes at the next
    save), the top-k by ``val_miou``, the index."""
    names = sorted(os.listdir(os.path.join(runs["port"]["log_dir"], "checkpoints")))
    ref = sorted(os.listdir(os.path.join(runs["jax"]["log_dir"], "checkpoints")))
    assert [n.removesuffix(".pt") for n in names] == ref
    assert "last" in names and "last-1.pt" in names
    assert len([n for n in names if n.startswith("epoch=") and "-val_miou=" in n]) == 2


def test_resume_and_eval_freq_save_only_last(tree, init_vars, tmp_path, monkeypatch, capsys):
    """An epoch without an eval (``--eval-freq 2``) saves only ``last``;
    the next run resumes from it."""
    monkeypatch.setattr(train, "init_model", lambda model, seed: load_jax_variables(model,
                                                                                   init_vars))
    argv = ["--log-dir", str(tmp_path), "--dataset", "ade20k", "--data-root", tree,
            "--eval-freq", "2"] + NARROW
    assert train.main(argv + ["--epochs", "1"], device="cpu") == 0
    assert sorted(os.listdir(tmp_path / "checkpoints")) == ["index.json", "last", "last-0.pt"]
    assert train.main(argv + ["--epochs", "2"], device="cpu") == 0
    assert "resumed from" in capsys.readouterr().out
    log = _read_log(str(tmp_path))
    assert "val_mean_iou" not in log[0] and "val_mean_iou" in log[1]


def test_parser_takes_the_jax_flags():
    def actions(p):
        return {a.dest: (tuple(a.option_strings), a.default, a.type, a.choices, a.required,
                         type(a).__name__) for a in p._actions}
    assert actions(train.build_parser()) == actions(jtrain.build_parser())


def test_exits_as_jax_does(tree, tmp_path):
    argv = ["--log-dir", str(tmp_path), "--dataset", "ade20k", "--data-root", tree] + NARROW
    with pytest.raises(SystemExit, match="global batch 8 .* exceeds the train set"):
        train.main(argv + ["--batch-size", "8"], device="cpu")
    with pytest.raises(SystemExit, match="--n-cls is required"):
        train.main(["--log-dir", str(tmp_path), "--img-dir", tree, "--ann-dir", tree],
                   device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA device"):
            train.main(argv)


def test_plot_logs_script_reads_the_port_log(runs, capsys):
    spec = importlib.util.spec_from_file_location(
        "segm_plot_logs", os.path.join(REPO, "scripts", "segm_plot_logs.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    log_dir = runs["port"]["log_dir"]
    logs = mod.read_logs({"port": os.path.join(log_dir, "log.txt")})
    assert logs["port"] == runs["port"]["log"]
    mod.print_logs(logs, "epoch", "val_mean_iou")
    assert f"val_mean_iou: {runs['port']['log'][-1]['val_mean_iou']:.4f}" in capsys.readouterr().out
