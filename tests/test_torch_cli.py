"""The port's CLI (floodseg_tpu_torch/cli/main.py, cli/runner.py) on the
CPU, on a synthetic tree from the port's data/synthetic.py sized like
tests/test_cli.py's (30 frames of 96x128, n = 5, 6 labeled).

The Runner's model here is a narrow Segmenter ViT/32 (d = 64, one layer
each side) with weights drawn from the run's seed: ``Runner._build_model``
is patched to build it, and the direct calls build the same one; one test
holds the real ``_build_model`` to ``build_model`` of the config. The
layered configs are the repository's (train_base, train_<method>,
dataset_flow, vit) with overrides.

- ``fit`` of each of the five methods gives the weights (the last
  checkpoint) and the summary that the matching ``run_*`` gives for
  ``fit_config`` of the same config, bit for bit;
- ``test``, ``validate`` and ``predict`` (both routes) on the restored
  checkpoint equal ``run_test``, ``run_validate`` and ``run_flow_predict``
  on the same weights, PNGs byte for byte; metrics.json has the keys the
  JAX Runner writes;
- ``--torch_ckpt``: Lightning dicts made by the JAX package's
  ``export_lightning_checkpoint`` from random variables load as the JAX
  importer reads them (``from_jax_variables(import_lightning_checkpoint)``),
  bit for bit, for the bare, ``model.``, rep and s4GAN layouts and the
  FlowPSPNet and FlowDeepLabv3 layouts of flow_supervised and flow_gan
  (their family names too; the model keeps its own aux head);
- ``_pretrained_variables`` maps a reference ResNet as the JAX package's
  ``convert_resnet_backbone`` does, through the weight bridge;
- without ``--device``, on a machine with no card, the CLI raises.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from floodseg_tpu.models import build_model as jax_build_model
from floodseg_tpu.models.discriminator import S4GANDiscriminator as JaxDiscriminator
from floodseg_tpu.models.lightning_export import export_lightning_checkpoint
from floodseg_tpu.models.lightning_import import (
    convert_pspnet_state_dict,
    convert_deeplabv3_state_dict,
    import_lightning_checkpoint,
)
from floodseg_tpu.models.resnet import DEPTH_BLOCKS as JAX_DEPTH_BLOCKS
from floodseg_tpu.models.torch_import import convert_resnet_backbone as jax_convert_resnet
from floodseg_tpu.models.vit import SegmenterViT as JaxSegmenterViT
from floodseg_tpu.train.state import _merge as jax_merge

from floodseg_tpu_torch.cli import main as cli
from floodseg_tpu_torch.cli.runner import Runner
from floodseg_tpu_torch.core.config import config_to_dict, fit_config, load_config
from floodseg_tpu_torch.data import generate_synthetic_dataset
from floodseg_tpu_torch.data.image import imread
from floodseg_tpu_torch.models import SegmenterViT, build_model, from_jax_variables
from floodseg_tpu_torch.models import init_flax_defaults_, init_from_generator_, with_rep
from floodseg_tpu_torch.models.torch_import import convert_resnet_backbone
from floodseg_tpu_torch.train import (
    run_contrastive_fit,
    run_fit,
    run_flow_fit,
    run_flow_predict,
    run_gan_fit,
    run_test,
    run_validate,
)
from floodseg_tpu_torch.train.state import overlay

from torch_port_fixtures import numpy_leaves
from torch_port_fixtures import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VIT = dict(image_size=64, patch_size=32, d_model=64, n_layers=1, dec_layers=1, n_heads=2)
METHODS = ("supervised", "flow_supervised", "gan", "flow_gan", "contrastive")
SEMI = ("gan", "flow_gan", "contrastive")
# the keys the JAX Runner writes to metrics.json after a flow fit
# (floodseg_tpu/cli/runner.py: fit's best, test, predict), the test keys
# for both lists
JAX_FIT_KEYS = {"best_val_miou", "best_epoch"}
JAX_TEST_KEYS = {f"test_{m}{k}_epoch" for m in ("miou", "macc", "accuracy") for k in (1, 2)} | {
    "test_miou1_epoch_classes", "test_miou2_epoch_classes", "test_miou_epoch"}
JAX_PREDICT_KEYS = {"predict_time_mean", "predict_time_sum", "frames", "predict_miou1_epoch",
                    "predict_macc1_epoch", "predict_accuracy1_epoch",
                    "predict_miou1_epoch_classes", "frames_per_second"}
TIMES = ("predict_time_mean", "predict_time_sum", "frames_per_second")


def narrow_vit(seed: int, rep: bool) -> torch.nn.Module:
    model = SegmenterViT(classes=5, **VIT)
    model = with_rep(model) if rep else model
    return init_from_generator_(model.eval(), torch.Generator().manual_seed(seed))


def _narrow_build(self):
    return narrow_vit(self.cfg.trainer.seed,
                      self.cfg.method == "contrastive" and self.cfg.model.semisupervised)


@pytest.fixture(autouse=True)
def narrow(monkeypatch):
    monkeypatch.setattr(Runner, "_build_model", _narrow_build)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return generate_synthetic_dataset(str(tmp_path_factory.mktemp("cli_tree")), num_frames=30,
                                      frame_delta=5, size=(96, 128), num_labeled=6)


def argv(tree, log_dir, method, *extra):
    configs = ["train_base.yaml", f"train_{method}.yaml", "dataset_flow.yaml", "vit.yaml"]
    out = [a for name in configs for a in ("--config", os.path.join(REPO, "configs", name))]
    return out + [
        "--device", "cpu", "--data.data_root", tree, "--data.train_w", "64",
        "--data.resize_h", "96", "--data.resize_w", "128", "--data.scale_min", "0.9",
        "--data.scale_max", "1.1", "--data.frame_delta", "5", "--data.predict_v_id", "synth",
        "--data.workers", "2", "--data.workers_test", "2",
        "--trainer.max_epochs", "2", "--trainer.seed", "1", "--trainer.log_dir", log_dir,
        "--trainer.run_name", method, "--trainer.limit_train_batches", "1",
        "--trainer.limit_val_batches", "1", "--trainer.save_top_k", "2",
        "--model.test_base_size", "128", "--model.loss.min_kept", "200",
        "--model.sup_only_epoch", "1", "--model.contrastive.num_queries", "16",
        "--model.contrastive.num_negatives", "4", "--model.contrastive.max_enqueue", "32",
        "--model.contrastive.bank_capacity", "256",
        "--model.contrastive.bank_class0_capacity", "512", "--model.save_video", "false",
        "--model.pretrained", "false", *extra]


def _records(summary):
    return [{k: v for k, v in r.items() if k != "epoch_time"} for r in summary["epochs"]]


def _same_records(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.keys() == y.keys()
        for k in x:
            if isinstance(x[k], dict):
                for c in x[k]:
                    np.testing.assert_array_equal(x[k][c], y[k][c])
            else:
                assert x[k] == y[k], k


def _state_dict_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(torch.as_tensor(a[k]), torch.as_tensor(b[k])), k


def _direct_fit(method, cfg, tree):
    fc = fit_config(cfg)
    model = narrow_vit(cfg.trainer.seed, method == "contrastive")
    if method == "supervised":
        return run_fit(model, tree, fc, device="cpu")
    if method == "flow_supervised":
        return run_flow_fit(model, tree, fc, device="cpu")
    if method in ("gan", "flow_gan"):
        return run_gan_fit(model, tree, fc, method=method, device="cpu")
    return run_contrastive_fit(model, tree, fc, device="cpu")


def _trained_model(state):
    if isinstance(state, tuple):
        return state[0].model
    return state.student.model if hasattr(state, "student") else state.model


@pytest.mark.parametrize("method", METHODS)
def test_fit_equals_the_direct_run(tree, tmp_path, method):
    """``fit`` through the CLI: the last checkpoint holds the direct run's
    final weights, the best checkpoint the state the CLI ends on, the
    summaries agree; the checkpoints, metrics.jsonl and early_stop.json are
    written."""
    extra = ["--trainer.limit_test_batches", "0"]
    if method in SEMI:
        extra += ["--model.semisupervised", "true"]
    runner = cli.run(["fit", *argv(tree, str(tmp_path), method, *extra)])
    direct = _direct_fit(method, runner.cfg, tree)
    ckpt_dir = tmp_path / method / "checkpoints"
    last = torch.load(ckpt_dir / "last-1.pt", weights_only=False)
    trained = _trained_model(direct["state"])
    payload = last["student"] if method == "contrastive" else (
        last["generator"] if method in ("gan", "flow_gan") else last)
    _state_dict_equal(payload["model"], trained.state_dict())
    assert payload["step"] == 2
    fit = runner.fit_summary
    _same_records(_records(fit), _records(direct))
    assert (fit["best_val_miou"], fit["best_epoch"], fit["steps"]) == (
        direct["best_val_miou"], direct["best_epoch"], direct["steps"]) == (
        fit["best_val_miou"], fit["best_epoch"], 2)
    best = torch.load(runner.ckpt.best_path, weights_only=False)
    best_model = best["student"] if method == "contrastive" else (
        best["generator"] if method in ("gan", "flow_gan") else best)
    _state_dict_equal(best_model["model"], _trained_model(runner.state).state_dict())
    # the best checkpoint ranks by the raw mIoU; early stopping's best
    # (the summary's) needs min_delta more
    top = max(fit["epochs"], key=lambda r: r["val_miou"])
    assert os.path.basename(runner.ckpt.best_path) == (
        f"epoch={top['epoch']}-val_miou_epoch={top['val_miou']:.4f}.pt")
    with open(tmp_path / method / "early_stop.json") as f:
        assert json.load(f)["best_epoch"] == fit["best_epoch"]
    records = [json.loads(line) for line in open(tmp_path / method / "metrics.jsonl")]
    assert [r["epoch"] for r in records if "epoch" in r] == [0, 1]
    assert {"train_loss_epoch", "train_miou_epoch", "epoch_time", "val_miou_epoch",
            "val_macc_epoch", "val_accuracy_epoch"} <= set().union(*records)
    with open(tmp_path / method / "metrics.json") as f:
        keys = set(json.load(f))
    assert keys == JAX_FIT_KEYS | (JAX_PREDICT_KEYS if method.startswith("flow") else set())


@pytest.fixture(scope="module")
def flow_run(tree, tmp_path_factory):
    """A flow_supervised CLI fit with the test after it and its image table."""
    log_dir = str(tmp_path_factory.mktemp("cli_logs"))
    extra = ["--trainer.limit_test_batches", "1", "--trainer.log_test_images", "2"]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(Runner, "_build_model", _narrow_build)
        runner = cli.run(["fit", *argv(tree, log_dir, "flow_supervised", *extra)])
    with open(os.path.join(log_dir, "flow_supervised", "metrics.json")) as f:
        metrics = json.load(f)
    return runner, log_dir, extra, metrics


def _last_weights_model(log_dir):
    last = torch.load(os.path.join(log_dir, "flow_supervised", "checkpoints", "last"),
                      weights_only=False)
    model = narrow_vit(0, False)
    model.load_state_dict(last["model"])
    return model


def test_fit_writes_the_jax_runner_metrics_and_image_table(flow_run):
    runner, log_dir, _, metrics = flow_run
    assert set(metrics) == JAX_FIT_KEYS | JAX_TEST_KEYS | JAX_PREDICT_KEYS
    assert metrics["frames"] == 30
    table = os.path.join(log_dir, "flow_supervised", "test_outputs")
    assert sorted(os.listdir(table)) == [f"{i:03d}_{c}.png" for i in range(2)
                                         for c in ("ground_truth", "image", "prediction")]
    image = imread(os.path.join(table, "000_image.png"))
    assert image.shape == (96, 128, 3) and image.dtype == np.uint8
    with open(os.path.join(log_dir, "flow_supervised", "config.json")) as f:
        assert json.load(f) == json.loads(json.dumps(config_to_dict(runner.cfg)))


def test_test_and_validate_on_the_restored_checkpoint(flow_run, tree):
    """``test`` and ``validate --ckpt_path <run>/checkpoints/last`` equal
    run_test and run_validate on the last checkpoint's weights, and the
    validation equals the fit's own last one (on the same weights; the fit
    loop's validation is held against the JAX Runner's in
    tests/test_torch_train_data.py)."""
    runner, log_dir, extra, _ = flow_run
    ckpt = os.path.join(log_dir, "flow_supervised", "checkpoints", "last")
    args = argv(tree, log_dir, "flow_supervised", *extra, "--ckpt_path", ckpt)
    tested = cli.run(["test", *args])
    model = _last_weights_model(log_dir)
    _state_dict_equal(tested.state.model.state_dict(), model.state_dict())
    fc = fit_config(tested.cfg)
    ours = tested.logger.summary
    ref = run_test(model, tree, fc, "flow_supervised", device="cpu")
    assert ours.keys() == ref.keys() == JAX_TEST_KEYS
    for k in ref:
        assert ours[k] == ref[k], k
    validated = cli.run(["validate", *args])
    assert validated.logger.summary == run_validate(model, tree, fc, "flow_supervised",
                                                    device="cpu")
    assert set(validated.logger.summary) == {"val_miou_epoch", "val_macc_epoch",
                                             "val_accuracy_epoch"}
    last = runner.fit_summary["epochs"][-1]
    assert validated.logger.summary == {"val_miou_epoch": last["val_miou"],
                                        "val_macc_epoch": last["val_macc"],
                                        "val_accuracy_epoch": last["val_accuracy"]}


@pytest.mark.parametrize("no_cropping", [False, True], ids=["crop_route", "cached_route"])
def test_predict_on_the_restored_checkpoint(flow_run, tree, tmp_path, no_cropping):
    """``predict`` on the last checkpoint equals run_flow_predict on its
    weights with the frame size the predict transform gives (the frame
    itself; under no_cropping (64, 96): the crop's height and 1.5x its
    width, rounded for the ViT), maps resized to the frame size; PNGs byte
    for byte."""
    runner, log_dir, extra, _ = flow_run
    args = argv(tree, log_dir, "flow_supervised", *extra, "--model.save_images", "true",
                "--model.no_cropping", str(no_cropping).lower())
    predicted = cli.run(["predict", *args])
    assert predicted._int8_decode() is False
    frame, out = predicted.predict_size()
    assert (frame, out) == (((64, 96) if no_cropping else (96, 128)), (96, 128))
    model = _last_weights_model(log_dir)
    ref = run_flow_predict(model, model.state_dict(), tree, "synth", frame_delta=5,
                           resize=out, crop=(64, 64), no_cropping=no_cropping, workers=2,
                           seed=1, classes_ignore=[5], save_images_dir=str(tmp_path),
                           device="cpu", frame_size=frame)
    ours = predicted.logger.summary
    assert ours.keys() == ref.keys() == JAX_PREDICT_KEYS
    for k in ref:
        if k not in TIMES:
            assert ours[k] == ref[k], k
    pngs = os.path.join(log_dir, "flow_supervised", "frames", "synth")
    names = sorted(os.listdir(tmp_path))
    assert sorted(os.listdir(pngs)) == names and len(names) == ref["frames"] == 30
    for name in names:
        with open(os.path.join(pngs, name), "rb") as f, open(tmp_path / name, "rb") as g:
            assert f.read() == g.read(), name


def test_int8_decode_none_is_the_bf16_decoder(tree, tmp_path):
    for value, want in (("~", False), ("false", False), ("true", True)):
        cfg = load_config([], {"model.arch": "vit", "model.int8_decode": value,
                               "trainer.log_dir": str(tmp_path), "trainer.run_name": "i8"})
        assert Runner(cfg, device="cpu")._int8_decode() is want


def test_cli_without_device_needs_a_card(tree, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    args = [a for a in argv(tree, str(tmp_path), "flow_supervised") if a not in ("--device",
                                                                                 "cpu")]
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["fit", *args])


def test_runner_builds_the_configured_model(monkeypatch, tmp_path):
    """The real ``_build_model``: build_model of the config's arch, depth,
    classes, aux head and rep head, weights drawn from the seed in the JAX
    package's initial distributions (``init_flax_defaults_``, held to
    flax's in tests/test_torch_init.py)."""
    monkeypatch.undo()
    cfg = load_config([os.path.join(REPO, "configs", n) for n in (
        "train_base.yaml", "train_contrastive.yaml", "dataset_flow.yaml", "pspnet.yaml")],
        {"trainer.log_dir": str(tmp_path), "trainer.run_name": "b", "trainer.seed": "3"})
    ours = Runner(cfg, device="cpu").model
    ref = init_flax_defaults_(build_model("pspnet", classes=5, layers=50, with_aux=True,
                                          semisupervised=True),
                              torch.Generator().manual_seed(3))
    _state_dict_equal(ours.state_dict(), ref.state_dict())


# ------------------------------------------------------------- --torch_ckpt

def _leaves(model, x, rng, **init_kw):
    key = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(lambda: model.init({"params": key, "dropout": key}, x, **init_kw))
    return jax.tree.map(lambda a: np.asarray(a, np.float32),
                        numpy_leaves(jax.tree.map(lambda s: s, dict(shapes)), rng))


def _variables(kind, rng):
    x = jnp.zeros((1, 64, 64, 3))
    if kind.removesuffix("_rep") in ("pspnet", "deeplabv3"):
        rep = kind.endswith("_rep")
        # the rep head is made by a training-mode init
        return _leaves(jax_build_model(kind.removesuffix("_rep"), classes=5, layers=50,
                                       with_aux=False, semisupervised=rep),
                       jnp.zeros((1, 65, 65, 3)), rng, train=rep)
    if kind == "disc":
        return _leaves(JaxDiscriminator(num_classes=5), jnp.zeros((1, 64, 64, 8)), rng)
    # the rep head is made by a training-mode init
    return _leaves(JaxSegmenterViT(classes=5, with_rep=kind == "vit_rep", **VIT), x, rng,
                   train=kind == "vit_rep")


def _save(path, ckpt):
    ckpt = dict(ckpt, state_dict={k: torch.from_numpy(np.asarray(v))
                                  for k, v in ckpt["state_dict"].items()})
    torch.save(ckpt, path)
    return ckpt


CASES = {  # name: (arch, method, family, roles)
    "pspnet_bare": ("pspnet", "supervised", "supervised", {"model": "pspnet"}),
    "deeplabv3_wrapper": ("deeplabv3", "supervised", "supervised", {"model": "deeplabv3"}),
    "vit_s4gan": ("vit", "gan", "gan", {"model": "vit", "discriminator": "disc"}),
    "vit_rep_u2pl": ("vit", "contrastive", "contrastive",
                     {"model": "vit_rep", "teacher": "vit_rep"}),
    "pspnet_rep_u2pl": ("pspnet", "contrastive", "contrastive", {"model": "pspnet_rep"}),
    "deeplabv3_rep_u2pl": ("deeplabv3", "contrastive", "contrastive",
                           {"model": "deeplabv3_rep"}),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_torch_ckpt_loads_as_the_jax_importer_reads(tmp_path, monkeypatch, case):
    arch, method, family, roles = CASES[case]
    rng = np.random.default_rng(sorted(CASES).index(case))
    variables = {role: _variables(kind, rng) for role, kind in roles.items()}
    ckpt = _save(tmp_path / "ref.ckpt", export_lightning_checkpoint(
        arch, variables, family, epoch=7))
    imported = import_lightning_checkpoint(ckpt)
    want = {role: from_jax_variables(v) for role, v in imported["roles"].items()}
    if arch != "vit":
        monkeypatch.undo()  # the full-width CNN the config builds
    cfg = load_config([], {"method": method, "model.arch": arch, "model.layers": "50",
                           "model.aux": "false", "model.semisupervised": "true",
                           "data.train_w": "64", "trainer.log_dir": str(tmp_path),
                           "trainer.run_name": "imp", "model.pretrained": "false"})
    runner = Runner(cfg, device="cpu")
    state = runner.load_torch_ckpt(str(tmp_path / "ref.ckpt"))
    got = {"model": runner._eval_model(state).state_dict()}
    if method == "gan":
        got["discriminator"] = state[1].model.state_dict()
    if method == "contrastive":
        teacher = "teacher" in roles
        assert state.teacher_synced is teacher
        assert (runner._eval_model(state) is state.teacher) is teacher
        got = {"model": state.student.model.state_dict(),
               **({"teacher": state.teacher.state_dict()} if teacher else {})}
    assert got.keys() == want.keys()
    for role in want:
        ours = {k: v for k, v in got[role].items() if not k.endswith("num_batches_tracked")}
        ref = {k: torch.from_numpy(v) for k, v in want[role].items()
               if not k.endswith("num_batches_tracked")}
        _state_dict_equal(ours, ref)
    if arch == "pspnet":  # and the CLI subcommand takes it
        with pytest.raises(ValueError, match="config says model.arch"):
            Runner(load_config([], {"model.arch": "deeplabv3", "trainer.log_dir": str(tmp_path),
                                    "trainer.run_name": "x", "model.layers": "50"}),
                   device="cpu").load_torch_ckpt(str(tmp_path / "ref.ckpt"))


FLOW_CASES = [(arch, family) for arch in ("pspnet", "deeplabv3")
              for family in ("flow_supervised", "flow_gan")]


@pytest.mark.parametrize("arch,family", FLOW_CASES)
def test_torch_ckpt_flow_layouts_load_as_the_jax_importer_reads(tmp_path, monkeypatch, capsys,
                                                                arch, family):
    """A FlowPSPNet or FlowDeepLabv3 checkpoint (``model_G.`` with the
    FlowModel wrapper's names, and ``model_D.`` for flow_gan) imports as
    the JAX importer reads it, under its family name, and loads through
    ``load_torch_ckpt`` into a model with an aux head, which keeps its own
    aux head and takes every other entry from the checkpoint."""
    monkeypatch.undo()  # the full-width CNN the config builds
    rng = np.random.default_rng(11 + FLOW_CASES.index((arch, family)))
    variables = {"model": _variables(arch, rng)}
    if family == "flow_gan":
        variables["discriminator"] = _variables("disc", rng)
    ckpt = _save(tmp_path / "flow.ckpt", export_lightning_checkpoint(arch, variables, family,
                                                                     epoch=3))
    jax_imported = import_lightning_checkpoint(ckpt)
    want = {role: from_jax_variables(v) for role, v in jax_imported["roles"].items()}
    from floodseg_tpu_torch.models.torch_import import load_torch_file
    ours = load_torch_file(str(tmp_path / "flow.ckpt"))
    assert (ours["arch"], ours["method_family"], ours["epoch"]) == (arch, family, 3)
    assert jax_imported["method_family"] == family
    assert ours["roles"].keys() == want.keys()
    for role in want:
        _state_dict_equal({k: v for k, v in ours["roles"][role].items()
                           if not k.endswith("num_batches_tracked")},
                          {k: torch.from_numpy(v) for k, v in want[role].items()
                           if not k.endswith("num_batches_tracked")})
    cfg = load_config([], {"method": family, "model.arch": arch, "model.layers": "50",
                           "model.aux": "true", "data.train_w": "64",
                           "trainer.log_dir": str(tmp_path), "trainer.run_name": "imp",
                           "model.pretrained": "false"})
    runner = Runner(cfg, device="cpu")
    fresh = {k: v.clone() for k, v in runner.model.state_dict().items()}
    state = runner.load_torch_ckpt(str(tmp_path / "flow.ckpt"))
    assert "looks like" not in capsys.readouterr().out
    model = state[0].model if family == "flow_gan" else state.model
    aux = "aux." if arch == "pspnet" else "aux_classifier."
    got = model.state_dict()
    assert any(k.startswith(aux) for k in got)
    for k, v in got.items():
        if k.endswith("num_batches_tracked"):
            continue
        ref = fresh[k] if k.startswith(aux) else torch.from_numpy(want["model"][k])
        torch.testing.assert_close(v, ref, rtol=0, atol=0, msg=k)
    if family == "flow_gan":
        _state_dict_equal(state[1].model.state_dict(),
                          {k: torch.from_numpy(v) for k, v in want["discriminator"].items()})


def test_torch_ckpt_through_the_cli(tree, tmp_path):
    """``validate --torch_ckpt`` runs on the imported s4GAN generator."""
    rng = np.random.default_rng(9)
    variables = {"model": _variables("vit", rng), "discriminator": _variables("disc", rng)}
    _save(tmp_path / "g.ckpt", export_lightning_checkpoint("vit", variables, "gan"))
    runner = cli.run(["validate", *argv(tree, str(tmp_path), "gan", "--model.semisupervised",
                                        "true", "--torch_ckpt", str(tmp_path / "g.ckpt"))])
    model = narrow_vit(0, False)
    model.load_state_dict({k: torch.from_numpy(v)
                           for k, v in from_jax_variables(variables["model"]).items()})
    assert runner.logger.summary == run_validate(model, tree, fit_config(runner.cfg), "gan",
                                                 device="cpu")


# ------------------------------------------------------------- pretrained

@pytest.mark.parametrize("arch", ["pspnet", "deeplabv3"])
def test_pretrained_trunk_maps_as_jax(tmp_path, monkeypatch, arch):
    """A reference ResNet state_dict (the pretrained file) through the port's
    convert_resnet_backbone and ``overlay`` gives the state_dict that the
    JAX package's convert_resnet_backbone, merged into the model's
    variables (train/state.py::_merge), gives through the bridge."""
    monkeypatch.undo()
    port = init_from_generator_(build_model(arch, classes=5, layers=50, with_aux=False),
                                torch.Generator().manual_seed(0))
    before = {k: v.numpy().copy() for k, v in port.state_dict().items()}
    # a reference ResNet-50 state_dict in the shapes of the port's trunk
    stem = {"layer0.0": "conv1", "layer0.1": "bn1", "layer0.3": "conv2", "layer0.4": "bn2",
            "layer0.6": "conv3", "layer0.7": "bn3"}
    g = torch.Generator().manual_seed(1)
    ref_sd = {"fc.weight": torch.randn(1000, 2048, generator=g), "fc.bias": torch.zeros(1000)}
    for k, v in before.items():
        if k.endswith("num_batches_tracked"):
            continue
        mod = k.rsplit(".", 1)[0]
        if arch == "pspnet" and mod in stem:
            ref_sd[stem[mod] + k[len(mod):]] = torch.randn(v.shape, generator=g)
        elif arch == "pspnet" and k.startswith("layer"):
            ref_sd[k] = torch.randn(v.shape, generator=g)
        elif arch == "deeplabv3" and k.startswith("backbone."):
            ref_sd[k[len("backbone."):]] = torch.randn(v.shape, generator=g)
    path = tmp_path / "resnet50.pth"
    torch.save(ref_sd, path)
    cfg = load_config([], {"model.arch": arch, "model.layers": "50",
                           "model.pretrained_path": str(path), "trainer.log_dir": str(tmp_path),
                           "trainer.run_name": "p"})
    mapped = Runner._pretrained_variables(type("R", (), {"cfg": cfg})())
    assert mapped.keys() == convert_resnet_backbone(ref_sd, arch, 50).keys()
    ours = overlay(port, mapped).state_dict()
    convert = convert_pspnet_state_dict if arch == "pspnet" else convert_deeplabv3_state_dict
    full = convert(before, 50)
    np_sd = {k: v.numpy() for k, v in ref_sd.items()}
    p, s = jax_convert_resnet(np_sd, JAX_DEPTH_BLOCKS[50], deep_base=arch == "pspnet")
    merged = {"params": jax_merge(full["params"], {"backbone": p}),
              "batch_stats": jax_merge(full["batch_stats"], {"backbone": s})}
    want = from_jax_variables(jax.tree.map(np.asarray, merged))
    assert ours.keys() == want.keys()
    moved = 0
    for k in want:
        assert torch.equal(ours[k], torch.from_numpy(np.array(want[k]))), k
        moved += k in mapped
    assert moved == len(mapped) > 100
