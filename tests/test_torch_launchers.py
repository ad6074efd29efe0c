"""The port's launchers (floodseg_tpu_torch/cli/launch.py, sweep.py and
import_ckpt.py) against the scripts that drive the JAX package, and the
two scripts that need no port (scripts/clean.py, scripts/segm_plot_logs.py)
on what the port writes. No test here runs a fit.

- launch: for each method, ``train``/``test``/``predict`` pass the CLI the
  argv scripts/{train,test,predict}.sh pass it, captured by running each
  script under bash with ``python`` stubbed as an exported shell function;
  ``ingress`` runs scripts/ingress_new_video.sh's ffmpeg and extractor
  argv, and raises naming a missing tool;
- sweep: ``--dry_run`` prints scripts/sweep.py's commands but for the
  module name, for every experiments/*.yaml (40 points at two seeds where a
  parameter is continuous; a grid whole and sampled), and the commands'
  overrides resolve in the port's config as in the JAX package's, YAML
  1.1's quirks included (``5e-05`` stays a string);
- import_ckpt: a ``train``, a ``gan`` and a ``u2pl`` state of a narrow
  ViT round-trip through a Lightning checkpoint equal, bit for bit, to
  ``Runner.load_torch_ckpt`` of it, and restore through ``--ckpt_path``;
- the new modules import without JAX, the JAX package, PyYAML,
  matplotlib, cv2 or PIL.
"""

import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from floodseg_tpu.core import config as jax_config

from floodseg_tpu_torch.cli import import_ckpt, launch, sweep
from floodseg_tpu_torch.cli import main as cli
from floodseg_tpu_torch.cli.export_ckpt import roles_from_state
from floodseg_tpu_torch.cli.runner import Runner
from floodseg_tpu_torch.core import config, yaml_subset
from floodseg_tpu_torch.core.checkpoint import CheckpointManager, state_payload
from floodseg_tpu_torch.core.logging import RunLogger
from floodseg_tpu_torch.data.tools import extract_motion_vectors
from floodseg_tpu_torch.models.lightning_export import export_lightning_checkpoint
from floodseg_tpu_torch.segm.train import append_log
from floodseg_tpu_torch.train.state import TrainState

from test_torch_cli import _narrow_build
from test_torch_config import _same

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
METHODS = ("supervised", "flow_supervised", "gan", "flow_gan", "contrastive")
EXTRA = ["--data.train_w", "65", "--tag", "two words", "--device", "cpu"]
EXPERIMENTS = sorted(f for f in os.listdir(os.path.join(REPO, "experiments"))
                     if f.endswith(".yaml"))
LAYERING = {"gan": "train_gan", "supervised": "train_supervised"}


def _script(name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, "scripts", name))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _stubbed(script, *args, tools=("python",)):
    """The argv of each stubbed tool the script calls, in order: each tool
    is a bash function, exported to the script, that prints its name and
    arguments NUL-separated."""
    stubs = "".join(f'{t}() {{ printf "%s\\0" {t} "$@"; printf "\\1"; }}; export -f {t}; '
                    for t in tools)
    out = subprocess.run(["bash", "-c", stubs + 'bash "$@"', "bash",
                          os.path.join(REPO, "scripts", script), *args],
                         cwd=REPO, capture_output=True, check=True).stdout.decode()
    return [call.split("\0")[:-1] for call in out.split("\1")[:-1]]


# ------------------------------------------------------------------ launch

@pytest.mark.parametrize("method", METHODS)
def test_launch_passes_the_scripts_argv(method, monkeypatch):
    seen = []
    monkeypatch.setattr(cli, "main", lambda argv: seen.append(argv) or 0)
    for command, run in (("train", None), ("test", "logs/run"), ("predict", "logs/run2")):
        lead = [method] + ([run] if run else [])
        (call,) = _stubbed(f"{command}.sh", *lead, *EXTRA)
        assert call[:3] == ["python", "-m", "floodseg_tpu.cli.main"], call
        assert launch.main([command, *lead, *EXTRA]) == 0
        assert seen.pop() == call[3:] == launch.cli_argv(command, method, run, EXTRA)
    with pytest.raises(SystemExit, match="usage"):
        launch.main(["test", method])


def test_ingress_runs_the_scripts_tools_and_names_a_missing_one(monkeypatch):
    ffmpeg, python = _stubbed("ingress_new_video.sh", "clips/v 1", tools=("ffmpeg", "python"))
    assert ffmpeg == launch.ffmpeg_argv("clips/v 1")
    assert python[:3] == ["python", "-m", "floodseg_tpu.data.tools.extract_motion_vectors"]
    ran = []
    monkeypatch.setattr(launch.shutil, "which", lambda name: f"/bin/{name}")
    monkeypatch.setattr(launch.importlib.util, "find_spec", lambda name: object())
    monkeypatch.setattr(launch.subprocess, "run",
                        lambda argv: ran.append(argv) or subprocess.CompletedProcess(argv, 0))
    monkeypatch.setattr(extract_motion_vectors, "main", lambda argv: ran.append(argv))
    assert launch.main(["ingress", "clips/v 1"]) == 0
    assert ran == [ffmpeg, python[3:]]
    monkeypatch.setattr(launch.subprocess, "run",
                        lambda argv: subprocess.CompletedProcess(argv, 1))
    with pytest.raises(SystemExit, match="ffmpeg exited 1"):
        launch.ingress("v")
    monkeypatch.setattr(launch.importlib.util, "find_spec", lambda name: None)
    with pytest.raises(SystemExit, match="mvextractor"):
        launch.ingress("v")
    monkeypatch.setattr(launch.shutil, "which", lambda name: None)
    with pytest.raises(SystemExit, match="ffmpeg"):
        launch.ingress("v")


# ------------------------------------------------------------------- sweep

def _continuous(name):
    with open(os.path.join(REPO, "experiments", name)) as f:
        return "min:" in f.read()


def _sweep_cases():
    for name in EXPERIMENTS:
        if _continuous(name):
            yield from ((name, ["--count", "40", "--seed", s]) for s in ("0", "1"))
        else:
            yield from ((name, opts) for opts in ([], ["--count", "3", "--seed", "5"]))


REST = ["--config", "configs/train_base.yaml", "--data.train_w", "433"]


def _dry_run(main, argv, capsys, monkeypatch):
    monkeypatch.setattr(sys, "argv", ["sweep.py", *argv])
    main()
    return capsys.readouterr().out.splitlines()


@pytest.mark.parametrize("name, opts", list(_sweep_cases()))
def test_sweep_dry_run_prints_the_scripts_commands(name, opts, capsys, monkeypatch):
    argv = [os.path.join(REPO, "experiments", name), *opts, "--dry_run", "--", *REST]
    ref = _dry_run(_script("sweep.py").main, argv, capsys, monkeypatch)
    ours = _dry_run(sweep.main, argv, capsys, monkeypatch)
    assert len(ours) == (int(opts[1]) if opts else len(ref)) and len(ours) > 1
    assert ours == [line.replace("floodseg_tpu.cli.main", "floodseg_tpu_torch.cli.main", 1)
                    for line in ref]


@pytest.mark.parametrize("name", [n for n in EXPERIMENTS if _continuous(n)])
def test_continuous_sweep_needs_count(name):
    with pytest.raises(SystemExit, match="need --count"):
        sweep.main([os.path.join(REPO, "experiments", name), "--dry_run"])


@pytest.mark.parametrize("name", EXPERIMENTS)
def test_sweep_overrides_resolve_as_in_jax(name):
    """Points' overrides on their method's layering resolve to the JAX
    package's Config: the first drawn, those printed in exponent form, and
    one with every float parameter at 5e-05. YAML 1.1 reads an exponent
    without a dot (``5e-05``) as a string, so that field holds a string on
    both sides, and one with a dot (``9.1e-05``) as a float."""
    with open(os.path.join(REPO, "experiments", name)) as f:
        params = yaml_subset.load(f.read())["parameters"]
    count = 40 if _continuous(name) else None
    points = sweep.sweep_points(params, count, 0)
    floats = [k for k, p in params.items()
              if "min" in p or any(isinstance(v, float) for v in p["values"])]
    quirk = tuple(5e-05 if k in floats else p["values"][0] for k, p in params.items())
    cmds = sweep.run_commands(params, points, [])
    exponent = [c for c in cmds if any("e-" in a for a in c[:-2])]
    sample = cmds[:3] + exponent[:3] + sweep.run_commands(params, [quirk], [])
    kind = next((k for k in LAYERING if name.startswith(k)), None)
    files = [os.path.join(REPO, "configs", f"{n}.yaml") for n in
             ("train_base", LAYERING.get(kind, "train_flow_supervised"), "dataset_flow")]
    strings = 0
    for cmd in sample:
        argv = cmd[cmd.index("fit") + 1:]
        overrides = config.parse_cli_overrides(argv)
        assert overrides == jax_config.parse_cli_overrides(argv)
        ours = config.load_config(files, overrides)
        _same(config.config_to_dict(ours),
              jax_config.config_to_dict(jax_config.load_config(files, overrides)))
        for key, value in overrides.items():
            if key != "trainer.run_name" and "e-" in value:
                got = config.get_dotted(ours, key)
                assert isinstance(got, str) == ("." not in value), (key, value, got)
                strings += isinstance(got, str)
    assert strings == len(floats)
    if count:
        assert exponent, "40 draws gave no value in exponent form"


# ------------------------------------------------------------- import_ckpt

IMPORT_CASES = {"train": "supervised", "gan": "gan", "u2pl": "contrastive"}
SMALL = ["model.arch=vit", "model.pretrained=false", "data.train_w=64",
         "model.contrastive.bank_capacity=256", "model.contrastive.bank_class0_capacity=512",
         "model.contrastive.max_enqueue=32"]


def _leaves(payload, prefix=""):
    if isinstance(payload, dict):
        for k, v in payload.items():
            yield from _leaves(v, f"{prefix}.{k}")
    elif isinstance(payload, (list, tuple)):
        for i, v in enumerate(payload):
            yield from _leaves(v, f"{prefix}[{i}]")
    else:
        yield prefix, payload


def _bits_equal(a, b):
    a, b = dict(_leaves(a)), dict(_leaves(b))
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], torch.Tensor):
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
            x, y = a[k].detach().cpu().contiguous(), b[k].detach().cpu().contiguous()
            assert torch.equal(x.view(torch.uint8), y.view(torch.uint8)), k
        else:
            assert a[k] == b[k], k


@pytest.mark.parametrize("kind", sorted(IMPORT_CASES))
def test_import_ckpt_round_trip_equals_load_torch_ckpt(kind, tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(Runner, "_build_model", _narrow_build)
    method = IMPORT_CASES[kind]
    files = [os.path.join(REPO, "configs", f"{n}.yaml")
             for n in ("train_base", f"train_{method}", "dataset_flow")]
    sets = SMALL + [f"trainer.log_dir={tmp_path / 'logs'}", "trainer.run_name=imp"]

    def cfg(seed):
        return config.load_config(files, config.parse_cli_overrides(
            [f"--{s}" for s in sets + [f"trainer.seed={seed}"]]))

    # the exported weights are seed 1's, the importing runs draw seed 2's
    exported = Runner(cfg(1), device="cpu")._fresh_state()
    ckpt = tmp_path / "ref.ckpt"
    torch.save(export_lightning_checkpoint("vit", roles_from_state(method, exported), method,
                                           epoch=3), ckpt)
    out = tmp_path / "imported" / "ckpt.pt"
    argv = ["--ckpt", str(ckpt), "--out", str(out), "--device", "cpu"]
    argv += [a for f in files for a in ("--config", f)]
    argv += [a for s in sets + ["trainer.seed=2"] for a in ("--set", s)]
    assert import_ckpt.main(argv) == 0
    assert f"--ckpt_path {out}" in capsys.readouterr().out
    saved = torch.load(out, map_location="cpu", weights_only=False)
    assert saved["kind"] == kind
    want = state_payload(Runner(cfg(2), device="cpu").load_torch_ckpt(str(ckpt)))
    _bits_equal(saved, want)
    fresh = state_payload(Runner(cfg(2), device="cpu")._fresh_state())
    model = {"train": ("model",), "gan": ("generator", "model"),
             "u2pl": ("student", "model")}[kind]
    a, b = saved, fresh
    for k in model:
        a, b = a[k], b[k]
    assert any(not torch.equal(a[k], b[k]) for k in a)  # the import moved the weights
    # cli.main test --ckpt_path <out> restores it through load_for_eval
    restored = Runner(cfg(2), device="cpu").load_for_eval(str(out))
    _bits_equal(state_payload(restored), want)


# ------------------------------------------------------------------ imports

NEW_MODULES = ["floodseg_tpu_torch.cli.launch", "floodseg_tpu_torch.cli.sweep",
               "floodseg_tpu_torch.cli.import_ckpt", "floodseg_tpu_torch.cli.main",
               "floodseg_tpu_torch.cli.runner"]
BANNED = ("jax", "jaxlib", "flax", "floodseg_tpu", "yaml", "matplotlib", "cv2", "PIL")


def test_new_modules_import_without_jax_yaml_or_matplotlib():
    code = "\n".join([
        "import importlib, sys",
        f"for m in {NEW_MODULES!r}:",
        "    importlib.import_module(m)",
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {BANNED!r})",
        "print('BANNED', bad)",
    ])
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "BANNED []" in out.stdout, out.stdout


# ------------------------------------------- the scripts that need no port

def _tiny_state():
    model = torch.nn.Linear(3, 2)
    return TrainState(step=0, model=model, optimizer=torch.optim.SGD(model.parameters(), lr=0.1),
                      schedule=lambda k: 0.1)


def _clean(log_dir, *flags):
    return subprocess.run([sys.executable, os.path.join(REPO, "scripts", "clean.py"),
                           "--log_dir", str(log_dir), *flags], capture_output=True, text=True,
                          check=True).stdout.splitlines()


def test_clean_names_only_the_crashed_port_run(tmp_path):
    runs = {}
    for name in ("crashed", "finished"):
        logger = RunLogger(str(tmp_path), name)
        logger.log({"val_miou_epoch": 0.5}, 1)
        CheckpointManager(os.path.join(logger.log_dir, "checkpoints")).save(
            _tiny_state(), 0, {"val_miou_epoch": 0.5})
        logger.update_summary({"best_val_miou": 0.5})
        if name == "finished":
            logger.close()  # a run that ends writes metrics.json
        runs[name] = os.path.join(logger.log_dir, "checkpoints")
    (line,) = _clean(tmp_path)
    assert line.startswith(f"would delete {runs['crashed']} (") and "incomplete run" in line
    (line,) = _clean(tmp_path, "--apply")
    assert line.startswith(f"DELETE {runs['crashed']} (")
    assert not os.path.exists(runs["crashed"]) and os.path.isdir(runs["finished"])
    with open(os.path.join(os.path.dirname(runs["finished"]), "metrics.json")) as f:
        assert json.load(f) == {"best_val_miou": 0.5}


def test_segm_plot_logs_reads_the_port_segm_log(tmp_path):
    run = tmp_path / "vit_run"
    run.mkdir()
    for epoch in range(3):
        append_log(str(run), epoch, 1.0 / (epoch + 1),
                   {"miou": 0.25 + 0.125 * epoch, "macc": 0.5} if epoch != 1 else None)
    out = subprocess.run([sys.executable, os.path.join(REPO, "scripts", "segm_plot_logs.py"),
                          str(run), "--no-plot"], capture_output=True, text=True, check=True)
    assert out.stdout.splitlines() == ["vit_run:", "   val_mean_iou: 0.5000 (epoch 2)"]
    assert np.isclose(json.loads((run / "log.txt").read_text().splitlines()[1])["train_loss"],
                      0.5)
