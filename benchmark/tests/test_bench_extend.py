"""A configuration, a traffic mix, a per-layer metric and a cell added as
new files and entries run with no edit to any file the benchmark has."""

import json
import shutil
import subprocess
import sys

from benchmark.tests.helpers import ROOT


def test_new_files_run_without_edits(tmp_path):
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    b = tmp_path / "benchmark"
    before = {p: p.read_bytes() for p in b.rglob("*") if p.is_file()}

    cfg = json.loads((b / "configs" / "pspnet50.json").read_text())
    cfg.update(name="pspnet50-float32", dtype="float32")
    (b / "configs" / "pspnet50-float32.json").write_text(json.dumps(cfg))
    (b / "configs" / "pspnet50-float32.py").write_text(
        "from benchmark.core.program import port_model\n"
        "from benchmark.reference import pspnet as REFERENCE\n\n\n"
        "def program_model(cfg, weights, device):\n"
        "    return port_model('pspnet', cfg, weights, device)\n")
    mix = json.loads((b / "traffic" / "flow-video.json").read_text())
    mix.update(mix.pop("cpu_test"), videos=1, windows_per_video=4, check_within=4)
    (b / "traffic" / "flow-short.json").write_text(json.dumps(mix))
    (b / "metrics" / "windows_run.py").write_text(
        "def read(run):\n    return float(len(run.units))\n")
    (b / "limits" / "pspnet50-float32.flow-short.json").write_text(
        (b / "limits" / "pspnet50.flow-video.json").read_text())
    bench["configs"].append({"name": "pspnet50-float32", "source": "https://arxiv.org/abs/1612.01105",
                             "file": "benchmark/configs/pspnet50-float32.json", "reduced": []})
    bench["workloads"].append({"name": "pspnet50-float32.flow-short", "config": "pspnet50-float32",
                               "traffic": "flow-short", "chips": 1, "why": "a test cell"})
    bench["per_layer"].append({"name": "windows_run", "unit": "windows", "better": "higher",
                               "source": "program_counter", "layer": "predict builders",
                               "moves": "frames_per_s",
                               "workloads": ["pspnet50-float32.flow-short"]})
    for m in bench["end_to_end"]:
        if "workloads" in m and "pspnet50.flow-video" in m["workloads"]:
            m["workloads"].append("pspnet50-float32.flow-short")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    code = ("import json\n"
            "from benchmark import run\n"
            "r = run.run_cell('pspnet50-float32.flow-short', 3, 0.3, True, device='cpu',\n"
            "                 require_chips=False)\n"
            "print(json.dumps(r))\n")
    env_path = f"{tmp_path}:{ROOT}"
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                         text=True, timeout=600, check=True,
                         env={"PYTHONPATH": env_path, "PATH": "/usr/bin:/bin",
                              "HOME": str(tmp_path)}).stdout
    r = json.loads(out.strip().splitlines()[-1])
    assert r["correct"] and r["metrics"]["windows_run"]["value"] >= 1
    after = {p: p.read_bytes() for p in before}
    assert after == before


def test_benchmark_files_alone_give_no_result(tmp_path):
    """In a directory that holds only BENCHMARK.json and the benchmark's
    files, a run finds no program and prints no result."""
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    code = ("import json\n"
            "from benchmark import run\n"
            "from benchmark.tests.helpers import cells, cpu_overrides\n"
            "w = cells()[0]\n"
            "r = run.run_cell(w, 3, 0.3, False, device='cpu', require_chips=False,\n"
            "                 overrides=cpu_overrides(w))\n"
            "run.emit(r)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                          text=True, timeout=600,
                          env={"PYTHONPATH": str(tmp_path), "PATH": "/usr/bin:/bin",
                               "HOME": str(tmp_path)})
    assert proc.returncode != 0 and proc.stdout == ""
    assert "floodseg_tpu_torch" in proc.stderr
