"""Each cell's path, at its mix's small shapes on the CPU (the kernels'
plain versions), prints a well-formed last line, with and without the
trace; and a fresh process that ran the harness holds no JAX module."""

import json
import subprocess
import sys

import pytest

from benchmark import run
from benchmark.tests.helpers import ROOT, cells, cpu_overrides

SEED = 2 ** 31 + 11


def _well_formed(line: str, trace: bool, workload: str) -> dict:
    r = json.loads(line)
    assert list(r)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(r)
    assert isinstance(r["correct"], bool) and r["attempted"] >= 1 and r["failed"] == 0
    for name, m in r["metrics"].items():
        assert set(m) == {"value", "unit"} and isinstance(m["value"], float), name
    for c in r["checks"].values():
        assert set(c) == {"value", "limit"}
    if trace:
        assert {"busy_s", "window_s"} <= set(r["device"])
        assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert "setup_s" in r["metrics"]
    return r


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("workload", cells())
def test_cell_prints_a_well_formed_line(workload, trace, capsys):
    result = run.run_cell(workload, SEED, 0.5, trace, device="cpu", require_chips=False,
                          overrides=cpu_overrides(workload), check_imports=False)
    run.emit(result)
    out, err = capsys.readouterr()
    r = _well_formed(out.strip().splitlines()[-1], trace, workload)
    assert r["correct"], r["checks"]
    assert err.strip().splitlines()[-len(r["checks"]):][0].startswith("check ")


def test_a_run_loads_no_jax():
    code = ("import json, sys\n"
            "from benchmark import run\n"
            "from benchmark.tests.helpers import cells, cpu_overrides\n"
            "for w in cells():\n"
            "    r = run.run_cell(w, 5, 0.2, True, device='cpu', require_chips=False,\n"
            "                     overrides=cpu_overrides(w))\n"
            "    assert r is not None\n"
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=600, check=True).stdout
    tops = set(json.loads(out.strip().splitlines()[-1]))
    assert "floodseg_tpu_torch" in tops and "benchmark" in tops
    assert not tops & set(run.FORBIDDEN), tops & set(run.FORBIDDEN)


def test_reference_imports_nothing_of_the_program():
    code = ("import sys, benchmark.reference.pspnet, benchmark.reference.deeplabv3, "
            "benchmark.reference.flow, benchmark.reference.train\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120, check=True).stdout
    assert "floodseg_tpu_torch" not in out and "'jax'" not in out


def test_no_card_no_result(monkeypatch, capsys):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert run.main(["--workload", cells()[0], "--seed", "1", "--seconds", "1"]) != 0
    out, err = capsys.readouterr()
    assert out == "" and "no CUDA device" in err
