"""Every cell, configuration, traffic mix, metric and limit that
BENCHMARK.json names resolves by name, and the file keeps to the
benchmark's contract (keys, names, units, bounds, chips)."""

import json
import math
import re

import pytest

from benchmark.core import registry
from benchmark.tests.helpers import BENCH, ROOT, benchmark_json, cells

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("workload", cells())
def test_cell_resolves(workload):
    bench = benchmark_json()
    cell = registry.resolve(bench, workload)
    assert hasattr(cell.config_module, "REFERENCE") and hasattr(cell.config_module,
                                                                 "program_model")
    assert callable(cell.generator.run)
    for m in cell.per_layer:
        assert callable(cell.per_layer_reader(m).read)
    names = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert cell.per_layer
    numbers = {k: v for k, v in cell.limits.items() if isinstance(v, dict)}
    assert numbers and all("limit" in v for v in numbers.values())


def test_contract_shape():
    bench = benchmark_json()
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= bench["run_seconds"] <= 51
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    for c in bench["configs"]:
        assert set(c) <= {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("benchmark/")
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["reduced"] == c["reduced"]
        assert (ROOT / c["file"]).with_suffix(".py").exists()
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and w["chips"] in (1, 4) and len(w["why"]) <= 200
        assert (BENCH / "traffic" / f"{w['traffic']}.json").exists()
    used = {w["config"] for w in bench["workloads"]}
    assert used == {c["name"] for c in bench["configs"]}
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower",
                                                                                 "higher")
    for m in bench["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e
        for w in m.get("workloads", []):
            moved = e2e[m["moves"]]
            assert "workloads" not in moved or w in moved["workloads"]
        assert (BENCH / "metrics" / f"{m['name']}.py").exists()


def test_check_time_fits():
    """A full check of 24 cells at run_seconds fits the 43200 s a full check may take."""
    rs = benchmark_json()["run_seconds"]
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200
    assert not math.isnan(rs)
