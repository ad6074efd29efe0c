"""Shared by the benchmark's tests: every cell of BENCHMARK.json and its
mix's small CPU shapes (the ``cpu_test`` entry of the traffic file)."""

import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "benchmark"


def benchmark_json() -> dict:
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def cells():
    return [w["name"] for w in benchmark_json()["workloads"]]


def cpu_overrides(workload: str) -> dict:
    w = {c["name"]: c for c in benchmark_json()["workloads"]}[workload]
    with open(BENCH / "traffic" / f"{w['traffic']}.json") as f:
        return {"traffic": json.load(f).get("cpu_test", {})}
