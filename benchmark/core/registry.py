"""Finds each piece of a cell by its name in ``BENCHMARK.json``.

- configuration ``<c>``: its ``file`` (``configs/<c>.json``, the sizes as
  run) and ``configs/<c>.py`` beside it (builds the program's model and
  names the plain reference);
- traffic mix ``<t>``: ``traffic/<t>.json``, the parameters that the
  general generator it names (``generators/<generator>.py``) reads;
- per-layer metric ``<m>``: ``metrics/<m>.py``, a reader with ``read(run)``;
- the limits of the comparison that decides ``correct``:
  ``limits/<workload>.json``.

Nothing here needs an edit when a later change adds a cell, a
configuration, a mix or a metric as new files and entries.
"""

import importlib.util
import json
import re
import sys
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


def load_module(path: Path, kind: str) -> ModuleType:
    """Import the file at ``path`` as ``benchmark._loaded.<kind>.<stem>``."""
    safe = re.sub(r"[^0-9A-Za-z_]", "_", path.stem)
    name = f"benchmark._loaded.{kind}.{safe}"
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {path}")
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


def _read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    name: str
    chips: int
    config: dict              # the configuration's file, as run
    config_module: ModuleType
    traffic: dict             # the mix's parameters
    generator: ModuleType
    limits: dict              # number compared -> {"limit": ...}
    end_to_end: List[dict]    # the metrics this cell reports with --trace 0
    per_layer: List[dict]     # and with --trace 1

    def per_layer_reader(self, metric: dict) -> ModuleType:
        return load_module(BENCH_DIR / "metrics" / f"{metric['name']}.py", "metrics")


def load_benchmark(path: Optional[Path] = None) -> dict:
    return _read_json(path or ROOT / "BENCHMARK.json")


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def resolve(bench: dict, workload: str, overrides: Optional[Dict[str, dict]] = None) -> Cell:
    """The cell ``workload`` of ``bench`` with its files loaded.
    ``overrides`` ({"config": {...}, "traffic": {...}}) replace entries of
    the loaded files: the tests' small shapes on the CPU."""
    overrides = overrides or {}
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json: {sorted(cells)}")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    entry = configs[w["config"]]
    config_file = ROOT / entry["file"]
    config = {**_read_json(config_file), **overrides.get("config", {})}
    config_module = load_module(config_file.with_suffix(".py"), "configs")
    traffic = {**_read_json(BENCH_DIR / "traffic" / f"{w['traffic']}.json"),
               **overrides.get("traffic", {})}
    generator = load_module(BENCH_DIR / "generators" / f"{traffic['generator']}.py",
                            "generators")
    limits = _read_json(BENCH_DIR / "limits" / f"{workload}.json")
    return Cell(workload, int(w["chips"]), config, config_module, traffic, generator, limits,
                [m for m in bench["end_to_end"] if _applies(m, workload)],
                [m for m in bench["per_layer"] if _applies(m, workload)])
