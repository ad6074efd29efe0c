"""Run one cell of the benchmark once and print its result line.

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cell's configuration, traffic mix, per-layer metrics and limits are
found by name (core/registry.py). The run makes its weights and inputs on
the card from the seed, warms up the cell's shapes, measures for
``--seconds``, and with ``--trace 1`` profiles a short stretch after the
window; then the plain reference checks what the window produced. The last
lines of standard error are the numbers compared, each beside its limit;
the last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics``, ``device`` (and with ``--trace 1``
``breakdown``), and ``checks`` last.

It exits non-zero without a result when there is no CUDA device or fewer
than the cell asks for, and when the process holds a module of JAX or of
the JAX package once the window has closed.
"""

import argparse
import json
import os
import sys
from pathlib import Path
from typing import List, Optional

from benchmark.core.clock import process_age_s

FORBIDDEN = ("jax", "jaxlib", "flax", "floodseg_tpu")
TRACE_DIR = Path(__file__).resolve().parents[1] / "build" / "bench"


def forbidden_modules() -> List[str]:
    """Modules of JAX or of the JAX package in this process, compared by
    whole top-level name (``floodseg_tpu_torch`` is not ``floodseg_tpu``)."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN))


def _device_info(torch, dev, chips: int, peak: int, stretch) -> dict:
    if dev.type == "cuda":
        info = {"platform": "gpu", "kind": torch.cuda.get_device_name(dev), "count": chips,
                "memory_peak_bytes": int(peak)}
    else:
        info = {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": int(peak)}
    if stretch is not None:
        info["busy_s"] = stretch.busy_s
        info["window_s"] = stretch.window_s
    return info


def run_cell(workload: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
             require_chips: bool = True, overrides: Optional[dict] = None,
             control: bool = False, check_imports: bool = True,
             notes: Optional[dict] = None) -> Optional[dict]:
    """One run of ``workload``: returns the result line as a dict, or None
    after naming on standard error why there is none. ``require_chips``
    False skips the look for the card (the tests' runs on the CPU);
    ``overrides`` replace entries of the configuration and the mix;
    ``control`` puts the control in the program's place (control.py);
    ``check_imports`` False leaves out the look for JAX's modules (tests in
    a process whose test set-up imported JAX; a fresh process checks it);
    ``notes``, a dict, receives the generator's notes on the comparison."""
    import torch

    from benchmark.core import registry
    from benchmark.core.outcome import Options
    from benchmark.core.trace import breakdown

    from benchmark.core.clock import log

    log("torch imported")
    cell = registry.resolve(registry.load_benchmark(), workload, overrides)
    if require_chips:
        if not torch.cuda.is_available():
            print("no CUDA device: the benchmark measures the port on the card",
                  file=sys.stderr)
            return None
        if torch.cuda.device_count() < cell.chips:
            print(f"{workload} needs {cell.chips} CUDA devices, "
                  f"{torch.cuda.device_count()} present", file=sys.stderr)
            return None
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.init()
        log("CUDA initialised")
    trace_path = str(TRACE_DIR / f"{workload}.trace.json")
    opts = Options(seed, seconds, trace, dev, trace_path, control)
    setup = {}
    outcome = cell.generator.run(cell, opts, lambda: setup.setdefault("s", process_age_s()))
    if notes is not None:
        notes.update(outcome.notes)
    found = forbidden_modules() if check_imports else []
    if found:
        print(f"the run's process holds {found}: the benchmark measures the port alone",
              file=sys.stderr)
        return None

    reading = outcome.reading
    if trace:
        metrics = {}
        for m in cell.per_layer:
            value = cell.per_layer_reader(m).read(reading)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = {**outcome.end_to_end, "setup_s": setup["s"]}
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    result = {"correct": all(c.ok for c in outcome.checks),
              "attempted": outcome.attempted, "failed": outcome.failed,
              "metrics": metrics,
              "device": _device_info(torch, dev, cell.chips, outcome.memory_peak_bytes,
                                     reading.stretch)}
    if trace and reading.stretch is not None:
        result["breakdown"] = breakdown(reading.stretch)
    result["checks"] = {c.name: {"value": c.value, "limit": c.limit}
                        for c in outcome.checks}
    return result


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m benchmark.run", description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    os.environ.setdefault("USE_FLAX", "0")
    result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace))
    if result is None:
        return 2
    emit(result)
    return 0


def emit(result: dict) -> None:
    """The numbers compared, each beside its limit, as the last lines of
    standard error; the result as the last line of standard output."""
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    sys.exit(main())
