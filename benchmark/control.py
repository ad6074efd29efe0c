"""The readings that the limits of ``correct`` are set from.

    python3 -m benchmark.control --workload <name> --seeds 1,2,... \\
        [--control-seeds 21,22,23] [--fault half_batch --fault-seeds 31,32,33] \\
        [--seconds 6] [--out path.json] [--cpu-test]

In one process, for each seed: one run of the program as the benchmark
runs it (the lower readings), one with the control in the program's place
(the upper readings), and one with a fault planted (faults.py). A
configuration computed in bfloat16 has the program's own int8 path
(``int8_decode`` and ``int8_encode``) as its control; one in float32 with
TF32 off has the reference with TF32 convolutions. The window is short: as
long as it takes to run the windows a run compares. The benchmark's own
runs never run this. Prints one line a run (with the generator's notes on
the comparison) and the summary: for each number, the largest program
reading, the smallest control and fault reading, and their ratio; for each
note, its range by kind of run.
"""

import argparse
import contextlib
import gc
import json
import sys

import torch

from benchmark import faults
from benchmark.core import registry
from benchmark.run import run_cell


def _seeds(text):
    return [int(s) for s in text.split(",") if s]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m benchmark.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=_seeds, default=[])
    ap.add_argument("--control-seeds", type=_seeds, default=[])
    ap.add_argument("--fault", action="append", default=[])
    ap.add_argument("--fault-seeds", type=_seeds, default=[])
    ap.add_argument("--seconds", type=float, default=6.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--cpu-test", action="store_true",
                    help="the mix's small shapes on the CPU (a rehearsal)")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    cell = registry.resolve(registry.load_benchmark(), args.workload)
    generator = cell.traffic["generator"]
    overrides = {"traffic": cell.traffic.get("cpu_test", {})} if args.cpu_test else None
    device = "cpu" if args.cpu_test else args.device
    runs = [("program", s, None) for s in args.seeds]
    runs += [("control", s, None) for s in args.control_seeds]
    runs += [(f"fault:{f}", s, f) for f in args.fault for s in args.fault_seeds]
    rows = []
    for kind, seed, fault in runs:
        plant = faults.plant(generator, fault) if fault else contextlib.nullcontext()
        with plant:
            notes = {}
            r = run_cell(args.workload, seed, args.seconds, False, device=device,
                         require_chips=device == "cuda", overrides=overrides,
                         control=kind == "control", notes=notes)
        checks = {k: v["value"] for k, v in r["checks"].items()}
        rows.append({"kind": kind, "seed": seed, "checks": checks, "notes": notes,
                     "metrics": {k: v["value"] for k, v in r["metrics"].items()}})
        print(json.dumps(rows[-1]), flush=True)
        del r
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()
    summary = {}
    for name in rows[0]["checks"] if rows else []:
        lower = max((r["checks"][name] for r in rows if r["kind"] == "program"), default=None)
        upper = {k: min(r["checks"][name] for r in rows if r["kind"] == k)
                 for k in sorted({r["kind"] for r in rows if r["kind"] != "program"})}
        summary[name] = {"lower": lower, "upper": upper,
                         "ratio": {k: (v / lower if lower else None) for k, v in upper.items()}}
    kinds = sorted({r["kind"] for r in rows})
    ranges = {name: {k: [min(r["notes"][name] for r in rows if r["kind"] == k),
                         max(r["notes"][name] for r in rows if r["kind"] == k)] for k in kinds}
              for name in (rows[0]["notes"] if rows else {})}
    summary["notes"] = ranges
    print(json.dumps({"summary": summary}), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"rows": rows, "summary": summary}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
