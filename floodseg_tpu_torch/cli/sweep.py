"""Hyperparameter sweeps (counterpart of scripts/sweep.py).

    python -m floodseg_tpu_torch.cli.sweep experiments/lr_example.yaml [--count N]
        [--seed S] [--dry_run] -- --config configs/train_base.yaml ... [--device cpu]

A sweep YAML (read with core/yaml_subset.py) names dot-path parameters,
each a discrete ``values`` list or a continuous ``min``/``max`` range.
With a continuous parameter ``--count`` points are drawn, each parameter
in turn, from ``random.Random(seed)``: ``round(uniform(min, max), 8)`` or
``choice(values)``. Without one the whole grid is run in
``itertools.product`` order, or with ``--count`` the first N of it after
``random.Random(seed).shuffle``: the points scripts/sweep.py draws, in its
order. Each point runs ``python -m floodseg_tpu_torch.cli.main fit <args
after --> --<key> <value>... --trainer.run_name sweep_<leaf>=<value>_...``
in its own process, one after another. ``--dry_run`` prints the commands
alone. A run that fails does not stop the sweep; the sweep exits 1 after
the last point if any failed.
"""

import argparse
import itertools
import random
import subprocess
import sys
from typing import List, Sequence, Tuple

from floodseg_tpu_torch.core import yaml_subset

MODULE = "floodseg_tpu_torch.cli.main"


def sweep_points(params: dict, count=None, seed: int = 0) -> List[Tuple]:
    """The sweep's points, one tuple of values in ``params``' key order each."""
    keys = list(params)
    if any("min" in params[k] for k in keys):
        if count is None:
            raise SystemExit("continuous (min/max) parameters need --count")
        rnd = random.Random(seed)
        return [tuple(round(rnd.uniform(params[k]["min"], params[k]["max"]), 8)
                      if "min" in params[k] else rnd.choice(params[k]["values"])
                      for k in keys)
                for _ in range(count)]
    grid = list(itertools.product(*(params[k]["values"] for k in keys)))
    if count is not None:
        random.Random(seed).shuffle(grid)
        grid = grid[:count]
    return grid


def run_commands(params: dict, points: Sequence[Tuple], rest: Sequence[str]) -> List[List[str]]:
    """One fit command a point: the passthrough args, the point's
    overrides, and its run name."""
    keys = list(params)
    cmds = []
    for point in points:
        overrides = [x for k, v in zip(keys, point) for x in (f"--{k}", str(v))]
        run_name = "sweep_" + "_".join(f"{k.split('.')[-1]}={v}" for k, v in zip(keys, point))
        cmds.append([sys.executable, "-m", MODULE, "fit", *rest, *overrides,
                     "--trainer.run_name", run_name])
    return cmds


def build_parser():
    p = argparse.ArgumentParser(prog="floodseg_tpu_torch.cli.sweep",
                                description=__doc__.split("\n")[0])
    p.add_argument("sweep_yaml")
    p.add_argument("--count", type=int, default=None,
                   help="random-sample N points instead of full grid")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--dry_run", action="store_true",
                   help="print the run commands without launching them")
    return p


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    # everything after a literal "--" goes to every run verbatim
    rest = []
    if "--" in argv:
        split = argv.index("--")
        argv, rest = argv[:split], argv[split + 1:]
    args = build_parser().parse_args(argv)
    with open(args.sweep_yaml) as f:
        params = yaml_subset.load(f.read())["parameters"]
    cmds = run_commands(params, sweep_points(params, args.count, args.seed), rest)
    failed = []
    for i, cmd in enumerate(cmds):
        print(f"[{i + 1}/{len(cmds)}] {' '.join(cmd)}", flush=True)
        if not args.dry_run and subprocess.run(cmd).returncode:
            failed.append(i + 1)
    if failed:
        print(f"sweep: runs {failed} of {len(cmds)} failed", flush=True)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
