"""The CPU convergence gates of both packages at chosen seeds, for the record.

    python tests/gate_seeds.py --seeds 1 2 3
    python tests/gate_seeds.py --seeds 2 --packages torch --methods supervised
    python tests/gate_seeds.py --seeds 2 --packages torch_jax_init

Each run is the gate of tests/test_convergence.py (``supervised`` and
``flow_supervised``) and of tests/test_torch_convergence.py: the config of
``test_torch_convergence.gate_cfg``, which ``test_gate_configs_match_jax``
holds field by field to the JAX gate's, with ``trainer.seed`` the only
change; each package's own synthetic tree (30 frames at 96x128, 20
labeled) and its own ``Runner`` driven as its gate drives it: ``fit``,
``restore_best``, ``test``, on the CPU in float32, in the tests' CPU mesh
(the repository's conftest.py). It prints one JSON line a run (the
package, method, seed, best val mIoU and its epoch, test-on-best
``test_miou1_epoch``, the fit's seconds, the val mIoU by epoch and the
floors each reading meets or misses) and asserts nothing: the gates
themselves run at seed 1 under ``pytest -m slow``.

``torch_jax_init`` is the port's fit from the JAX Runner's own initial
weights at the seed (its ``model.init`` as ``create_train_state`` draws
it, carried by ``load_jax_variables``), which tells an effect of the
initial weights apart from one of the fit: the two packages then differ
only in their dropout draws and their float32 sums.
"""

import argparse
import json
import os
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.dirname(HERE), HERE]

import conftest  # noqa: E402,F401  the tests' CPU mesh, before JAX starts
import yaml  # noqa: E402

from test_torch_convergence import GATES, gate_cfg  # noqa: E402


def jax_initial_variables(path: str) -> dict:
    """The JAX Runner's initial variables for the config at ``path``: its
    ``model.init`` at ``PRNGKey(trainer.seed)`` on its sample input, as
    floodseg_tpu/train/state.py::create_train_state draws them."""
    import jax

    from floodseg_tpu.cli.runner import Runner
    from floodseg_tpu.core.config import load_config

    runner = Runner(load_config([path], {}))
    rng = runner.rng
    variables = jax.jit(lambda: runner.model.init({"params": rng, "dropout": rng},
                                                  runner.sample_input, train=True))()
    runner.logger.close()
    return jax.device_get(variables)


def run_gate(package: str, method: str, seed: int, workdir: str) -> dict:
    if package == "jax":
        from floodseg_tpu.cli.runner import Runner
        from floodseg_tpu.core.config import load_config
        from floodseg_tpu.data.synthetic import generate_synthetic_dataset
        kwargs = {}
    else:
        from floodseg_tpu_torch.cli.runner import Runner
        from floodseg_tpu_torch.core.config import load_config
        from floodseg_tpu_torch.data.synthetic import generate_synthetic_dataset
        kwargs = {"device": "cpu"}
    root = generate_synthetic_dataset(os.path.join(workdir, "data"), num_frames=30,
                                      frame_delta=5, size=(96, 128), num_labeled=20)
    cfg = gate_cfg(method, root, os.path.join(workdir, "logs"), "conv")
    cfg["trainer"]["seed"] = seed
    path = os.path.join(workdir, f"{method}.yaml")
    with open(path, "w") as f:
        f.write(yaml.dump(cfg))
    if package == "torch_jax_init":
        from floodseg_tpu_torch.models import load_jax_variables
        variables = jax_initial_variables(path)
        cfg["trainer"]["run_name"] = "conv_torch"
        with open(path, "w") as f:
            f.write(yaml.dump(cfg))
    runner = Runner(load_config([path], {}), **kwargs)
    if package == "torch_jax_init":
        load_jax_variables(runner.model, variables)
    t0 = time.perf_counter()
    state = runner.fit()
    seconds = time.perf_counter() - t0
    best = float(runner.logger.summary.get("best_val_miou", 0.0))
    best_epoch = runner.logger.summary.get("best_epoch")
    results = runner.test(runner.restore_best(state))
    with open(os.path.join(runner.logger.log_dir, "metrics.jsonl")) as f:
        curve = [round(r["val_miou_epoch"], 4) for r in map(json.loads, f)
                 if "val_miou_epoch" in r]
    got = {"best_val_miou": best, "test_miou1_epoch": float(results["test_miou1_epoch"])}
    return {"package": package, "method": method, "seed": seed, **got,
            "best_epoch": best_epoch, "fit_seconds": round(seconds, 1),
            "floors": {k: ("held" if got[k] >= floor else "missed") + f" {floor}"
                       for k, floor in GATES[method].items()},
            "val_miou_by_epoch": curve}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--seeds", type=int, nargs="+", default=[1])
    p.add_argument("--packages", nargs="+", default=["jax", "torch"],
                   choices=["jax", "torch", "torch_jax_init"])
    p.add_argument("--methods", nargs="+", default=sorted(GATES), choices=sorted(GATES))
    args = p.parse_args(argv)
    for seed in args.seeds:
        for method in args.methods:
            for package in args.packages:
                with tempfile.TemporaryDirectory() as d:
                    print(json.dumps(run_gate(package, method, seed, d)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
