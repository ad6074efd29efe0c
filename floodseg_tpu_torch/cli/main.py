"""CLI (counterpart of floodseg_tpu/cli/main.py):

    python -m floodseg_tpu_torch.cli.main {fit,validate,test,predict}
        [--config X.yaml]... [--method M] [--ckpt_path P] [--torch_ckpt P]
        [--device cuda|cpu] [--model.arch vit] [--data.batch_size 4] ...

Layered ``--config`` YAMLs (later files win) with dot-path overrides, as
the JAX package's CLI takes them. ``fit`` trains, restores the best
checkpoint, tests and, for the flow methods, predicts, then writes
metrics.json; ``validate``, ``test`` and ``predict`` run on ``--ckpt_path``
(or the run's last checkpoint) or on ``--torch_ckpt``'s reference weights.

``--device`` (default ``cuda``) is the port's counterpart of the JAX
package's ``JAX_PLATFORMS``: ``cuda`` without a card raises, ``cpu`` runs
the plain PyTorch path. ``trainer.debug_nans`` turns on
``torch.autograd.set_detect_anomaly`` for the run.

Several ranks, one process a GPU: set FLOODSEG_MULTIHOST and launch one
process a rank, e.g. ``torchrun --nproc_per_node 4 -m
floodseg_tpu_torch.cli.main fit ...`` (``env://``), or with
FLOODSEG_COORDINATOR=host:port, FLOODSEG_NUM_PROCESSES and
FLOODSEG_PROCESS_ID in each process (parallel/dist.py). Under ``--device
cpu`` the ranks run on gloo.
"""

import argparse
import sys

import numpy as np
import torch

from floodseg_tpu_torch.cli.runner import Runner
from floodseg_tpu_torch.core.config import load_config, parse_cli_overrides
from floodseg_tpu_torch.parallel.dist import maybe_initialize_multihost


def build_parser():
    p = argparse.ArgumentParser(prog="floodseg_tpu_torch")
    p.add_argument("subcommand", choices=["fit", "validate", "test", "predict"])
    p.add_argument("--config", action="append", default=[],
                   help="YAML config (repeatable; later files win)")
    p.add_argument("--method", default=None,
                   help="supervised|gan|contrastive|flow_supervised|flow_gan")
    p.add_argument("--ckpt_path", default=None)
    p.add_argument("--torch_ckpt", default=None,
                   help="a reference Lightning .ckpt (or bare state_dict file): "
                        "validate/test/predict run on its weights (instead of --ckpt_path); "
                        "fit warm-starts from them with a fresh optimizer")
    p.add_argument("--wandb", default=None)
    p.add_argument("--runid", default=None)
    p.add_argument("--tag", default=None)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    return p


def _shown(results):
    return {k: v for k, v in results.items() if not isinstance(v, list)}


def run(argv=None) -> Runner:
    """``main`` without the exit code: parse, dispatch, close the logger,
    and return the Runner (``runner.state`` is the state the subcommand
    ran on, ``runner.fit_summary`` the fit's summary)."""
    argv = list(sys.argv[1:] if argv is None else argv)
    args, extra = build_parser().parse_known_args(argv)
    cfg = load_config(args.config, parse_cli_overrides(extra))
    if args.method:
        cfg.method = args.method
    if args.ckpt_path:
        cfg.ckpt_path = args.ckpt_path
    if args.wandb:
        cfg.wandb = args.wandb
    if args.runid:
        cfg.runid = args.runid
    if args.tag:
        cfg.tag = args.tag
    if args.seed is not None:
        cfg.trainer.seed = args.seed
    np.random.seed(cfg.trainer.seed)

    # several ranks: one process a GPU (parallel/dist.py), where the JAX CLI
    # calls jax.distributed.initialize
    ranks = maybe_initialize_multihost(device=args.device)
    runner = Runner(cfg, device=args.device)
    with torch.autograd.set_detect_anomaly(cfg.trainer.debug_nans):
        if args.subcommand == "fit":
            state = runner.fit(torch_ckpt=args.torch_ckpt)
            # the test and predict after a fit run on the best checkpoint
            state = runner.restore_best(state)
            print("test:", _shown(runner.test(state)))
            if runner.is_flow:
                print("predict:", _shown(runner.predict(state)))
        else:
            state = (runner.load_torch_ckpt(args.torch_ckpt) if args.torch_ckpt
                     else runner.load_for_eval(cfg.ckpt_path))
            if args.subcommand == "validate":
                print("validate:", runner.validate(state))
            elif args.subcommand == "test":
                print("test:", _shown(runner.test(state)))
            else:
                print("predict:", _shown(runner.predict(state)))
    runner.logger.close()
    if ranks:
        torch.distributed.destroy_process_group()
    return runner


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
