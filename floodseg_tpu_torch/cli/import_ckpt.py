"""One-command import: a reference Lightning ``.ckpt`` -> a checkpoint of
the port (counterpart of scripts/import_ckpt.py).

    python -m floodseg_tpu_torch.cli.import_ckpt --ckpt logs/run/last.ckpt \\
        --config configs/train_base.yaml --config configs/train_supervised.yaml ... \\
        --out logs/imported/ckpt.pt
    python -m floodseg_tpu_torch.cli.main test --config ... --ckpt_path logs/imported/ckpt.pt

The config (``--config`` files, later ones win, and ``--set K=V``
overrides) selects the method and the architecture, resolved as the CLI
resolves it; ``Runner.load_torch_ckpt`` reads every layout ``--torch_ckpt``
reads (models/torch_import.py) into a fresh state of that method, and the
state's checkpoint payload (core/checkpoint.py::state_payload: a
TrainState's, s4GAN's pair or U2PL's) is written to ``--out`` as one file,
atomically, which ``--ckpt_path`` restores. For a one-shot evaluation
``cli.main test --torch_ckpt`` imports in process. Runs on the card unless
``--device cpu``.
"""

import argparse
import os

import torch


def build_parser():
    ap = argparse.ArgumentParser(prog="floodseg_tpu_torch.cli.import_ckpt",
                                 description=__doc__.split("\n")[0])
    ap.add_argument("--ckpt", required=True,
                    help="reference Lightning .ckpt or bare state_dict .pth")
    ap.add_argument("--config", action="append", default=[],
                    help="config YAML(s) selecting method/arch (repeatable; later files win)")
    ap.add_argument("--out", required=True, help="output checkpoint file")
    ap.add_argument("--set", action="append", default=[], metavar="K=V",
                    help="config dot-overrides, e.g. --set model.arch=pspnet")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    from floodseg_tpu_torch.cli.runner import Runner
    from floodseg_tpu_torch.core.checkpoint import _atomic, state_payload
    from floodseg_tpu_torch.core.config import load_config, parse_cli_overrides

    sets = [kv if kv.startswith("--") else f"--{kv}" for kv in args.set]
    cfg = load_config(args.config, parse_cli_overrides(sets))
    runner = Runner(cfg, device=args.device)
    payload = state_payload(runner.load_torch_ckpt(args.ckpt))
    out = os.path.abspath(args.out)
    os.makedirs(os.path.dirname(out), exist_ok=True)
    _atomic(out, lambda p: torch.save(payload, p))
    flags = [f"--config {c}" for c in args.config] + sets
    if args.device != "cuda":
        flags.append(f"--device {args.device}")
    print(f"wrote {out} (a {payload['kind']!r} checkpoint of {cfg.method}/{cfg.model.arch}); "
          f"evaluate with:\n  python -m floodseg_tpu_torch.cli.main test {' '.join(flags)} "
          f"--ckpt_path {out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
