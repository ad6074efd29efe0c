"""One-command export: a checkpoint of the port -> a reference Lightning
``.ckpt`` (counterpart of scripts/export_ckpt.py).

    python -m floodseg_tpu_torch.cli.export_ckpt --config configs/train_base.yaml \\
        --config configs/train_flow_supervised.yaml ... --ckpt LOG/checkpoints/last \\
        --out exported.ckpt

The config selects the method and the architecture; ``--ckpt`` is a
checkpoint the port's CLI wrote (default: the config run's last, else
best). The state_dict is the reference's layout for that method
(models/lightning_export.py), loadable by the reference's own stack and
by ``--torch_ckpt``. Runs on the card unless ``--device cpu``.
"""

import argparse

import torch


def roles_from_state(method: str, state) -> dict:
    """A Runner state -> the per-role state_dicts the exporter takes (the
    inverse of ``Runner._graft_torch_ckpt``'s dispatch)."""
    if method in ("gan", "flow_gan"):
        sg, sd = state
        return {"model": sg.model.state_dict(), "discriminator": sd.model.state_dict()}
    if method == "contrastive":
        return {"model": state.student.model.state_dict(),
                "teacher": state.teacher.state_dict()}
    return {"model": state.model.state_dict()}


def build_parser():
    ap = argparse.ArgumentParser(prog="floodseg_tpu_torch.cli.export_ckpt",
                                 description=__doc__.split("\n")[0])
    ap.add_argument("--config", action="append", default=[],
                    help="config YAML(s) selecting method/arch (repeatable; later files win)")
    ap.add_argument("--ckpt", default=None,
                    help="checkpoint file (default: the config run's last/best checkpoint)")
    ap.add_argument("--out", required=True, help="output .ckpt path")
    ap.add_argument("--epoch", type=int, default=None,
                    help="epoch number to stamp into the checkpoint")
    ap.add_argument("--set", action="append", default=[], metavar="K=V",
                    help="config dot-overrides, e.g. --set model.arch=pspnet")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    from floodseg_tpu_torch.cli.runner import Runner
    from floodseg_tpu_torch.core.config import load_config, parse_cli_overrides
    from floodseg_tpu_torch.models.lightning_export import export_lightning_checkpoint

    cfg = load_config(args.config, parse_cli_overrides(
        [kv if kv.startswith("--") else f"--{kv}" for kv in args.set]))
    runner = Runner(cfg, device=args.device)
    path = args.ckpt or runner.ckpt.last_path or runner.ckpt.best_path
    if path is None:
        raise SystemExit(
            "no checkpoint to export: pass --ckpt <file>, or point --config at a run "
            f"whose log dir holds one (this config resolves to {runner.logger.log_dir!r} "
            "with no checkpoints)")
    state = runner.load_for_eval(path)
    ckpt = export_lightning_checkpoint(cfg.model.arch, roles_from_state(cfg.method, state),
                                       cfg.method, epoch=args.epoch)
    torch.save(ckpt, args.out)
    print(f"wrote {args.out} ({len(ckpt['state_dict'])} tensors, "
          f"{cfg.method}/{cfg.model.arch} Lightning layout)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
