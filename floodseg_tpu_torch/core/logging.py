"""Run logging (counterpart of floodseg_tpu/core/logging.py): metrics.jsonl,
the run summary as metrics.json, the test-image table, and the fit's
resolved config as config.json.

TensorBoard (tensorboardX) and W&B are optional sinks, used only where
they import, as in the JAX module; no device work goes through them.
Without W&B the image table is written as PNGs through the port's own
codec (data/image.py; the card's machine has no PIL). Over the ranks of
a ``world`` (parallel/mesh.py) only rank 0 writes; every rank keeps the
summary.
"""

import json
import os
import time
from typing import Dict, Optional

import numpy as np


class RunLogger:
    def __init__(self, log_dir: str, run_name: str, wandb_project: Optional[str] = None,
                 tags=None, config: Optional[Dict] = None, world=None):
        self.log_dir = os.path.join(log_dir, run_name)
        self.summary: Dict = {}
        self.writes = world is None or world.is_main
        self._jsonl = self._tb = self._wandb = None
        if not self.writes:
            return
        os.makedirs(self.log_dir, exist_ok=True)
        self._jsonl = open(os.path.join(self.log_dir, "metrics.jsonl"), "a")
        try:
            from tensorboardX import SummaryWriter
            self._tb = SummaryWriter(self.log_dir)
        except Exception:
            pass
        if wandb_project:
            try:
                import wandb
                self._wandb = wandb.init(project=wandb_project, name=run_name,
                                         tags=tags or [], config=config or {},
                                         dir=self.log_dir, resume="allow")
            except Exception as e:  # wandb absent or offline
                print(f"[logger] wandb disabled: {e}")

    def log(self, metrics: Dict[str, float], step: int):
        if not self.writes:
            return
        scalars = {k: float(v) for k, v in metrics.items()
                   if isinstance(v, (int, float)) or getattr(v, "ndim", 1) == 0}
        rec = {"step": step, "time": time.time(), **scalars}
        self._jsonl.write(json.dumps(rec) + "\n")
        self._jsonl.flush()
        if self._tb is not None:
            for k, v in scalars.items():
                self._tb.add_scalar(k, v, step)
        if self._wandb is not None:
            self._wandb.log(scalars, step=step)

    def log_image_table(self, key: str, columns, rows):
        """A table of images: rows of uint8 (H, W, 3) arrays, one for each
        column. W&B gets a ``wandb.Table``; without W&B each cell is saved
        as ``<log_dir>/<key>/{row:03d}_{column}.png``."""
        if not self.writes:
            return
        if self._wandb is not None:
            import wandb
            table = wandb.Table(columns=list(columns),
                                data=[[wandb.Image(c) for c in row] for row in rows])
            self._wandb.log({key: table})
            return
        from floodseg_tpu_torch.data.image import write_png
        out = os.path.join(self.log_dir, key)
        os.makedirs(out, exist_ok=True)
        for i, row in enumerate(rows):
            for col, cell in zip(columns, row):
                write_png(os.path.join(out, f"{i:03d}_{col.replace(' ', '_')}.png"),
                          np.asarray(cell, np.uint8))

    def update_summary(self, values: Dict):
        self.summary.update(values)
        if self._wandb is not None:
            for k, v in values.items():
                self._wandb.summary[k] = v

    def write_config(self, config: Dict):
        """The run's resolved config as config.json (None on a rank that
        does not write)."""
        if not self.writes:
            return None
        path = os.path.join(self.log_dir, "config.json")
        with open(path, "w") as f:
            json.dump(config, f, indent=1)
        return path

    def write_metrics_json(self):
        """The run summary as metrics.json (None on a rank that does not
        write)."""
        if not self.writes:
            return None
        path = os.path.join(self.log_dir, "metrics.json")
        with open(path, "w") as f:
            json.dump(self.summary, f, indent=1, default=float)
        return path

    def close(self):
        if not self.writes:
            return
        self.write_metrics_json()
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()
        if self._wandb is not None:
            self._wandb.finish()
