"""Named-phase wall-clock profiler (counterpart of floodseg_tpu/core/profiler.py).

Durations are wall-clock around regions that end with ``sync`` (for work
on the card, ``torch.cuda.synchronize``; ``cuda_sync`` below), and
``device_trace`` captures a torch.profiler trace of a region.
"""

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict, List, Optional

import numpy as np
import torch


def cuda_sync() -> None:
    """Wait for the card, if there is one (the ``sync`` for card work)."""
    if torch.cuda.is_available():
        torch.cuda.synchronize()


class PhaseProfiler:
    def __init__(self, sync=None):
        """sync: optional callable run before reading the clock at region end
        (e.g. ``cuda_sync``)."""
        self.recorded_durations: Dict[str, List[float]] = defaultdict(list)
        self._sync = sync

    @contextlib.contextmanager
    def profile(self, name: str):
        start = time.perf_counter()
        try:
            yield
        finally:
            if self._sync is not None:
                self._sync()
            self.recorded_durations[name].append(time.perf_counter() - start)

    def mean(self, name: str) -> float:
        d = self.recorded_durations.get(name, [])
        return float(np.mean(d)) if d else 0.0

    def sum(self, name: str) -> float:
        return float(np.sum(self.recorded_durations.get(name, [])))

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {
            k: {"mean": float(np.mean(v)), "sum": float(np.sum(v)), "count": len(v)}
            for k, v in self.recorded_durations.items()
        }


@contextlib.contextmanager
def device_trace(log_dir: Optional[str]):
    """torch.profiler over the block (CPU and, with a card, CUDA activity);
    the chrome trace goes to ``log_dir/trace.json``. No ``log_dir``: no
    trace."""
    if not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
