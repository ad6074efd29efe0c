"""Named-phase wall-clock profiler (counterpart of floodseg_tpu/core/profiler.py).

Durations are wall-clock around regions that end with ``sync`` (for work
on the card, ``torch.cuda.synchronize``; ``cuda_sync`` below).

``span(name)`` marks a phase of the program for ``torch.profiler``: while a
profiler records, it is ``record_function(name)``, so the phase lands in
the profiler's trace on the clock of the device's kernels, and each kernel
is tied to the host op that launched it inside the phase. With no profiler
recording it costs one C-level check. Tracing is on exactly when a
profiler is on. ``kernel_launch(name)`` makes a hand-written kernel's
launch a host op, so that the kernel too is tied to the span around it.
"""

import contextlib
import time
from collections import defaultdict
from typing import Dict, List

import numpy as np
import torch


def cuda_sync() -> None:
    """Wait for the card, if there is one (the ``sync`` for card work)."""
    if torch.cuda.is_available():
        torch.cuda.synchronize()


class _Off:
    """The span while no profiler records: enters and leaves nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return None


_OFF = _Off()


def span(name: str):
    """``with span(name):`` a program span named ``name`` while a
    ``torch.profiler`` records (``record_function(name)``); a shared
    no-op context otherwise, so the path with no profiler is one C-level
    check and no allocation."""
    if torch._C._autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _OFF


def kernel_launch(name: str):
    """``with kernel_launch(name):`` around the launch of a hand-written
    kernel from Python (ctypes) while a ``torch.profiler`` records: a host
    op named ``name``, the record that torch's own compiled kernels open
    around their launches. The profiler gives a kernel the ``External id``
    of the innermost host op open at its launch; a span is a user
    annotation and gives none, so under ``span`` alone the kernel would
    belong to no span. A shared no-op context otherwise."""
    if torch._C._autograd._profiler_enabled():
        return torch._C._profiler._RecordFunctionFast(name)
    return _OFF


class PhaseProfiler:
    def __init__(self, sync=None):
        """sync: optional callable run before reading the clock at region end
        (e.g. ``cuda_sync``)."""
        self.recorded_durations: Dict[str, List[float]] = defaultdict(list)
        self._sync = sync

    @contextlib.contextmanager
    def profile(self, name: str):
        """Times the block as region ``name``, inside ``span(name)``."""
        with span(name):
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

