"""Console metric logging for the standalone Segmenter trainer
(counterpart of floodseg_tpu/segm/logger.py).

``SmoothedValue`` keeps a window of the last values and the running total;
``MetricLogger`` prints every meter's window and global averages every
``print_freq`` items of an iterable. Each logged value is already the
global batch's over the ranks (the step gathers its outputs), so no
reduction happens here.
"""

import time
from collections import deque
from typing import Dict


class SmoothedValue:
    def __init__(self, window: int = 20):
        self.values = deque(maxlen=window)
        self.total = 0.0
        self.count = 0

    def update(self, v: float):
        v = float(v)
        self.values.append(v)
        self.total += v
        self.count += 1

    @property
    def avg(self) -> float:
        return sum(self.values) / max(len(self.values), 1)

    @property
    def global_avg(self) -> float:
        return self.total / max(self.count, 1)


class MetricLogger:
    def __init__(self, delimiter: str = "  "):
        self.meters: Dict[str, SmoothedValue] = {}
        self.delimiter = delimiter

    def update(self, **kwargs):
        for k, v in kwargs.items():
            self.meters.setdefault(k, SmoothedValue()).update(v)

    def __str__(self):
        return self.delimiter.join(
            f"{k}: {m.avg:.4f} ({m.global_avg:.4f})"
            for k, m in self.meters.items()
        )

    def log_every(self, iterable, print_freq: int, header: str = ""):
        t0 = time.time()
        for i, obj in enumerate(iterable):
            yield obj
            if print_freq and (i + 1) % print_freq == 0:
                dt = (time.time() - t0) / (i + 1)
                print(f"{header} [{i + 1}] {self} {dt:.3f}s/it", flush=True)
