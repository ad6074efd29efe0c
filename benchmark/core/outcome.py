"""What a generator hands back to the harness, and what the per-layer
readers read.

A generator measures its window with tracing off, profiles a short stretch
after it when asked (``--trace 1``), reads the device's peak memory, frees
the program's state, and only then runs the plain reference over what the
window produced and returns the numbers compared (``Check``) with their
limits.
"""

import math
import random
import zlib
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from benchmark.core.trace import Stretch


@dataclass
class Options:
    seed: int
    seconds: float
    trace: bool
    device: "object"            # torch.device
    trace_path: str
    control: bool = False       # run the control in the program's place (control.py)


@dataclass
class Unit:
    """One timed unit (a window or a step) of the measured window."""
    kind: str                   # "full" / "cached" window, or "step"
    enqueue_s: float            # host seconds from entering the call to its return
    total_s: float              # to the sync that completes it (windows)
    flops: int                  # model operations of the unit (the reference's count)


@dataclass
class Reading:
    """What the per-layer readers read: the measured window's units and
    length, the profiled stretch, counters the generator computed, the cell's
    configuration and mix."""
    config: dict
    traffic: dict
    units: List[Unit]
    window_s: float
    stretch: Optional[Stretch] = None
    counters: Dict[str, float] = field(default_factory=dict)


@dataclass
class Check:
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return math.isfinite(self.value) and self.value <= self.limit


@dataclass
class Outcome:
    end_to_end: Dict[str, float]
    attempted: int
    failed: int
    checks: List[Check]
    reading: Reading
    memory_peak_bytes: int
    notes: Dict[str, float] = field(default_factory=dict)   # for control.py, never compared


def sub_seed(seed: int, tag: str) -> int:
    """A 63-bit seed for one stream (weights, inputs, sampling) of a run."""
    return random.Random(f"{seed}:{zlib.crc32(tag.encode())}").getrandbits(63)


def p95(values: List[float]) -> float:
    """The 95th percentile by nearest rank."""
    ordered = sorted(values)
    return ordered[max(0, math.ceil(0.95 * len(ordered)) - 1)]
