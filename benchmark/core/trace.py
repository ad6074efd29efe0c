"""A profiled stretch and what the harness reads from its trace.

``profile_stretch`` runs a few units of the cell's work under
``torch.profiler`` (CPU and CUDA activities), each unit inside a
``record_function`` span named by the generator, writes the Chrome trace
inside the checkout and returns a ``Stretch``: the device operations
(kernels, copies and sets), the host's operations and spans, the stretch's
length on the host's clock, and the device's busy time, the union of the
device operations' intervals (``union_us``, as chip_smoke.py measured it).
The host's clock is read after the profiler has started and after the
last unit's sync, so the length covers the units and no profiler set-up.
"""

import json
import os
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Sequence, Tuple

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation")
NAME_CHARS = 120


@dataclass
class Stretch:
    units: int
    window_s: float
    device_ops: List[dict]
    host_ops: List[dict]
    busy_s: float

    @property
    def kernels(self) -> List[dict]:
        return [e for e in self.device_ops if e.get("cat") == "kernel"]


def union_us(spans: Sequence[Tuple[float, float]]) -> float:
    """The length of the union of (start, end) intervals."""
    total, cur = 0.0, None
    for s0, e0 in sorted(spans):
        if cur is None or s0 > cur[1]:
            total += 0.0 if cur is None else cur[1] - cur[0]
            cur = [s0, e0]
        else:
            cur[1] = max(cur[1], e0)
    return total + (0.0 if cur is None else cur[1] - cur[0])


def profile_stretch(units: Sequence[Callable[[], None]], names: Sequence[str],
                    sync: Callable[[], None], trace_path: str) -> Stretch:
    from torch.profiler import ProfilerActivity, profile, record_function

    os.makedirs(os.path.dirname(trace_path), exist_ok=True)
    sync()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for unit, name in zip(units, names):
            with record_function(name):
                unit()
        with record_function("bench.sync"):
            sync()
        t1 = time.perf_counter()
    prof.export_chrome_trace(trace_path)
    with open(trace_path) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    device = [e for e in events if e.get("cat") in DEVICE_CATS]
    host = [e for e in events if e.get("cat") in HOST_CATS]
    busy = union_us([(e["ts"], e["ts"] + e["dur"]) for e in device]) / 1e6
    return Stretch(len(units), t1 - t0, device, host, busy)


def device_ops_top(stretch: Stretch, k: int = 10) -> List[list]:
    """The k device operations that took most time in the stretch:
    [name, seconds], by name."""
    by_name: Dict[str, float] = {}
    for e in stretch.device_ops:
        name = e["name"][:NAME_CHARS]
        by_name[name] = by_name.get(name, 0.0) + e["dur"] / 1e6
    return [[n, s] for n, s in sorted(by_name.items(), key=lambda kv: -kv[1])[:k]]


def idle_gaps_top(stretch: Stretch, k: int = 10) -> List[list]:
    """The k longest gaps between device operations in the stretch:
    [what the host was doing, seconds]. The host's doing is the innermost
    host operation or span open at the gap's start."""
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in stretch.device_ops)
    gaps, end = [], None
    for s0, e0 in spans:
        if end is not None and s0 > end:
            gaps.append((end, s0))
        end = e0 if end is None else max(end, e0)
    gaps.sort(key=lambda g: g[0] - g[1])
    out = []
    for g0, g1 in gaps[:k]:
        open_ops = [e for e in stretch.host_ops if e["ts"] <= g0 < e["ts"] + e["dur"]]
        name = min(open_ops, key=lambda e: e["dur"])["name"] if open_ops else "host (no op)"
        out.append([name[:NAME_CHARS], (g1 - g0) / 1e6])
    return out


def breakdown(stretch: Stretch) -> dict:
    return {"device_ops": device_ops_top(stretch), "idle_gaps": idle_gaps_top(stretch)}


def kernel_time_s(stretch: Stretch, patterns: Sequence[str]) -> float:
    """Seconds of the stretch's kernels whose name contains a pattern."""
    return sum(e["dur"] for e in stretch.kernels
               if any(p in e["name"] for p in patterns)) / 1e6


def sync_for(device: torch.device) -> Callable[[], None]:
    if device.type == "cuda":
        return lambda: torch.cuda.synchronize(device)
    return lambda: None
