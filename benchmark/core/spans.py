"""The program's spans in a profiled stretch, and the time under each.

A program span is a ``user_annotation`` event of the stretch whose name
does not start with ``bench.`` (the harness's own spans): the port opens
them with ``core/profiler.py::span`` while a profiler records. A device
operation belongs to the spans open where it was launched: its launching
host event is the host operation with the same ``External id``, and the
spans that contain that event's start, on any thread (autograd's backward
runs on its own thread, inside the main thread's ``train_backward``), the
innermost first. A launching event that is itself a program span is its
own innermost span.

``read(stretch)`` returns, in seconds:

- ``device``: per span name, the device time under a span of that name,
  the spans nested in it included (the optimizer's own
  ``Optimizer.step#...`` annotation inside ``train_optimizer``);
- ``unspanned``: the device time under no program span;
- ``host_self``: per span name, the host time of its spans that no program
  span nested in it on the same thread covers;
- ``idle``: per span name, the device's idle time between its operations
  while that span was the innermost program span open on the host (a gap
  is split where the host enters or leaves a span: the gap that opens a
  window starts in the harness's ``sync`` and runs on through the
  window's binding and inputs);
- ``count``: the spans of each name.

It is computed once a stretch, however many metrics read it.
"""

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

from benchmark.core.trace import Stretch, union_us

HARNESS_PREFIX = "bench."


@dataclass
class Spans:
    device: Dict[str, float]
    unspanned: float
    host_self: Dict[str, float]
    idle: Dict[str, float]
    count: Dict[str, int]


_READ: Dict[int, Tuple[Stretch, Spans]] = {}


def _program_spans(host_ops: Sequence[dict]) -> List[dict]:
    return [e for e in host_ops if e.get("cat") == "user_annotation"
            and not e["name"].startswith(HARNESS_PREFIX)]


def _enclosing(spans: Sequence[dict], t: float) -> List[dict]:
    """The spans open at the instant t, the innermost first."""
    return sorted((s for s in spans if s["ts"] <= t < s["ts"] + s["dur"]),
                  key=lambda s: s["dur"])


def _external_id(event: dict) -> Optional[int]:
    return event.get("args", {}).get("External id")


def _add(d: Dict[str, float], key: str, value: float) -> None:
    d[key] = d.get(key, 0.0) + value


def _gaps(device_ops: Sequence[dict]) -> List[Tuple[float, float]]:
    """The idle intervals between the device operations, in microseconds."""
    gaps, end = [], None
    for s0, e0 in sorted((e["ts"], e["ts"] + e["dur"]) for e in device_ops):
        if end is not None and s0 > end:
            gaps.append((end, s0))
        end = e0 if end is None else max(end, e0)
    return gaps


def read(stretch: Stretch) -> Spans:
    cached = _READ.get(id(stretch))
    if cached is not None and cached[0] is stretch:
        return cached[1]
    spans = _program_spans(stretch.host_ops)
    span_ids = {id(s) for s in spans}
    by_id = {_external_id(e): e for e in stretch.host_ops if _external_id(e) is not None}
    chains: Dict[int, List[dict]] = {}

    def chain_of(ext) -> List[dict]:
        """The program spans open where the host event ``ext`` started."""
        if ext not in chains:
            host = by_id.get(ext)
            if host is None:
                chains[ext] = []
            elif id(host) in span_ids:
                chains[ext] = [host] + [s for s in _enclosing(spans, host["ts"]) if s is not host]
            else:
                chains[ext] = _enclosing(spans, host["ts"])
        return chains[ext]

    device: Dict[str, float] = {}
    unspanned = 0.0
    for op in stretch.device_ops:
        seconds = op["dur"] / 1e6
        chain = chain_of(_external_id(op))
        if not chain:
            unspanned += seconds
        for name in {s["name"] for s in chain}:
            _add(device, name, seconds)

    host_self: Dict[str, float] = {}
    count: Dict[str, int] = {}
    for s in spans:
        s0, s1 = s["ts"], s["ts"] + s["dur"]
        inner = [(c["ts"], c["ts"] + c["dur"]) for c in spans if c is not s
                 and c.get("tid") == s.get("tid") and c.get("pid") == s.get("pid")
                 and s0 <= c["ts"] and c["ts"] + c["dur"] <= s1]
        _add(host_self, s["name"], (s["dur"] - union_us(inner)) / 1e6)
        count[s["name"]] = count.get(s["name"], 0) + 1

    idle: Dict[str, float] = {}
    for g0, g1 in _gaps(stretch.device_ops):
        near = [c for c in spans if c["ts"] < g1 and g0 < c["ts"] + c["dur"]]
        cuts = sorted({g0, g1} | {t for c in near for t in (c["ts"], c["ts"] + c["dur"])
                                  if g0 < t < g1})
        for a, b in zip(cuts, cuts[1:]):
            inner = _enclosing(near, a)
            if inner:
                _add(idle, inner[0]["name"], (b - a) / 1e6)
    result = Spans(device, unspanned, host_self, idle, count)
    _READ.clear()
    _READ[id(stretch)] = (stretch, result)
    return result


def _spans_of(run, with_device: bool) -> Optional[Spans]:
    """The stretch's spans; None without a stretch, without a program span
    (a program that opens none), or, ``with_device``, without device
    operations."""
    s = run.stretch
    if s is None or (with_device and not s.device_ops):
        return None
    spans = read(s)
    return spans if spans.count else None


def device_ms(run, name: str) -> Optional[float]:
    """Device milliseconds a unit of the profiled stretch under the spans
    named ``name``; None without device operations or without such a span."""
    spans = _spans_of(run, True)
    if spans is None or name not in spans.count:
        return None
    return 1e3 * spans.device.get(name, 0.0) / run.stretch.units


def host_self_ms(run, name: str) -> Optional[float]:
    """Host self milliseconds a unit of the profiled stretch of the spans
    named ``name``; None without such a span."""
    spans = _spans_of(run, False)
    if spans is None or name not in spans.count:
        return None
    return 1e3 * spans.host_self[name] / run.stretch.units


def idle_ms(run, name: str) -> Optional[float]:
    """Milliseconds a unit of the profiled stretch in which the device was
    idle while ``name`` was the host's innermost program span; None without
    device operations or without such a span."""
    spans = _spans_of(run, True)
    if spans is None or name not in spans.count:
        return None
    return 1e3 * spans.idle.get(name, 0.0) / run.stretch.units


def unspanned_pct(run) -> Optional[float]:
    """The device time under no program span, in percent of the stretch's
    busy time; None without device operations or without a program span."""
    spans = _spans_of(run, True)
    if spans is None or run.stretch.busy_s <= 0:
        return None
    return 100.0 * spans.unspanned / run.stretch.busy_s
