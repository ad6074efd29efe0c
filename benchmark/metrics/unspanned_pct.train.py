"""unspanned_pct.train: the device time of the profiled stretch's training
steps that no program span owns, in percent of their busy time: what the
phase metrics (``forward_ms.train`` ... ``optimizer_ms.train``) cannot put
down to a phase (layer: device; core/spans.py)."""

from benchmark.core.spans import unspanned_pct


def read(run):
    return unspanned_pct(run)
