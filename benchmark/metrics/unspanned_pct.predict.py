"""unspanned_pct.predict: the device time of the profiled stretch's cached
windows that no program span owns, in percent of their busy time: what the
phase metrics (``encoder_ms.predict`` ... ``epilogue_ms.predict``) cannot
put down to a phase (layer: device; core/spans.py)."""

from benchmark.core.spans import unspanned_pct


def read(run):
    return unspanned_pct(run)
