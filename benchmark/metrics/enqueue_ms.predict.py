"""enqueue_ms.predict: the median host milliseconds from entering a cached
window's call to its return, before the sync, over the measured window of
the traced run (layer: predict builders, train/flow.py)."""

import statistics


def read(run):
    times = [u.enqueue_s for u in run.units if u.kind == "cached"]
    return 1e3 * statistics.median(times) if times else None
