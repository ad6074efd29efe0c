"""idle_pct.predict: the share of the measured window in which no operation
ran on the device, in percent: one less the device's busy seconds a window,
read from the profiled stretch's trace (cached windows, each ending in a
sync as in the measured window), times the windows the measured window ran,
over its seconds. The stretch's own length is not used: the profiler's
host-side recording slows the host's enqueue, but not the device's
operations."""


def read(run):
    s = run.stretch
    windows = [u for u in run.units if u.kind in ("full", "cached")]
    if s is None or not s.device_ops or not windows or run.window_s <= 0:
        return None
    return 100.0 * (1.0 - s.busy_s / s.units * len(windows) / run.window_s)
