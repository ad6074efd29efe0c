"""idle_pct.train: the share of the measured window in which no operation
ran on the device, in percent: one less the device's busy seconds a step,
read from the profiled stretch's trace (steps back to back, as in the
measured window), times the steps the measured window ran, over its
seconds."""


def read(run):
    s = run.stretch
    steps = [u for u in run.units if u.kind == "step"]
    if s is None or not s.device_ops or not steps or run.window_s <= 0:
        return None
    return 100.0 * (1.0 - s.busy_s / s.units * len(steps) / run.window_s)
