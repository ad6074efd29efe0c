"""kernels_per_window: the device kernels of a cached window, from the
profiled stretch's trace (every unit of the stretch is a cached window)."""


def read(run):
    s = run.stretch
    if s is None or not s.kernels or not any(u.kind == "cached" for u in run.units):
        return None
    return len(s.kernels) / s.units
