"""kernels_per_step: the device kernels of a training step, from the
profiled stretch's trace (layer: train step, train/supervised.py,
ops/losses.py, train/optim.py)."""


def read(run):
    s = run.stretch
    if s is None or not s.kernels or not any(u.kind == "step" for u in run.units):
        return None
    return len(s.kernels) / s.units
