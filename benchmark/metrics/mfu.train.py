"""mfu.train: the model operations of a step, forward and backward (the
reference's count), times the steps of the traced run's measured window,
over the window's seconds, over the dense peak of the configuration's
dtype (float32 outside the tensor cores: the step turns TF32 off), in
percent."""

from benchmark.core.peaks import PEAK_FLOPS


def read(run):
    steps = [u for u in run.units if u.kind == "step"]
    if not steps or run.window_s <= 0:
        return None
    return 100.0 * sum(u.flops for u in steps) / run.window_s / PEAK_FLOPS[run.config["dtype"]]
