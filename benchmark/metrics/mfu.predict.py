"""mfu.predict: the model operations of the windows the traced run's
measured window ran (an encoder pass a cached window, two a full one, and
n decodes; the reference's count), over the window's seconds, over the
dense peak of the configuration's dtype (core/peaks.py), in percent."""

from benchmark.core.peaks import PEAK_FLOPS


def read(run):
    windows = [u for u in run.units if u.kind in ("full", "cached")]
    if not windows or run.window_s <= 0:
        return None
    flops = sum(u.flops for u in windows)
    return 100.0 * flops / run.window_s / PEAK_FLOPS[run.config["dtype"]]
