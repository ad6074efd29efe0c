"""core/spans.py on a hand-made trace, the flow cell's span metrics on it,
and the flow cell's traced CPU run, which reads ``bind_ms.predict`` and no
device metric (the CPU has no device operations)."""

import pytest

from benchmark import run
from benchmark.core import registry, spans
from benchmark.core.outcome import Reading
from benchmark.core.trace import Stretch
from benchmark.tests.helpers import benchmark_json, cpu_overrides

SEED = 2 ** 31 + 29
DEVICE_METRICS = ("encoder_ms.predict", "warp_ms.predict", "fusion_ms.predict",
                  "decoder_ms.predict", "epilogue_ms.predict", "bind_idle_ms.predict",
                  "unspanned_pct.predict")
SPAN_METRICS = DEVICE_METRICS + ("bind_ms.predict",)


def _host(name, ts, dur, ext, tid=1, cat="cpu_op"):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": 1, "tid": tid,
            "args": {"External id": ext}}


def _span(name, ts, dur, ext, tid=1):
    return _host(name, ts, dur, ext, tid, "user_annotation")


def _kernel(ts, dur, ext):
    return {"ph": "X", "cat": "kernel", "name": f"k{ext}", "ts": ts, "dur": dur, "pid": 0,
            "tid": 7, "args": {"External id": ext}}


def _stretch():
    """One unit: ``bench.window.1`` around ``predict_window``, which holds
    ``predict_encoder`` and ``predict_warp`` on thread 1; a host op of
    thread 2 starts inside ``predict_warp``."""
    host = [
        _span("bench.window.1", 0, 100, 1),
        _span("predict_window", 5, 90, 2),
        _span("predict_encoder", 10, 30, 3),
        _span("predict_warp", 40, 20, 4),
        _host("aten::conv", 12, 8, 10),             # in predict_encoder (and predict_window)
        _host("autograd op", 45, 30, 11, tid=2),    # thread 2, starts in predict_warp
        _host("aten::copy_", 96, 2, 12),            # in bench.window.1 alone
        _host("aten::add", 60, 5, 13),              # predict_warp has closed: predict_window
    ]
    device = [
        _kernel(20, 7, 10),      # -> predict_encoder, the innermost
        _kernel(50, 5, 11),      # -> predict_warp through thread 2's op
        _kernel(58, 3, 4),       # launched by the span itself -> predict_warp
        _kernel(70, 4, 13),      # -> predict_window
        _kernel(98, 2, 12),      # bench.* skipped -> under no span
        _kernel(101, 1, 99),     # no launching event -> under no span
    ]
    return Stretch(1, 100e-6, device, host, 0.0)


def test_device_time_goes_to_the_innermost_span_on_any_thread():
    s = spans.read(_stretch())
    # innermost: predict_encoder 7, predict_warp 5 + 3, predict_window 4;
    # predict_window holds both phases
    assert s.device == pytest.approx({"predict_encoder": 7e-6, "predict_warp": 8e-6,
                                      "predict_window": 19e-6})
    assert s.unspanned == pytest.approx(3e-6)
    assert s.count == {"predict_window": 1, "predict_encoder": 1, "predict_warp": 1}
    assert "bench.window.1" not in s.device and "bench.window.1" not in s.count


def test_host_self_time_and_idle_gaps_by_span():
    s = spans.read(_stretch())
    assert s.host_self == pytest.approx({"predict_window": 40e-6, "predict_encoder": 30e-6,
                                         "predict_warp": 20e-6})
    # gaps: 27-50 (13 in predict_encoder, 10 in predict_warp), 55-58
    # (predict_warp), 61-70 (predict_window), 74-98 (21 in predict_window,
    # 3 under no span: bench.* is skipped), 100-101 (under no span)
    assert s.idle == pytest.approx({"predict_encoder": 13e-6, "predict_warp": 13e-6,
                                    "predict_window": 9e-6 + 21e-6})


def test_a_stretch_is_read_once():
    stretch = _stretch()
    assert spans.read(stretch) is spans.read(stretch)
    assert spans.read(_stretch()) is not spans.read(stretch)


def test_the_metrics_read_the_spans_or_nothing():
    stretch = _stretch()
    stretch.busy_s = 22e-6
    reading = Reading({}, {}, [], 1.0, stretch)
    assert spans.device_ms(reading, "predict_warp") == pytest.approx(8e-3)
    assert spans.host_self_ms(reading, "predict_window") == pytest.approx(40e-3)
    assert spans.idle_ms(reading, "predict_window") == pytest.approx(30e-3)
    assert spans.unspanned_pct(reading) == pytest.approx(100 * 3 / 22)
    assert spans.device_ms(reading, "train_forward") is None        # a program without it
    bare = Stretch(1, 1.0, [], stretch.host_ops, 0.0)
    assert spans.device_ms(Reading({}, {}, [], 1.0, bare), "predict_warp") is None
    assert spans.unspanned_pct(Reading({}, {}, [], 1.0, bare)) is None
    assert spans.host_self_ms(Reading({}, {}, [], 1.0, None), "predict_window") is None
    # a program that opens no span (the parent's): every metric reads nothing
    spanless = [e for e in stretch.host_ops if e["cat"] != "user_annotation"
                or e["name"].startswith("bench.")]
    parent = Reading({}, {}, [], 1.0, Stretch(1, 1.0, stretch.device_ops, spanless, 22e-6))
    assert spans.unspanned_pct(parent) is None
    assert spans.idle_ms(parent, "predict_window") is None
    bench = benchmark_json()
    cell = registry.resolve(bench, "pspnet50.flow-video")
    got = {m["name"]: cell.per_layer_reader(m).read(reading) for m in cell.per_layer
           if m["name"] in SPAN_METRICS}
    assert got == pytest.approx({"bind_ms.predict": 40e-3, "bind_idle_ms.predict": 30e-3,
                                 "unspanned_pct.predict": 100 * 3 / 22,
                                 "encoder_ms.predict": 7e-3, "warp_ms.predict": 8e-3,
                                 "fusion_ms.predict": None, "decoder_ms.predict": None,
                                 "epilogue_ms.predict": None})


def test_flow_cpu_run_reads_bind_ms_and_no_device_metric():
    w = "pspnet50.flow-video"
    r = run.run_cell(w, SEED, 0.5, True, device="cpu", require_chips=False,
                     overrides=cpu_overrides(w), check_imports=False)
    assert r["correct"], r["checks"]
    assert r["metrics"]["bind_ms.predict"]["value"] > 0
    assert r["metrics"]["bind_ms.predict"]["unit"] == "ms"
    assert not set(DEVICE_METRICS) & set(r["metrics"])
