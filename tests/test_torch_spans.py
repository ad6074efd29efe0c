"""The port's program spans (core/profiler.py::span) on the CPU.

Under ``torch.profiler`` a cached window of the predict builders opens
``predict_window`` and, nested inside it once a call and in order, the
phases ``predict_inputs``, ``predict_encoder``, ``predict_warp``,
``predict_fusion``, ``predict_decoder`` and ``predict_epilogue``; its maps
are bit-equal with the profiler on and off. A supervised step opens
``train_forward``, ``train_loss``, ``train_backward`` and
``train_optimizer``; a ``PhaseProfiler`` region opens its own span. With
no profiler recording, ``record_function`` is never entered. A
hand-written kernel's launch is a host op, not a span, that owns its
kernels (the
``cuda`` test, on the card:
``python -m pytest --noconftest tests/test_torch_spans.py -q -m cuda``).
"""

import json

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from floodseg_tpu_torch.core.profiler import PhaseProfiler, kernel_launch, span
from floodseg_tpu_torch.data import predict_windows, resize_frames, synthetic_clip
from floodseg_tpu_torch.models import build_model
from floodseg_tpu_torch.train import make_cached_flow_predict_fn
from floodseg_tpu_torch.train.optim import make_optimizer
from floodseg_tpu_torch.train.state import create_train_state
from floodseg_tpu_torch.train.supervised import make_loss_fn, make_train_step
from floodseg_tpu_torch.video import default_grid

N = 5
PHASES = ("predict_inputs", "predict_encoder", "predict_warp", "predict_fusion",
          "predict_decoder", "predict_epilogue")
TRAIN = ("train_forward", "train_loss", "train_backward", "train_optimizer")


@pytest.fixture(scope="module")
def predict():
    """PSPNet-50 at 65 px key frames, n = 5, 4x4 block grids: the cached
    builders, their variables and two windows."""
    torch.manual_seed(0)
    model = build_model("pspnet", classes=5, layers=50)
    clip = synthetic_clip(2 * N + 1, size=(64, 64), frame_ids=(0, N, 2 * N), seed=3)
    wins = predict_windows(clip, N)
    frames = [resize_frames(w[k], (65, 65)).numpy() for w in wins
              for k in ("frame_prev", "frame_next")]
    full, cached = make_cached_flow_predict_fn(model, n=N, out_size=(72, 80),
                                               default_grid=default_grid(64, 64),
                                               device="cpu")
    variables = model.state_dict()

    def windows():
        maps0, enc = full(variables, frames[0], frames[1], wins[0]["mvs_left"],
                          wins[0]["mvs_right"])
        maps1, _ = cached(variables, enc, frames[3], wins[1]["mvs_left"],
                          wins[1]["mvs_right"])
        return maps0, maps1

    return windows


def _spans(prof, names):
    """The profiler's spans among ``names``, in start order: (name, start,
    end) on the host's clock."""
    out = [(e.name, e.time_range.start, e.time_range.end) for e in prof.events()
           if e.name in names]
    return sorted(out, key=lambda s: s[1])


def _train_step():
    torch.manual_seed(0)
    model = build_model("pspnet", classes=5, layers=50)
    opt, schedule = make_optimizer(model, 1e-4, 100)
    state = create_train_state(model, opt, schedule)
    step = make_train_step(model, make_loss_fn("ohem", 0.4, 255, 0.7, 100), 5, 255)
    batch = {"frame_current": torch.randn(2, 65, 65, 3),
             "label": torch.randint(0, 5, (2, 65, 65), dtype=torch.int32)}
    return lambda: step(state, batch, torch.Generator().manual_seed(1))


def test_cached_window_nests_its_phases_in_order(predict):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        predict()
    spans = _spans(prof, ("predict_window",) + PHASES)
    windows = [s for s in spans if s[0] == "predict_window"]
    assert len(windows) == 2
    for _, start, end in windows:
        inside = [s for s in spans if s[0] != "predict_window" and start <= s[1] <= s[2] <= end]
        assert [s[0] for s in inside] == list(PHASES)
        assert all(a[2] <= b[1] for a, b in zip(inside, inside[1:]))


def test_maps_are_bit_equal_with_the_profiler_on(predict):
    off = predict()
    with profile(activities=[ProfilerActivity.CPU]):
        on = predict()
    for a, b in zip(off, on):
        assert torch.equal(a, b)


def test_supervised_step_emits_its_spans():
    step = _train_step()
    step()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step()
    assert [s[0] for s in _spans(prof, TRAIN)] == list(TRAIN)


def test_phase_profiler_region_is_a_span():
    prof = PhaseProfiler()
    with profile(activities=[ProfilerActivity.CPU]) as p:
        with prof.profile("region_a"):
            torch.ones(4).sum()
    assert [s[0] for s in _spans(p, ("region_a",))] == ["region_a"]
    assert prof.summary()["region_a"]["count"] == 1


def test_no_profiler_never_enters_record_function(predict, monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) with no profiler on")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    with span("anything"):
        pass
    maps0, maps1 = predict()
    assert maps0.shape == maps1.shape == (N, 72, 80)
    _, metrics = _train_step()()
    assert torch.isfinite(metrics["loss"])


def test_kernel_launch_is_a_host_op(tmp_path):
    """In the Chrome trace the launch is a ``cpu_op`` (whose ``External id``
    a kernel carries) and the span a ``user_annotation`` (which gives a
    kernel none)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with span("predict_warp"), kernel_launch("warp_chain_cuda"):
            pass
    assert {e.name for e in prof.events()} == {"predict_warp", "warp_chain_cuda"}
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    cats = {e["name"]: e.get("cat") for e in json.loads(path.read_text())["traceEvents"]
            if e.get("ph") == "X" and e.get("cat") != "Trace"}
    assert cats == {"predict_warp": "user_annotation", "warp_chain_cuda": "cpu_op"}
    assert kernel_launch("warp_chain_cuda") is span("predict_warp")  # the shared no-op


@pytest.mark.cuda
def test_hand_written_kernels_belong_to_their_launch(tmp_path):
    """K1, K1-bwd, K2 and K3 under the profiler: each kernel's External id
    names its wrapper's launch op, inside the span around it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand-written kernels have no CPU mode")
    from floodseg_tpu_torch.ops import (grid_sample_backward_cuda, grid_sample_cuda,
                                        resize_quantize_int8_cuda, warp_chain_cuda)

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((1, 32, 32, 64), generator=gen, device=dev, dtype=torch.bfloat16)
    grids = torch.rand((4, 1, 16, 16, 2), generator=gen, device=dev) * 2 - 1
    scale = torch.full((1,), 0.05, device=dev)

    def kernels():
        chain = warp_chain_cuda(grid_sample_cuda(x, grids[0]), grids[1:])
        grid_sample_backward_cuda(chain[:1].float(), grids[0], x.shape)
        resize_quantize_int8_cuda(chain, scale, (32, 32), align_corners=True)

    kernels()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with span("predict_warp"):
            kernels()
        torch.cuda.synchronize()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"] if e.get("ph") == "X"]
    host = {e["args"]["External id"]: e for e in events
            if e.get("cat") in ("cpu_op", "user_annotation") and "External id" in e.get("args", {})}
    wrappers = ("grid_sample_cuda", "grid_sample_backward_cuda", "warp_chain_cuda",
                "resize_quantize_int8_cuda")
    owners = {host[e["args"]["External id"]]["name"] for e in events
              if e.get("cat") == "kernel" and e["args"].get("External id") in host
              and host[e["args"]["External id"]]["name"] in wrappers}
    assert owners == set(wrappers)
    warp = next(e for e in events if e.get("name") == "predict_warp"
                and e.get("cat") == "user_annotation")
    for e in events:
        if e.get("cat") == "cpu_op" and e["name"] in wrappers:
            assert warp["ts"] <= e["ts"] < warp["ts"] + warp["dur"]
