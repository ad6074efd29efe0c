#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port (floodseg_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. Environment: the card's name and power limit (nvidia-smi), torch and
   CUDA versions. No CUDA device -> exit 1 before anything else.
2. Build the hand-written kernels from csrc/ with nvcc (sm_90a).
3. Each kernel against its plain PyTorch version, on the card, at the
   shapes the flow-predict path gives it, on random grids and on the main
   path's own grids; then its time on the main path's inputs (CUDA events,
   median, L2 flushed and the host's enqueue hidden behind a sleep kernel
   before each launch) beside the plain version's, the
   least time the card could take (bound), and one PyTorch library call
   computing the same function (F.grid_sample, a yardstick only).
4. The flow-predict slice in float32 (TF32 off) on the card against the
   same slice on the CPU: PSPNet-50 at 129 px key frames, n = 5.
5. The main path: PSPNet-50 in bf16 at full width, 513 px key frames,
   n = 25, 32x32 block grids, through make_cached_flow_predict_fn, with
   bench.py's protocol (8 timed windows, median of 5 passes). The launch
   counters are set to 0 before and read after: K1 must have launched 3
   times and K2 twice per window.
   Then torch.profiler over two more cached windows: the device's busy
   time and idle share per window, kernel time by name (the table and the
   trace go to build/profile/).
6. A JSON line {"kernels": [...]}, then the nvidia-smi line, then the last
   line {"ok": true, "device": {...}}.
"""

import copy
import json
import os
import statistics
import subprocess
import sys
import time

import torch
import torch.nn.functional as F

from floodseg_tpu_torch.core import full_precision_f32
from floodseg_tpu_torch.data import MEAN, STD, Resize, predict_windows, synthetic_clip
from floodseg_tpu_torch.models import build_model, init_from_generator_
from floodseg_tpu_torch.ops import build
from floodseg_tpu_torch.ops.grid_sample import grid_sample, tap_indices_weights
from floodseg_tpu_torch.ops.warp_kernels import (
    grid_sample_cuda,
    launch_counts,
    reset_launch_counts,
    warp_chain_cuda,
    warp_chain_plain,
)
from floodseg_tpu_torch.train import make_cached_flow_predict_fn
from floodseg_tpu_torch.video import FlowInterpolator, default_grid

# the flow-predict workload of bench.py
FRAME_DELTA = 25
SIZE = 513
CLIPS_TIMED = 8
PASSES = 5
CLASSES = 5

# NVIDIA H100 SXM data sheet: HBM3 bandwidth and float32 (non-tensor) rate
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
F32_TOL = 1e-5


def log(*a):
    print(*a, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


# ---------------------------------------------------------------- checks

def bf16_ulps(got: torch.Tensor, ref: torch.Tensor) -> float:
    """Largest |got - ref| in units of ref's bf16 ulp."""
    g, r = got.float(), ref.float()
    mag = r.abs().clamp_min(2.0 ** -126)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    return float(((g - r).abs() / ulp).max())


def compare(name, got, ref, dtype) -> float:
    """Hold a kernel's output against its plain version: float32 within
    1e-5, bf16 within 1 bf16 ulp. Returns the max abs error."""
    err = float((got.float() - ref.float()).abs().max())
    if dtype == torch.float32:
        ok, detail = err <= F32_TOL, f"max_abs_err {err:.3e} (tol {F32_TOL})"
    else:
        ulps = bf16_ulps(got, ref)
        ok, detail = ulps <= 1.0, f"max_abs_err {err:.3e}, {ulps:.2f} bf16 ulp (tol 1 ulp)"
    log(f"  {name}: {detail} -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name} disagrees with its plain version: {detail}")
    return err


def kernel_cases(device, dtype, k1_shape=(1, 65, 65, 4096), grid_hw=(32, 32),
                 chain_steps=FRAME_DELTA - 2, wide_grid=(67, 120), wide_c=256,
                 seed=0):
    """Inputs at the flow-predict path's shapes: K1 warps the 65x65x4096
    encoding onto the 32x32 block grid (both align modes); K2 chains 23
    warps on 32x32x4096, and again on the reference's 67x120 grid."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(k1_shape, generator=g).to(device, dtype)
    grid = (torch.rand((1,) + grid_hw + (2,), generator=g) * 2.2 - 1.1).to(device)
    y0 = torch.randn((1,) + grid_hw + (k1_shape[-1],), generator=g).to(device, dtype)
    grids = (torch.rand((chain_steps, 1) + grid_hw + (2,), generator=g) * 2.2 - 1.1).to(device)
    y0w = torch.randn((1,) + wide_grid + (wide_c,), generator=g).to(device, dtype)
    gridsw = (torch.rand((chain_steps, 1) + wide_grid + (2,), generator=g) * 2.2 - 1.1).to(device)
    return x, grid, y0, grids, y0w, gridsw


def main_path_grids(device, n=FRAME_DELTA, frame_hw=(512, 512), seed=0):
    """The grids phase 5 gives the kernels in its first window: mvs_left
    (n-1, 1, 32, 32, 2) of the synthetic clip of 512 px frames, and the
    identity grid (1, 32, 32, 2) of the key-map resample."""
    clip = synthetic_clip(n + 1, size=frame_hw, frame_ids=(0, n), seed=seed)
    mvs = predict_windows(clip, n)[0]["mvs_left"]
    return (torch.as_tensor(mvs, device=device),
            torch.as_tensor(default_grid(*frame_hw), device=device)[None].contiguous())


def check_kernels(device, **shapes) -> dict:
    """Phase 3a: both kernels against their plain versions, f32 and bf16, on
    random grids (every border case) and on the main path's own grids."""
    errs = {"grid_sample_cuda": 0.0, "warp_chain_cuda": 0.0}
    mvs, dg = main_path_grids(device)
    for dtype in (torch.float32, torch.bfloat16):
        x, grid, y0, grids, y0w, gridsw = kernel_cases(device, dtype, **shapes)
        tag = str(dtype).replace("torch.", "")
        for g, align, what in ((grid, False, "random"), (grid, True, "random"),
                               (mvs[0], False, "main-path"), (dg, True, "identity")):
            errs["grid_sample_cuda"] = max(errs["grid_sample_cuda"], compare(
                f"K1 {tag} x{tuple(x.shape)} {what} grid{tuple(g.shape)} align={align}",
                grid_sample_cuda(x, g, align), grid_sample(x, g, align), dtype))
        y0m = grid_sample(x, mvs[0], False)
        for y, gs, what in ((y0, grids, "random"), (y0w, gridsw, "random"),
                            (y0m, mvs[1:], "main-path")):
            errs["warp_chain_cuda"] = max(errs["warp_chain_cuda"], compare(
                f"K2 {tag} y0{tuple(y.shape)} {what} T={gs.shape[0]} (every step)",
                warp_chain_cuda(y, gs), warp_chain_plain(y, gs), dtype))
    return errs


# ---------------------------------------------------------------- timing

class L2Flush:
    """Writes a buffer larger than the 50 MB L2 before each timed launch."""

    def __init__(self, device):
        self.buf = torch.empty(64 << 20, dtype=torch.uint8, device=device)

    def __call__(self):
        self.buf.zero_()


def sleep_cycles_per_ms() -> float:
    """Calibrate torch.cuda._sleep: the card's clock cycles per millisecond."""
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(10_000_000)
    end.record()
    end.synchronize()
    return 10_000_000 / start.elapsed_time(end)


def time_ms(fn, flush, cycles_per_ms, reps=20, warmup=3) -> float:
    """Median device time of fn() in ms. The L2 is flushed before each
    launch, and a sleep kernel holds the stream while the host enqueues
    fn, so the host's launch overhead is not counted as device time."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()  # returns once enqueued
    hold = int((2e3 * (time.perf_counter() - t0) + 0.05) * cycles_per_ms)
    times = []
    for _ in range(reps):
        flush()
        torch.cuda._sleep(hold)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(bytes_moved: int, flops: int):
    """(ms, "bytes" | "operations"): the larger of bytes over the memory rate
    and operations over the float32 rate (the warps use no tensor cores)."""
    t_bytes = bytes_moved / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def k1_bytes(x, grid, out, align_corners) -> int:
    """Bytes K1 must move on this grid: each pixel of x that a tap touches,
    read once; the grid read; the output written."""
    b, h, w, c = x.shape
    idx, _ = tap_indices_weights(h, w, grid.reshape(b, -1, 2), align_corners)
    touched = sum(int(idx[i].unique().numel()) for i in range(b))
    return touched * c * x.element_size() + nbytes(grid, out)


def time_kernels(device) -> dict:
    """Phase 3b: bf16 on the main path's own inputs: a 65x65x4096 key
    encoding, the first window's block grids (K1's first warp of a chain,
    then K2's 23 steps from K1's output) and the identity grid (K1's key-map
    resample, align_corners=True)."""
    flush = L2Flush(device)
    cpm = sleep_cycles_per_ms()
    g = torch.Generator().manual_seed(0)
    x = torch.randn((1, 65, 65, 4096), generator=g).to(device, torch.bfloat16)
    mvs, dg = main_path_grids(device)
    grid, grids = mvs[0], mvs[1:]
    y0 = grid_sample_cuda(x, grid, False)
    # the library call takes NCHW data, and grids of the data's dtype
    xn = x.permute(0, 3, 1, 2).contiguous()
    y0n = y0.permute(0, 3, 1, 2).contiguous()
    grid_l, dg_l, grids_l = grid.to(x.dtype), dg.to(x.dtype), grids.to(x.dtype)

    def lib_chain():
        y = y0n
        for i in range(grids.shape[0]):
            y = F.grid_sample(y, grids_l[i], mode="bilinear", padding_mode="border",
                              align_corners=False)
        return y

    def k1(g, g_l, align):
        out = grid_sample_cuda(x, g, align)
        # 4 multiplies and 3 adds per output element
        b = bound(k1_bytes(x, g, out, align), 7 * out.numel())
        return {
            "ms": time_ms(lambda: grid_sample_cuda(x, g, align), flush, cpm),
            "plain_ms": time_ms(lambda: grid_sample(x, g, align), flush, cpm),
            "library_ms": time_ms(lambda: F.grid_sample(
                xn, g_l, mode="bilinear", padding_mode="border",
                align_corners=align), flush, cpm),
            "bound_ms": b[0], "bound_by": b[1],
        }

    out2 = warp_chain_cuda(y0, grids)
    b2 = bound(nbytes(y0, grids, out2), 7 * (out2.numel() - y0.numel()))
    res = {
        "grid_sample_cuda": k1(grid, grid_l, False),
        "grid_sample_cuda (identity grid, align_corners=True)": k1(dg, dg_l, True),
        "warp_chain_cuda": {
            "ms": time_ms(lambda: warp_chain_cuda(y0, grids), flush, cpm),
            "plain_ms": time_ms(lambda: warp_chain_plain(y0, grids), flush, cpm, reps=5),
            "library_ms": time_ms(lib_chain, flush, cpm, reps=10),
            "bound_ms": b2[0], "bound_by": b2[1],
        },
    }
    for name, r in res.items():
        log(f"  {name}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
            f"F.grid_sample {r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']}) -> {r['bound_ms'] / r['ms']:.1%} of bound")
    return res


# ------------------------------------------------------------- the slice

def random_pspnet(dtype, seed=0):
    """PSPNet-50 (no aux head) with weights from one torch.Generator seed,
    every BN's statistics perturbed."""
    model = build_model("pspnet", classes=CLASSES, layers=50, with_aux=False,
                        dtype=dtype)
    return init_from_generator_(model, torch.Generator().manual_seed(seed))


def clip_windows(n, frame_hw, num_windows, size, device, seed=0):
    """In-memory synthetic windows, frames resized to ``size`` on ``device``."""
    clip = synthetic_clip(num_windows * n + 1, size=frame_hw,
                          frame_ids=range(0, num_windows * n + 1, n), seed=seed)
    resize = Resize((size, size))
    wins = []
    for w in predict_windows(clip, n):
        wins.append({
            "frame_prev": resize(torch.as_tensor(w["frame_prev"], device=device)),
            "frame_next": resize(torch.as_tensor(w["frame_next"], device=device)),
            "mvs_left": torch.as_tensor(w["mvs_left"], device=device),
            "mvs_right": torch.as_tensor(w["mvs_right"], device=device),
            "prev_frame_id": w["prev_frame_id"],
            "next_frame_id": w["next_frame_id"],
        })
    return wins


def window_logits(model, w, n, dg, size, device):
    """Logits (n, size, size, classes) of one window through the
    interpolator, frames normalised as the predict builders do."""
    mean = torch.tensor(MEAN, device=device)
    std = torch.tensor(STD, device=device)
    interp = FlowInterpolator(lambda x: model.encode(x)[0], model.decode)
    with torch.inference_mode():
        return interp.predict_clip(
            (w["frame_prev"].float() - mean) / std,
            (w["frame_next"].float() - mean) / std,
            w["mvs_left"], w["mvs_right"], n,
            default_grid=torch.as_tensor(dg, device=device), out_size=(size, size))


def slice_outputs(model, device, n, size, frame_hw, wins):
    """Logits of window 0 through the interpolator, and the int32 maps and
    next encodings of the full program (window 0) and the cached program
    (window 1) through make_cached_flow_predict_fn."""
    dg = default_grid(*frame_hw)
    full, cached = make_cached_flow_predict_fn(
        model, n=n, out_size=(size, size), default_grid=dg, device=device)
    variables = model.state_dict()
    w0, w1 = (  # the builders take raw frames; the interpolator normalised ones
        {k: (v.to(device) if torch.is_tensor(v) else v) for k, v in w.items()}
        for w in wins[:2])
    logits = window_logits(model, w0, n, dg, size, device)
    maps0, enc0 = full(variables, w0["frame_prev"], w0["frame_next"],
                       w0["mvs_left"], w0["mvs_right"])
    maps1, enc1 = cached(variables, enc0, w1["frame_next"], w1["mvs_left"],
                         w1["mvs_right"])
    return {k: v.cpu() for k, v in dict(logits=logits, maps0=maps0, enc0=enc0,
                                        maps1=maps1, enc1=enc1).items()}


def check_slice_card_vs_cpu(n=5, size=129, seed=1) -> None:
    """Phase 4: float32 (TF32 off), the same weights and inputs on both."""
    frame_hw = (size - 1, size - 1)
    cpu_model = random_pspnet(torch.float32, seed)
    gpu_model = copy.deepcopy(cpu_model)
    wins = clip_windows(n, frame_hw, 2, size, "cpu", seed)
    with full_precision_f32():
        log(f"  cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
            f"cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}")
        t0 = time.perf_counter()
        ref = slice_outputs(cpu_model, torch.device("cpu"), n, size, frame_hw, wins)
        t1 = time.perf_counter()
        got = slice_outputs(gpu_model, torch.device("cuda"), n, size, frame_hw, wins)
        torch.cuda.synchronize()
    log(f"  cpu {t1 - t0:.1f} s, card {time.perf_counter() - t1:.1f} s")
    # float32 on both, summed in different orders through ~55 layers: the
    # logits agree to 1e-4 of their scale
    scale = float(ref["logits"].abs().max())
    tol = 1e-4 * scale
    err = float((got["logits"] - ref["logits"]).abs().max())
    log(f"  logits {tuple(ref['logits'].shape)}: max_abs_err {err:.3e}, "
        f"tol {tol:.3e} (1e-4 x max|logit| {scale:.3e})")
    if not err <= tol:
        raise AssertionError(f"card and CPU logits disagree: {err} > {tol}")
    for k in ("enc0", "enc1"):
        s = float(ref[k].abs().max())
        e = float((got[k] - ref[k]).abs().max())
        log(f"  {k} {tuple(ref[k].shape)}: max_abs_err {e:.3e}, tol {1e-4 * s:.3e}")
        if not e <= 1e-4 * s:
            raise AssertionError(f"card and CPU {k} disagree: {e}")
    # maps: equal wherever the top-2 gap of the CPU logits exceeds the
    # logits tolerance (window 0 logits are the full program's)
    top2 = ref["logits"].topk(2, dim=-1).values
    clear = (top2[..., 0] - top2[..., 1]) > 2 * tol
    same = (got["maps0"] == ref["maps0"])
    log(f"  maps0: {float(same.float().mean()):.6f} equal, "
        f"{int((~same & clear).sum())} differ away from near-ties "
        f"({float(clear.float().mean()):.4f} of pixels clear)")
    if bool((~same & clear).any()):
        raise AssertionError("card and CPU maps differ away from near-ties")
    same1 = float((got["maps1"] == ref["maps1"]).float().mean())
    log(f"  maps1 (cached window): {same1:.6f} equal")
    if same1 < 0.999:
        raise AssertionError(f"cached-window maps agree on only {same1:.6f}")


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run_main_path(dev=torch.device("cuda"), n=FRAME_DELTA, size=SIZE,
                  frame_hw=(512, 512)) -> dict:
    """Phase 5: PSPNet-50 bf16, 513 px, n = 25, bench.py's protocol."""
    t0 = time.perf_counter()
    model = random_pspnet(torch.bfloat16, seed=0)
    wins = clip_windows(n, frame_hw, CLIPS_TIMED + 2, size, dev)
    full, cached = make_cached_flow_predict_fn(
        model, n=n, out_size=(size, size), default_grid=default_grid(*frame_hw),
        device=dev)
    variables = model.state_dict()
    sync(dev)
    log(f"  set-up {time.perf_counter() - t0:.1f} s: {len(wins)} windows of "
        f"{n} frames, key frames {tuple(wins[0]['frame_prev'].shape)}, "
        f"grids {tuple(wins[0]['mvs_left'].shape)}")
    state = {"feat": None, "next_id": None, "windows": 0}

    def run(w, first=False):
        if first or state["feat"] is None or w["prev_frame_id"] != state["next_id"]:
            out, feat = full(variables, w["frame_prev"], w["frame_next"],
                             w["mvs_left"], w["mvs_right"])
        else:
            out, feat = cached(variables, state["feat"], w["frame_next"],
                               w["mvs_left"], w["mvs_right"])
        state["feat"], state["next_id"] = feat, w["next_frame_id"]
        state["windows"] += 1
        return out

    timed = wins[1:1 + CLIPS_TIMED]
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    reset_launch_counts()
    t0 = time.perf_counter()
    run(wins[0], first=True)
    run(wins[1])
    out = run(wins[0], first=True)
    sync(dev)
    log(f"  warm-up (3 windows): {time.perf_counter() - t0:.2f} s")
    fps = []
    for p in range(PASSES):
        t0 = time.perf_counter()
        for w in timed:
            out = run(w)
        sync(dev)
        fps.append(len(timed) * n / (time.perf_counter() - t0))
        log(f"  pass {p + 1}/{PASSES}: {fps[-1]:.2f} frames/s")
    counts = launch_counts()
    windows = state["windows"]
    log(f"  launches over {windows} windows: {counts}")
    if counts != {"grid_sample_cuda": 3 * windows, "warp_chain_cuda": 2 * windows}:
        raise AssertionError(f"the main path did not go through the kernels 3 "
                             f"and 2 times per window: {counts} for {windows} windows")
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9

    if out.shape != (n, size, size) or out.dtype != torch.int32:
        raise AssertionError(f"maps {tuple(out.shape)} {out.dtype}")
    lo, hi = int(out.min()), int(out.max())
    if lo < 0 or hi >= CLASSES:
        raise AssertionError(f"class ids outside [0, {CLASSES}): {lo}..{hi}")
    if not bool(torch.isfinite(state["feat"]).all()):
        raise AssertionError("non-finite next-key encoding")
    # logits of one window (outside the counted run): finite, expected shape
    logits = window_logits(model, timed[0], n, default_grid(*frame_hw), size, dev)
    if logits.shape != (n, size, size, CLASSES) or not bool(
            torch.isfinite(logits).all()):
        raise AssertionError(f"logits {tuple(logits.shape)} not finite or misshapen")
    log(f"  maps {tuple(out.shape)} int32 in [{lo}, {hi}], logits "
        f"{tuple(logits.shape)} {logits.dtype} finite, peak memory {peak_gb:.2f} GB")

    if dev.type == "cuda":
        profile(run, timed)
    return {"fps": statistics.median(fps), "fps_passes": fps, "windows": windows,
            "launches": counts, "peak_gb": peak_gb}


PROFILE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "build", "profile")


def profile(run, timed) -> None:
    """torch.profiler over two cached windows: device busy time and idle
    share per window, and kernel time by name."""
    from torch.profiler import ProfilerActivity, profile as tprofile
    os.makedirs(PROFILE_DIR, exist_ok=True)
    run(timed[0], first=True)
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for w in timed[1:3]:
            run(w)
        torch.cuda.synchronize()
    table = prof.key_averages().table(sort_by="cuda_time_total", row_limit=25)
    with open(os.path.join(PROFILE_DIR, "main_path_profile.txt"), "w") as f:
        f.write(table)
    trace = os.path.join(PROFILE_DIR, "main_path_trace.json")
    prof.export_chrome_trace(trace)
    with open(trace) as f:
        spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in json.load(f)["traceEvents"]
                       if e.get("ph") == "X" and e.get("cat") == "kernel")
    busy, cur = 0.0, None
    for s, e in spans:  # union of kernel intervals
        if cur is None or s > cur[1]:
            busy += 0.0 if cur is None else cur[1] - cur[0]
            cur = [s, e]
        else:
            cur[1] = max(cur[1], e)
    busy += cur[1] - cur[0]
    span = max(e for _, e in spans) - spans[0][0]
    log(f"  profiler, 2 cached windows: device busy {busy / 2e3:.3f} ms/window "
        f"of {span / 2e3:.3f} ms (idle share {1 - busy / span:.1%} under the "
        f"profiler); table and trace in {PROFILE_DIR}")
    log(table)


# ------------------------------------------------------------------ main

def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on the card",
              file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    smi = nvidia_smi_line()
    name = torch.cuda.get_device_name(0)
    log(f"[1] environment: {smi} | torch {torch.__version__} CUDA "
        f"{torch.version.cuda} | {name} x{torch.cuda.device_count()} | python "
        f"{sys.version.split()[0]}")

    log("[2] build")
    t0 = time.perf_counter()
    build.build(["warp"])
    log(f"  csrc/warp.cu -> sm_90a in {time.perf_counter() - t0:.1f} s")
    for line in build.BUILD_INFO["warp"]["log"].splitlines():
        if "registers" in line or "spill" in line:
            log("  ptxas " + line.strip())

    log("[3] kernels against their plain versions (main-path shapes)")
    dev = torch.device("cuda")
    errs = check_kernels(dev)
    timing = time_kernels(dev)

    log("[4] slice on the card against the slice on the CPU (float32)")
    check_slice_card_vs_cpu()

    log("[5] main path: PSPNet-50 bf16, 513 px key frames, n = 25")
    main_path = run_main_path()
    log(f"  {main_path['fps']:.2f} frames/s (median of {PASSES} passes x "
        f"{CLIPS_TIMED} windows; passes {[round(f, 2) for f in main_path['fps_passes']]}) "
        f"on {smi}")

    sources = {"grid_sample_cuda": ("floodseg_tpu/ops/pallas_warp.py:70",),
               "warp_chain_cuda": ("floodseg_tpu/ops/pallas_warp.py:139",)}
    kernels = []
    for kname, (replaces,) in sources.items():
        t = timing[kname]
        kernels.append({
            "name": kname, "route": "cuda", "source": "floodseg_tpu_torch/csrc/warp.cu",
            "replaces": replaces, "launches": main_path["launches"][kname],
            "max_abs_err": errs[kname], "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"], "passed": True})
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
