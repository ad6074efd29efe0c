#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port (floodseg_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py          # every phase, as below
    python3 chip_smoke.py --k2     # K2 alone: build, check, time (about 20 s)
    python3 chip_smoke.py --k3     # K3 alone: build, check, time (about 20 s)
    python3 chip_smoke.py --train  # the training phases alone: 3t, 4t and 14-17
    python3 chip_smoke.py --k1-bwd # phase 3t alone: K1 and K1-bwd at the training shapes

Phases, in order; any failure raises and the script exits non-zero:

1. Environment: the card's name and power limit (nvidia-smi), torch and
   CUDA versions. No CUDA device -> exit 1 before anything else.
2. Build the hand-written kernels from csrc/ with nvcc (sm_90a) and the
   image codec with the host C++ compiler, one compiler for each source,
   all at once: warp.cu (K1, K1-bwd, K2), resize.cu (K3) and jpeg.cpp; ptxas's
   registers and spills for each kernel instantiation; for K2 and K3,
   cuobjdump's count of slow-pipe instructions inside each instantiation's
   loops.
3. Each kernel against its plain PyTorch version, on the card, at the
   shapes the flow-predict paths give it: K1 and K2 on random grids and on
   the main path's own grids, K2 also on a grid that clamps every point to
   one corner and on the identity grid, and in both of its designs
   (ping-pong at 32x32, single-buffer at 67x120); K3 on the interpolated
   stack the int8 main path feeds it in its first window (24x32x32x4096
   -> 65x65), on random data in both align modes, at an odd shape whose C
   is not a 16-channel vector, with values far past the clip range, and
   on every finite bf16 value through an identity resize at four scales.
   K1 and K2 agree to
   the bit (tolerance float32 1e-5, bf16 1 ulp); K3's int8 outputs must be
   equal. Then each kernel's time on the main path's inputs (CUDA events,
   median, L2 flushed and the host's enqueue hidden behind a sleep kernel
   before each launch) beside the plain version's, the least time the
   card could take (bound), and a PyTorch library yardstick (F.grid_sample
   for K1 and K2; for K3, F.interpolate then the torch quantize, a
   two-call composition, since no single call computes K3).
3d. K1, K2 and K3 again at the DeepLabV3 path's shapes (C = 2048): K1
   (1, 64, 64, 2048) -> (1, 32, 32, 2048) on random grids, the main path's
   grids and the identity grid; K2 23 steps on (1, 32, 32, 2048) (a 32-
   channel tile, so 64 blocks); K3 on the stack the DeepLabV3 int8 path
   feeds it (24x32x32x2048 -> 64x64). The same tolerances, and each timed
   beside its bound.
3v. K1 and K2 at the ViT path's shapes (C = 768): K1 up-samples the
   (1, 16, 16, 768) token map to the 32x32 block grid (random grids, the
   main path's grids, the identity grid); K2 23 steps on (1, 32, 32, 768)
   (a 32-channel tile, so 24 blocks; the count is logged beside the
   card's SMs). The same tolerances, each timed beside its bound and
   F.grid_sample.
3c. K1 and K2 at the crop route's shapes (phase 12): PSPNet-50 encodes a
   433 px crop to (1, 55, 55, 4096) (read from the model); K1 warps it onto
   the first window's first crop grid (27x27) and, align_corners=True,
   onto the 67x120 full-frame identity grid (the key-map resample, an
   up-sample); K2 23 steps on (1, 27, 27, 4096) (its geometry logged). The
   same tolerances, each timed beside its bound and F.grid_sample.
4. The flow-predict slice in float32 (TF32 off) on the card against the
   same slice on the CPU: PSPNet-50 at 129 px key frames from a clip of
   128 px frames (SLICE_FRAME_HW, every slice check), n = 5, with each
   decoder; with an int8 decoder, the share of int8 lanes one step apart.
4b. The int8 decoder on the card against the CPU: the same int8 input and
   int8 weights give equal int32 accumulators; the bf16 logits of
   int8_seghead_decode agree within 2 bf16 ulps of their largest magnitude.
4d. The same for the DeepLabV3 slice, with each decoder.
4e. The DeepLabV3 int8 decode on the card against the CPU: every int8 conv
   of int8_deeplab_decode (the four ASPP branches, the projection, the
   trailing 3x3) replayed on the card from the CPU's int8 input and
   weights gives the CPU's int32 accumulator; the bf16 logits agree within
   the stated share of their largest magnitude.
4v. The Segmenter ViT-B/32 slice on the card against the CPU, 128 px key
   frames (4x4 tokens, 8x8 grids), n = 5, the MaskTransformer decoding a
   window as one call: in float32, then in bf16 (bf16 products reduced in
   float32 on the card, as the builders run them), logits and encodings
   within SLICE_TOL and ENC_TOL; the bf16 logits are read once more with
   PyTorch's default reduced-precision reduction, for the record.
5. The main path: PSPNet-50 in bf16 at full width, 513 px key frames,
   n = 25, 32x32 block grids, through make_cached_flow_predict_fn, with
   bench.py's protocol (8 timed windows, median of 5 passes). The launch
   counters are set to 0 before and read after: K1 must have launched 3
   times and K2 twice per window, K3 never.
   Then torch.profiler over two more cached windows: the device's busy
   time and idle share per window, the kernels a window, kernel time by
   name and by family (KERNEL_FAMILIES; the table and the trace go to
   build/profile/).
6. The int8 main path: the same model, windows and protocol with
   int8_decode=True. K1 3, K2 2 and K3 1 launches per window; frames/s and
   peak memory; the profiler over two cached windows; the device-time
   split of the int8 decode's pieces (im2col copy and torch._int_mm, timed
   with CUDA events at the path's shapes).
7. The DeepLabV3 main path (bench.py --arch deeplabv3 --no-int8):
   DeepLabV3-50 in bf16 at full width, 512 px key frames, n = 25, the bf16
   DeepLabHead decoding each window as one call; the same protocol and
   launch checks (K1 3, K2 2, K3 0 per window), profiler, peak memory.
8. The same with the int8 DeepLabHead (K3 1 per window), then the device-
   time split of its int8 decode at 25x64x64x2048 (each int8 conv's im2col
   copy and torch._int_mm, CUDA events).
9. The ViT main path (bench.py --arch vit): ViT-B/32 in bf16 at full
   width, 512 px key frames (16x16x768 token maps), n = 25, the bf16
   MaskTransformer decoding each window as one call (the ViT has no int8
   decoder); the same protocol and launch checks (K1 3, K2 2, K3 0 per
   window), profiler, peak memory.
   Each main path runs with only its own model on the card, so its peak
   memory is its own.
10. The image codec on this machine: a 1072x1920 synthetic frame through
   the port's JPEG encoder and decoder at q92 (PSNR above 35 dB), ms a
   frame on one thread and on 8 threads.
11. The cached route from files, bench.py's protocol: a 512 px tree from
   the port's writer, read by FlowDataset and the DataLoader (JPEG decode,
   resize to 513, device_put), PSPNet-50 bf16, n = 25; frames/s with the
   batches loaded before the timed loop and with the loader in the loop,
   the per-stage host breakdown, K1 3 and K2 2 launches a window, and the
   streamed windows' maps equal to the preloaded ones.
12. The CLI's default crop route at full width through run_flow_predict:
   a 1072x1920 tree of 51 frames (2 windows), 28 crops of 433 px a window,
   n = 25, PSPNet-50 bf16, metrics, palette PNGs and the MJPG AVI. K1 84
   and K2 56 launches a window; 50 PNGs; an AVI the port's reader reads as
   50 frames; seconds a window split into the crops on the device, the
   probabilities' copy to the host and the float64 canvas; device busy and
   the copies from torch.profiler; peak memory.
12b. The crop route in float32 on the card against the CPU at 128x192,
   64 px crops, n = 5: probabilities within 1e-4, maps equal away from
   near-ties.
Then the training phases, last, each model alone on the card:
3t. K1 and K1-bwd (K1's backward, csrc/warp.cu) at each architecture's
   training shapes (batch 2), in float32 and bf16: PSPNet-50's (2, 55, 55,
   4096) -> 27x27 (a chain's head, from a 433 px crop) and (2, 27, 27,
   4096) -> 27x27 (its steps); DeepLabV3's (2, 55, 55, 2048) and (2, 27,
   27, 2048) -> 27x27 and the ViT's (2, 13, 13, 768) -> 26x26 (an
   up-sample of the token map of a 416 px crop: about 16 output points
   scatter onto each source pixel) and (2, 26, 26, 768) -> 26x26. Each on
   random grids, the training batch's own crop grids (a synthetic
   1072x1920 clip's chains through the flow train transform at the
   architecture's crop), the identity grid and a grid that clamps
   every point to one corner (every tap on one pixel). K1 must be
   bit-equal to its plain version in float32; K1-bwd bit-equal (by integer
   view) to its plain version computed on the CPU, whose index_add_ sums
   in the order the kernel keeps (on the card index_add_ is atomic), in
   float32 and bf16, and two launches on one input bit-equal. K1-bwd also
   where its index build's working arrays take a device workspace, a (1,
   67, 120) grid onto (1, 134, 240, 256), random, identity and corner
   grids, and with C = 5 on grad_out at an odd element offset, both
   dtypes. Both timed in
   float32 beside the bytes bound, the plain version and the library
   (F.grid_sample, and aten.grid_sampler_2d_backward on NCHW for K1-bwd);
   K1-bwd at each head shape in bf16 too, and the workspace route in
   float32.
4t. Train steps on the card against the CPU, float32 with TF32 off and
   the flow config's SGD (lr 1e-4, heads 10x), each from the same initial
   state, every dropout with the same keep masks (one per module, drawn on
   the CPU): one interpolated, one plain and one eval step of PSPNet-50
   and DeepLabV3-50 with their aux heads at 65 px and of ViT-B/32 at
   128 px (4x4 tokens on 8x8 grids), and one supervised step of PSPNet-50
   with the aux loss at 0.4; batch 2, frame_delta 5. Losses within rtol
   1e-4, every parameter and BN statistic within 1e-4 of its tensor's
   largest magnitude, eval counts within 1% of the pixels (OHEM's
   min_kept of 100000 exceeds the pixels: no mining). What each step
   changed (p1 - p0: the gradient through K1-bwd, momentum and decay, the
   BN statistics' update) is held tensor by tensor: the same tensors move,
   and the card's change is within STEP_FLOOR_FACTOR times the CPU float32
   change's distance to the float64 change (the same steps in float64 on
   the CPU), and never tighter than STEP_ABS, of the tensor's largest
   change.
14-17. Training at full width on a 1072x1920 tree of 100 frames from the
   port's writer, the repository's configurations (float32 with TF32 off,
   batch 2, SGD 1e-4 with the heads at 10x, OHEM 0.7 / 100000, random
   weights): 14 flow-supervised PSPNet-50 with its aux head, 433 px crops,
   n = 25, through run_flow_fit (14 steps: 2 warm-up, 10 timed with a
   synchronise after each, the last 2 under torch.profiler; 3 validation
   frames); 15 flow-supervised DeepLabV3-101 with its aux head (433 px),
   16 flow-supervised ViT-B/32 (416 px crops, round_train of 433; 13x13
   tokens), each 8 steps (2 warm-up, 4 timed, 2 profiled) and 2
   validation frames; 17 the single-frame supervised method through
   run_fit and SemDataset: PSPNet-50 with the aux loss at 0.4, 873 px
   crops, the rotating train transform padded with MEAN, 8 steps, 2
   validation crops. Each: the loader alone first (ms a batch on 8
   threads); ms a step and samples/s, the step's wait for its batch,
   device busy, the idle share and ms a step by kernel family, peak
   memory. Checks: K1 48 and K1-bwd 48 launches every flow step (and K1 48
   a validation frame), K2 and K3 none, and no launch at all in phase 17;
   a finite loss; every BN's running mean moved but the aux head's in flow
   training (which never runs it); after the first flow step each aux
   parameter equals p0 - 10 lr wd p0 (a zero gradient, decayed and moved).
13. Last (after phase 17): a JSON line {"kernels": [...]} (each kernel's
   max_abs_err is its largest over every check; max_abs_err_by_dtype gives
   the largest in float32 and in bf16 apart), then the nvidia-smi line, then the last line {"ok": true, "device": {...}}.
"""

import copy
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import time
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
import torch.nn.functional as F

from floodseg_tpu_torch.core import full_precision_f32
from floodseg_tpu_torch.core.profiler import PhaseProfiler, cuda_sync
from floodseg_tpu_torch.data import (
    MEAN,
    STD,
    DataLoader,
    FlowDataset,
    SemDataset,
    build_test_transform,
    build_train_transform,
    collate,
    device_put,
    generate_synthetic_dataset,
    predict_windows,
    read_mjpg_avi,
    resize_frames,
    synthetic_clip,
)
from floodseg_tpu_torch.data.image import decode_jpeg, encode_jpeg, imread
from floodseg_tpu_torch.models import build_model, init_from_generator_
from floodseg_tpu_torch.models.layers import Dropout
from floodseg_tpu_torch.ops import build, launch_counts, quant, reset_launch_counts
from floodseg_tpu_torch.ops.grid_sample import (
    grid_sample,
    grid_sample_backward,
    tap_indices_weights,
)
from floodseg_tpu_torch.ops.resize_kernels import (
    resize_quantize_int8_cuda,
    resize_quantize_int8_plain,
)
from floodseg_tpu_torch.ops.warp_kernels import (
    _chain_geometry,
    _library as warp_library,
    grid_sample_backward_cuda,
    grid_sample_cuda,
    warp_chain_cuda,
    warp_chain_plain,
)
from floodseg_tpu_torch.train import (
    FitConfig,
    TrainState,
    crop_offsets,
    flow_sliding_window_predict,
    flow_transforms,
    make_cached_flow_predict_fn,
    make_flow_eval_step,
    make_flow_predict_crop_fn,
    make_flow_train_step,
    make_loss_fn,
    make_optimizer,
    make_train_step,
    round_train,
    run_fit,
    run_flow_fit,
    run_flow_predict,
    sem_transforms,
)
from floodseg_tpu_torch.train.flow import _predict_decode, decode_split_ok
from floodseg_tpu_torch.video import FlowInterpolator, default_grid, flow_model
from floodseg_tpu_torch.video.grid import crop_motion_vectors_stack_np

# the flow-predict workload of bench.py (SIZE: PSPNet; DL_SIZE: --arch
# deeplabv3 and --arch vit)
FRAME_DELTA = 25
SIZE = 513
DL_SIZE = 512
DL_FEAT_HW = (64, 64)
VIT_TOKENS_HW = (16, 16)  # ViT-B/32 at 512 px
VIT_D = 768
CLIPS_TIMED = 8
PASSES = 5
CLASSES = 5

# NVIDIA H100 SXM data sheet: HBM3 bandwidth, float32 (non-tensor) and
# dense int8 tensor-core rates
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
PEAK_INT8_OPS = 1979e12
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


def note_err(errs: dict, kname: str, dtype: torch.dtype, err: float) -> None:
    """Keep the largest error of ``kname`` in ``dtype``: errs[kname][dtype
    name] (the kernels line reports each dtype's and the largest)."""
    by_dtype = errs.setdefault(kname, {})
    tag = str(dtype).replace("torch.", "")
    by_dtype[tag] = max(by_dtype.get(tag, 0.0), err)


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
    errs = {}
    mvs, dg = main_path_grids(device)
    for dtype in (torch.float32, torch.bfloat16):
        x, grid, y0, grids, y0w, gridsw = kernel_cases(device, dtype, **shapes)
        tag = str(dtype).replace("torch.", "")
        for g, align, what in ((grid, False, "random"), (grid, True, "random"),
                               (mvs[0], False, "main-path"), (dg, True, "identity")):
            note_err(errs, "grid_sample_cuda", dtype, compare(
                f"K1 {tag} x{tuple(x.shape)} {what} grid{tuple(g.shape)} align={align}",
                grid_sample_cuda(x, g, align), grid_sample(x, g, align), dtype))
        note_err(errs, "warp_chain_cuda", dtype,
                 check_k2(x, y0, grids, y0w, gridsw, mvs, dg))
    return errs


def k2_design(y0) -> str:
    """Which of K2's designs the wrapper takes for y0 (1, gh, gw, C)."""
    _, gh, gw, c = y0.shape
    isz = y0.element_size()
    vec = 16 // isz if (c * isz) % 16 == 0 else 1
    return "ping-pong" if _chain_geometry(gh * gw, c, isz, vec).table_points else "single-buffer"


def check_k2(x, y0, grids, y0w, gridsw, mvs, dg) -> float:
    """K2 against its plain version in x's dtype: random grids at 32x32 and
    at the reference's 67x120 (the single-buffer design), the main path's
    own grids from K1's plain output, and two degenerate grids on the same
    input: every point clamped to the top-left corner (the four taps of a
    point coincide and merge) and the identity grid (the 32x32 block
    centres, align_corners=False)."""
    dtype = x.dtype
    tag = str(dtype).replace("torch.", "")
    y0m = grid_sample(x, mvs[0], False)
    ident = dg.expand((mvs.shape[0] - 1,) + tuple(dg.shape)).contiguous()
    corner = torch.full_like(ident, -1.1)
    err = 0.0
    for y, gs, what in ((y0, grids, "random"), (y0w, gridsw, "random"),
                        (y0m, mvs[1:], "main-path"), (y0m, corner, "corner"),
                        (y0m, ident, "identity")):
        err = max(err, compare(
            f"K2 {tag} y0{tuple(y.shape)} {what} T={gs.shape[0]} ({k2_design(y)}, every step)",
            warp_chain_cuda(y, gs), warp_chain_plain(y, gs), dtype))
    return err


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


def time_kernels(device, k1_shape=(1, 65, 65, 4096)) -> dict:
    """Phase 3b: bf16 on the main path's own inputs: a key encoding
    (65x65x4096 for PSPNet, 64x64x2048 for DeepLabV3), the first window's
    block grids (K1's first warp of a chain, then K2's 23 steps from K1's
    output) and the identity grid (K1's key-map resample,
    align_corners=True)."""
    flush = L2Flush(device)
    cpm = sleep_cycles_per_ms()
    g = torch.Generator().manual_seed(0)
    x = torch.randn(k1_shape, generator=g).to(device, torch.bfloat16)
    mvs, dg = main_path_grids(device)
    grid, grids = mvs[0], mvs[1:]
    y0 = grid_sample_cuda(x, grid, False)
    # the library call takes NCHW data, and grids of the data's dtype
    xn = x.permute(0, 3, 1, 2).contiguous()
    grid_l, dg_l = grid.to(x.dtype), dg.to(x.dtype)

    def k1(g, g_l, align):
        return time_k1(x, xn, g, g_l, align, flush, cpm)

    res = {
        "grid_sample_cuda": k1(grid, grid_l, False),
        "grid_sample_cuda (identity grid, align_corners=True)": k1(dg, dg_l, True),
        "warp_chain_cuda": time_k2(y0, grids, flush, cpm),
    }
    log_timing(res)
    return res


def time_k1(x, xn, g, g_l, align, flush, cpm) -> dict:
    """K1's time on x (NHWC) and grid g beside its bound, its plain
    version's and F.grid_sample's on xn (NCHW) and g_l (x's dtype)."""
    out = grid_sample_cuda(x, g, align)
    # 4 multiplies and 3 adds per output element
    b = bound(k1_bytes(x, g, out, align), 7 * out.numel())
    return {
        "ms": time_ms(lambda: grid_sample_cuda(x, g, align), flush, cpm),
        "plain_ms": time_ms(lambda: grid_sample(x, g, align), flush, cpm),
        "library_ms": time_ms(lambda: F.grid_sample(
            xn, g_l, mode="bilinear", padding_mode="border", align_corners=align),
            flush, cpm),
        "bound_ms": b[0], "bound_by": b[1],
    }


def log_timing(res: dict, library="F.grid_sample") -> None:
    for name, r in res.items():
        split = ", ".join(f"{k} {v:.2f}" for k, v in r.get("split_us", {}).items())
        log(f"  {name}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
            f"{library} {r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']}) -> {r['bound_ms'] / r['ms']:.1%} of bound"
            + (f"; device us a call by kernel {split}" if split else ""))


def time_k2(y0, grids, flush, cpm, full=True) -> dict:
    """K2's time on y0 and grids beside its bound (y0 and the grids read
    once, every step written once; 4 multiplies and 3 adds per element of
    a step); with ``full``, also its plain version's and the library
    yardstick's: T chained F.grid_sample calls on NCHW data."""
    out = warp_chain_cuda(y0, grids)
    b = bound(nbytes(y0, grids, out), 7 * (out.numel() - y0.numel()))
    r = {"ms": time_ms(lambda: warp_chain_cuda(y0, grids), flush, cpm),
         "bound_ms": b[0], "bound_by": b[1]}
    if full:
        y0n = y0.permute(0, 3, 1, 2).contiguous()
        grids_l = grids.to(y0.dtype)

        def lib_chain():
            y = y0n
            for i in range(grids.shape[0]):
                y = F.grid_sample(y, grids_l[i], mode="bilinear", padding_mode="border",
                                  align_corners=False)
            return y

        r["plain_ms"] = time_ms(lambda: warp_chain_plain(y0, grids), flush, cpm, reps=5)
        r["library_ms"] = time_ms(lib_chain, flush, cpm, reps=10)
    return r


# -------------------------------------------------------------------- K3

PAD1 = ((1, 1), (1, 1))
FEAT_HW = (65, 65)


def k3_compare(name, got, ref) -> float:
    """K3 against its plain version: the int8 outputs must be equal."""
    diff = (got.int() - ref.int()).abs()
    err = float(diff.max())
    share = float((diff != 0).float().mean())
    log(f"  {name}: max_abs_err {err:.0f} on {share:.2e} of lanes (tol 0) -> "
        f"{'ok' if err == 0 else 'FAIL'}")
    if err != 0:
        raise AssertionError(f"{name} disagrees with its plain version by {err}")
    return err


def finite_bf16_values(device) -> torch.Tensor:
    """Every finite bf16 bit pattern (65,280 values), as (1, 1, 4080, 16)."""
    v = torch.arange(1 << 16, dtype=torch.int32).to(torch.int16).view(torch.bfloat16)
    v = v[torch.isfinite(v.float())]
    return v.reshape(1, 1, -1, 16).to(device)


def check_k3(stack, scale, seed=0, feat_hw=FEAT_HW, every=True) -> dict:
    """Phase 3a for K3, float32 and bf16: the main path's first-window stack
    at its own scale, random data in both align modes at the same shape and
    at an odd shape with C = 37 (one channel a thread), every case again at
    a fiftieth of its scale (most lanes saturate); then every finite bf16
    value through an identity resize (out_hw equal to the input's), at the
    stack's scale, a fiftieth of it, FLT_MIN and 2**-7 (many values on
    half-integers), so each value's quantize is checked on its own
    (``every``; the values do not depend on the stack's shape). Returns the
    largest error by input dtype."""
    g = torch.Generator().manual_seed(seed)
    errs = {}
    every_value = finite_bf16_values(stack.device)
    tiny = torch.tensor(torch.finfo(torch.float32).tiny, device=stack.device)
    for dtype in (torch.float32, torch.bfloat16):
        tag = str(dtype).replace("torch.", "")
        cases = [("main-path stack", stack.to(dtype), scale, feat_hw, True)]
        for shape, hw in ((tuple(stack.shape), feat_hw), ((3, 6, 5, 37), (11, 9))):
            x = (torch.randn(shape, generator=g) * 3).to(stack.device, dtype)
            s = quant.scale_from_absmax(x.float().abs().amax())
            cases += [("random", x, s, hw, align) for align in (True, False)]
        for what, x, s, hw, align in cases:
            for sc, sat in ((s, ""), (s / 50, ", saturating")):
                note_err(errs, "K3", dtype, k3_compare(
                    f"K3 {tag} {what} x{tuple(x.shape)} -> {hw} align={align}{sat}",
                    resize_quantize_int8_cuda(x, sc, hw, align),
                    resize_quantize_int8_plain(x, sc, hw, align)))
        if not every:
            continue
        x = every_value.to(dtype)
        hw = tuple(x.shape[1:3])
        for sc, what in ((scale, "the stack's scale"), (scale / 50, "a fiftieth of it"),
                         (tiny, "FLT_MIN"), (torch.full_like(tiny, 2.0 ** -7), "2**-7")):
            note_err(errs, "K3", dtype, k3_compare(
                f"K3 {tag} every finite bf16 value x{tuple(x.shape)} -> {hw} (identity), "
                f"scale {what}", resize_quantize_int8_cuda(x, sc, hw, True),
                resize_quantize_int8_plain(x, sc, hw, True)))
    return errs["K3"]


def time_k3(stack, scale, feat_hw=FEAT_HW) -> dict:
    """Phase 3b for K3 on the main path's first-window stack."""
    flush = L2Flush(stack.device)
    cpm = sleep_cycles_per_ms()
    out = resize_quantize_int8_cuda(stack, scale, feat_hw, True)
    b, _, w, c = stack.shape
    # per output element: the W blend (2 multiplies, 1 add), the divide, the
    # round and the clip; per H-interpolated value: 2 multiplies and 1 add
    flops = 6 * out.numel() + 3 * b * feat_hw[0] * w * c
    bd = bound(nbytes(stack, scale, out), flops)
    xn = stack.permute(0, 3, 1, 2)  # NCHW view of the NHWC (channels-last) stack

    def library():  # two calls: PyTorch has no fused resize + quantize
        y = F.interpolate(xn, size=feat_hw, mode="bilinear", align_corners=True)
        return quant.quantize_with_scale(y.permute(0, 2, 3, 1), scale)

    r = {"ms": time_ms(lambda: resize_quantize_int8_cuda(stack, scale, feat_hw, True),
                       flush, cpm),
         "plain_ms": time_ms(lambda: resize_quantize_int8_plain(stack, scale, feat_hw, True),
                             flush, cpm, reps=5),
         "library_ms": time_ms(library, flush, cpm, reps=10),
         "bound_ms": bd[0], "bound_by": bd[1]}
    log(f"  resize_quantize_int8_cuda x{tuple(stack.shape)} {stack.dtype} -> int8 "
        f"{tuple(out.shape)}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
        f"F.interpolate + quantize {r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
        f"({r['bound_by']}) -> {r['bound_ms'] / r['ms']:.1%} of bound")
    return r


def capture_k3_input(model, wins, dev, n=FRAME_DELTA, size=SIZE, frame_hw=(512, 512),
                     feat_hw=FEAT_HW, channels=4096):
    """The interpolated stack and scale that an int8 main path gives K3 in
    its first window, recorded on the way through the full program."""
    full, _ = make_cached_flow_predict_fn(
        model, n=n, out_size=(size, size), default_grid=default_grid(*frame_hw),
        int8_decode=True, device=dev)
    seen = {}
    kernel = flow_model.resize_quantize_int8_cuda

    def recording(x, scale, out_hw, align_corners=True):
        seen.update(x=x.clone(), scale=scale.clone(), out_hw=tuple(out_hw),
                    align=align_corners)
        return kernel(x, scale, out_hw, align_corners)

    flow_model.resize_quantize_int8_cuda = recording
    try:
        w = wins[0]
        full(model.state_dict(), w["frame_prev"], w["frame_next"], w["mvs_left"],
             w["mvs_right"])
    finally:
        flow_model.resize_quantize_int8_cuda = kernel
    sync(torch.device(dev))
    grid_hw = tuple(wins[0]["mvs_left"].shape[2:4])
    if (seen.get("out_hw") != tuple(feat_hw) or seen["align"] is not True
            or tuple(seen["x"].shape) != (n - 1,) + grid_hw + (channels,)):
        raise AssertionError(f"K3's main-path input is not as expected: "
                             f"{ {k: getattr(v, 'shape', v) for k, v in seen.items()} }")
    log(f"  K3's input in the first int8 window: {tuple(seen['x'].shape)} "
        f"{seen['x'].dtype}, scale {float(seen['scale']):.6e}")
    return seen["x"], seen["scale"]


def check_int8_decode_card_vs_cpu(model, shape=(2, 33, 33, 4096), seed=2) -> None:
    """Phase 4b: the same int8 input and int8 weights give equal int32
    accumulators on the card and the CPU; int8_seghead_decode's bf16 logits
    (each device folding and quantizing the head itself) agree within 2
    bf16 ulps of their largest magnitude: the 1x1 conv sums in another order
    before its bf16 rounding, and a one-ulp rsqrt difference in the fold can
    move an int8 weight by one step."""
    g = torch.Generator().manual_seed(seed)
    x_q = torch.randint(-127, 128, shape, generator=g, dtype=torch.int8)
    absmax = torch.tensor(4.0)
    head = model.cls.state_dict()
    head_cpu = {k: v.cpu() for k, v in head.items()}

    def qweights(h):
        w_f, _ = quant.fold_bn(h["0.weight"], h["1.weight"], h["1.bias"],
                               h["1.running_mean"], h["1.running_var"])
        return quant.quantize_weight_per_channel(w_f)[0]

    w_q = qweights(head_cpu)
    t0 = time.perf_counter()
    acc_cpu = quant.conv_int8(x_q, w_q, PAD1)
    t1 = time.perf_counter()
    acc_card = quant.conv_int8(x_q.cuda(), w_q.cuda(), PAD1).cpu()
    same = torch.equal(acc_cpu, acc_card)
    log(f"  conv_int8 {tuple(x_q.shape)} x {tuple(w_q.shape)} -> int32 "
        f"{tuple(acc_cpu.shape)}: card {'equals' if same else 'DIFFERS FROM'} CPU "
        f"(CPU {t1 - t0:.3f} s)")
    if not same:
        raise AssertionError("int32 accumulators differ between card and CPU")
    flips = int((qweights(head).cpu() != w_q).sum())
    ref = quant.int8_seghead_decode(head_cpu, x_q, torch.bfloat16, act_absmax=absmax)
    got = quant.int8_seghead_decode(head, x_q.cuda(), torch.bfloat16,
                                    act_absmax=absmax.cuda()).cpu()
    scale = float(ref.float().abs().max())
    tol = scale * 2.0 ** -6
    err = float((got.float() - ref.float()).abs().max())
    log(f"  int8_seghead_decode bf16 logits {tuple(ref.shape)}: max_abs_err {err:.3e}, "
        f"tol {tol:.3e} (2 bf16 ulps at max|logit| {scale:.3e}); {flips} of "
        f"{w_q.numel()} int8 weights differ between the devices' folds")
    if not err <= tol:
        raise AssertionError(f"int8 decode logits differ between card and CPU: {err}")


def check_int8_deeplab_decode_card_vs_cpu(model, shape=(2, 33, 33, 2048), seed=2,
                                          share=2e-2) -> None:
    """Phase 4e: int8_deeplab_decode on the CPU with every conv_int8 call
    recorded; each call replayed on the card from the CPU's int8 input and
    weights must give the CPU's int32 accumulator (the dilated branches at
    rates 12, 24 and 36, the projection, the trailing 3x3). The whole
    decode's bf16 logits, each device folding and quantizing the head
    itself, within ``share`` of their largest magnitude: an int8 weight one
    step apart between the devices' folds moves a lane of the concat or the
    projection, at their dynamic scales."""
    g = torch.Generator().manual_seed(seed)
    x_q = torch.randint(-127, 128, shape, generator=g, dtype=torch.int8)
    absmax = torch.tensor(4.0)
    head_cpu = {k: v.cpu() for k, v in model.classifier.state_dict().items()}
    head = {k: v.cuda() for k, v in head_cpu.items()}
    calls, conv = [], quant.conv_int8

    def recording(x, w, padding, dilation=(1, 1), strides=(1, 1)):
        acc = conv(x, w, padding, dilation, strides)
        calls.append((x, w, padding, dilation, acc))
        return acc

    quant.conv_int8 = recording
    try:
        ref = quant.int8_deeplab_decode(head_cpu, x_q, torch.bfloat16, act_absmax=absmax)
    finally:
        quant.conv_int8 = conv
    if [c[3] for c in calls] != [(1, 1), (12, 12), (24, 24), (36, 36), (1, 1), (1, 1)]:
        raise AssertionError(f"unexpected int8 convs: {[c[3] for c in calls]}")
    for x, w, padding, dilation, acc in calls:
        got = quant.conv_int8(x.cuda(), w.cuda(), padding, dilation).cpu()
        same = torch.equal(got, acc)
        log(f"  conv_int8 {tuple(x.shape)} x {tuple(w.shape)} dilation {dilation} -> "
            f"int32 {tuple(acc.shape)}: card {'equals' if same else 'DIFFERS FROM'} CPU")
        if not same:
            raise AssertionError("int32 accumulators differ between card and CPU")
    got = quant.int8_deeplab_decode(head, x_q.cuda(), torch.bfloat16,
                                    act_absmax=absmax.cuda()).cpu()
    scale = float(ref.float().abs().max())
    err = float((got.float() - ref.float()).abs().max())
    log(f"  int8_deeplab_decode bf16 logits {tuple(ref.shape)}: max_abs_err {err:.3e} "
        f"({err / scale:.2e} of max|logit| {scale:.3e}), tol {share:g} x")
    if not err <= share * scale:
        raise AssertionError(f"int8 DeepLab decode logits differ between card and CPU: {err}")


# ------------------------------------------------------------- the slice

def random_model(arch, dtype, seed=0, image_size=DL_SIZE, with_aux=False, layers=50):
    """PSPNet or DeepLabV3 with a ResNet-``layers`` trunk (with the aux head
    if ``with_aux``), or ViT-B/32 for ``image_size`` px frames, with weights
    from one torch.Generator seed, every BN's statistics and every
    LayerNorm perturbed."""
    model = build_model(arch, classes=CLASSES, layers=layers, image_size=image_size,
                        with_aux=with_aux, dtype=dtype)
    return init_from_generator_(model, torch.Generator().manual_seed(seed))


def clip_windows(n, frame_hw, num_windows, size, device, seed=0):
    """In-memory synthetic windows, frames resized to ``size`` on ``device``."""
    clip = synthetic_clip(num_windows * n + 1, size=frame_hw,
                          frame_ids=range(0, num_windows * n + 1, n), seed=seed)
    wins = []
    for w in predict_windows(clip, n):
        wins.append({
            "frame_prev": resize_frames(torch.as_tensor(w["frame_prev"], device=device),
                                        (size, size)),
            "frame_next": resize_frames(torch.as_tensor(w["frame_next"], device=device),
                                        (size, size)),
            "mvs_left": torch.as_tensor(w["mvs_left"], device=device),
            "mvs_right": torch.as_tensor(w["mvs_right"], device=device),
            "prev_frame_id": w["prev_frame_id"],
            "next_frame_id": w["next_frame_id"],
        })
    return wins


def window_logits(model, w, n, dg, size, device, int8=False):
    """Logits (n, size, size, classes) of one window through the
    interpolator with the builders' decoder, frames normalised as the
    predict builders do; ``int8`` decodes with the model's int8 head at the
    key encodings' absmax hint."""
    mean = torch.tensor(MEAN, device=device)
    std = torch.tensor(STD, device=device)
    interp = FlowInterpolator(lambda x: model.encode(x)[0], _predict_decode(model, int8),
                              decode_wants_absmax=int8, decode_split=decode_split_ok(model))
    with torch.inference_mode():
        return interp.predict_clip(
            (w["frame_prev"].float() - mean) / std,
            (w["frame_next"].float() - mean) / std,
            w["mvs_left"], w["mvs_right"], n,
            default_grid=torch.as_tensor(dg, device=device), out_size=(size, size))


def slice_outputs(model, device, n, size, frame_hw, wins, int8):
    """Logits of window 0 through the interpolator, and the int32 maps and
    next encodings of the full program (window 0) and the cached program
    (window 1) through make_cached_flow_predict_fn."""
    dg = default_grid(*frame_hw)
    full, cached = make_cached_flow_predict_fn(
        model, n=n, out_size=(size, size), default_grid=dg, int8_decode=int8,
        device=device)
    variables = model.state_dict()
    w0, w1 = (  # the builders take raw frames; the interpolator normalised ones
        {k: (v.to(device) if torch.is_tensor(v) else v) for k, v in w.items()}
        for w in wins[:2])
    logits = window_logits(model, w0, n, dg, size, device, int8)
    maps0, enc0 = full(variables, w0["frame_prev"], w0["frame_next"],
                       w0["mvs_left"], w0["mvs_right"])
    maps1, enc1 = cached(variables, enc0, w1["frame_next"], w1["mvs_left"],
                         w1["mvs_right"])
    return {k: (v.float() if v.is_floating_point() else v).cpu()
            for k, v in dict(logits=logits, maps0=maps0, enc0=enc0, maps1=maps1,
                             enc1=enc1).items()}


# card against CPU, share of the logits' largest magnitude, by the slice's
# arch and decoder ("float32", "int8" on a float32 model, "bfloat16"): float32
# through ~55 layers in different summation orders agrees to 1e-4. With an int8
# head, a value that the two devices' float32 encoders put on either side
# of a rounding boundary is quantized one step apart: the SegHead's one
# quantization moves nearby logits by about 1e-3 of their scale; the
# DeepLabHead quantizes three times (the input, the ASPP concat, the
# projection), and each one-step lane moves many values of the next map
# (on the CPU against JAX: 0.7% of the scale, tests/test_torch_flow_deeplabv3.py;
# on an H100 80GB HBM3, 700 W, card against CPU: 2.53%). The ViT's float32
# logits, after 14 transformer blocks and a LayerNorm over the 5 classes,
# are held to the CNNs' 1e-4 (on the CPU against JAX at 64 px: 4.9e-5 at
# most, tests/test_torch_flow_vit.py). In bf16 the ViT rounds the same
# operations in the same order on both devices, but float32 sums inside a
# rounding differ, so a value near a bf16 boundary lands one ulp apart and
# the next layers carry it on: the bounds of ViT-B/32 in bf16 against JAX
# on the CPU (tests/test_torch_vit.py::test_full_width_vit_b32_bf16_matches_jax,
# 64 px), 24 bf16 ulps (2**-8 of the largest magnitude each) for the logits
# and 8 for the encoder's token map (9.92 and 4.11 measured there).
SLICE_TOL = {("pspnet", "float32"): 1e-4, ("pspnet", "int8"): 2e-3,
             ("deeplabv3", "float32"): 1e-4, ("deeplabv3", "int8"): 5e-2,
             ("vit", "float32"): 1e-4, ("vit", "bfloat16"): 24 * 2.0 ** -8}
ENC_TOL = {"float32": 1e-4, "int8": 1e-4, "bfloat16": 8 * 2.0 ** -8}
SLICE_FRAME_HW = (128, 128)  # the clip's frames; key frames resized to ``size``


class Int8Inputs:
    """Records the int8 input of every conv_int8 call in the block."""

    def __enter__(self):
        self.maps, self.conv = [], quant.conv_int8

        def recording(x_q, *a, **k):
            self.maps.append(x_q.cpu())
            return self.conv(x_q, *a, **k)

        quant.conv_int8 = recording
        return self

    def __exit__(self, *exc):
        quant.conv_int8 = self.conv


def lanes_off(a, b):
    """(share of lanes where int8 maps a and b differ, largest difference)."""
    d = (a.int() - b.int()).abs()
    return float((d != 0).float().mean()), int(d.max())


def check_slice_card_vs_cpu(arch="pspnet", n=5, size=129, seed=1, int8=False,
                            dtype=torch.float32) -> None:
    """Phases 4, 4d and 4v: a float32 model (TF32 off) or a bf16 one (bf16
    products reduced in float32), the same weights and inputs on both,
    logits within SLICE_TOL and the key encodings within ENC_TOL of their
    largest magnitude; the maps equal away from near-ties. Key frames of
    ``size`` px from a clip of SLICE_FRAME_HW frames."""
    mode = "int8" if int8 else str(dtype).split(".")[-1]
    cpu_model = random_model(arch, dtype, seed, image_size=size)
    gpu_model = copy.deepcopy(cpu_model)
    wins = clip_windows(n, SLICE_FRAME_HW, 2, size, "cpu", seed)
    matmul = torch.backends.cuda.matmul
    with full_precision_f32():
        log(f"  {mode} decoder; cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
            f"cuda.matmul.allow_tf32={matmul.allow_tf32} cuda.matmul."
            f"allow_bf16_reduced_precision_reduction="
            f"{matmul.allow_bf16_reduced_precision_reduction}")
        t0 = time.perf_counter()
        with Int8Inputs() as ref_maps:
            ref = slice_outputs(cpu_model, torch.device("cpu"), n, size, SLICE_FRAME_HW,
                                wins, int8)
        t1 = time.perf_counter()
        with Int8Inputs() as got_maps:
            got = slice_outputs(gpu_model, torch.device("cuda"), n, size, SLICE_FRAME_HW,
                                wins, int8)
        torch.cuda.synchronize()
    log(f"  cpu {t1 - t0:.1f} s, card {time.perf_counter() - t1:.1f} s")
    if int8:
        # each decode call's int8 maps, by where they were quantized
        per_call = 6 if arch == "deeplabv3" else 1
        names = (("input", "input", "input", "input", "concat", "projection")
                 if arch == "deeplabv3" else ("input",))
        worst = {}
        for i, (a, b) in enumerate(zip(got_maps.maps, ref_maps.maps)):
            share, step = lanes_off(a, b)
            k = names[i % per_call]
            worst[k] = max(worst.get(k, (0.0, 0)), (share, step))
        log(f"  int8 maps card vs CPU over {len(ref_maps.maps)} convs, the largest share "
            f"of lanes off and step by quantization: {worst}")
    scale = float(ref["logits"].abs().max())
    share = SLICE_TOL[(arch, mode)]
    tol = share * scale
    err = float((got["logits"] - ref["logits"]).abs().max())
    log(f"  logits {tuple(ref['logits'].shape)}: max_abs_err {err:.3e} "
        f"({err / scale:.2e} of max|logit| {scale:.3e}; {err / scale / 2.0 ** -8:.2f} "
        f"bf16 ulps of it), tol {tol:.3e} ({share:g} x)")
    if not err <= tol:
        raise AssertionError(f"card and CPU logits disagree: {err} > {tol}")
    if dtype == torch.bfloat16:
        # the reading with PyTorch's default, bf16 partial sums allowed (the
        # block restores the flag on exit)
        w0 = {k: (v.cuda() if torch.is_tensor(v) else v) for k, v in wins[0].items()}
        with full_precision_f32():
            matmul.allow_bf16_reduced_precision_reduction = True
            loose = window_logits(gpu_model, w0, n, default_grid(*SLICE_FRAME_HW), size,
                                  torch.device("cuda")).float().cpu()
        e = float((loose - ref["logits"]).abs().max())
        log(f"  logits with allow_bf16_reduced_precision_reduction=True: max_abs_err "
            f"{e:.3e} ({e / scale / 2.0 ** -8:.2f} bf16 ulps of max|logit|; reading only)")
    for k in ("enc0", "enc1"):
        s = float(ref[k].abs().max())
        e = float((got[k] - ref[k]).abs().max())
        etol = ENC_TOL[mode] * s
        log(f"  {k} {tuple(ref[k].shape)}: max_abs_err {e:.3e} ({e / s:.2e} of "
            f"max|enc| {s:.3e}), tol {etol:.3e}")
        if not e <= etol:
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
    if same1 < (0.999 if mode == "float32" else 0.99):
        raise AssertionError(f"cached-window maps agree on only {same1:.6f}")


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run_main_path(model, wins, int8, tag, dev=torch.device("cuda"), n=FRAME_DELTA,
                  size=SIZE, frame_hw=(512, 512)) -> dict:
    """Phases 5 to 9: a bf16 model (PSPNet-50 at 513 px, DeepLabV3-50 and
    ViT-B/32 at 512 px), n = 25, bench.py's protocol, with the
    full-precision or the int8 decoder."""
    full, cached = make_cached_flow_predict_fn(
        model, n=n, out_size=(size, size), default_grid=default_grid(*frame_hw),
        int8_decode=int8, device=dev)
    variables = model.state_dict()
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
    sync(dev)
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
    per_window = {"grid_sample_cuda": 3, "grid_sample_backward_cuda": 0, "warp_chain_cuda": 2,
                  "resize_quantize_int8_cuda": 1 if int8 else 0}
    expected = {k: v * windows if dev.type == "cuda" else 0 for k, v in per_window.items()}
    if counts != expected:
        raise AssertionError(f"the main path did not go through the kernels as "
                             f"expected per window: {counts}, expected {expected}")
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9 if dev.type == "cuda" else 0.0

    if out.shape != (n, size, size) or out.dtype != torch.int32:
        raise AssertionError(f"maps {tuple(out.shape)} {out.dtype}")
    lo, hi = int(out.min()), int(out.max())
    if lo < 0 or hi >= CLASSES:
        raise AssertionError(f"class ids outside [0, {CLASSES}): {lo}..{hi}")
    if not bool(torch.isfinite(state["feat"]).all()):
        raise AssertionError("non-finite next-key encoding")
    # logits of one window (outside the counted run): finite, expected shape
    logits = window_logits(model, timed[0], n, default_grid(*frame_hw), size, dev, int8)
    if logits.shape != (n, size, size, CLASSES) or not bool(
            torch.isfinite(logits).all()):
        raise AssertionError(f"logits {tuple(logits.shape)} not finite or misshapen")
    log(f"  maps {tuple(out.shape)} int32 in [{lo}, {hi}], logits "
        f"{tuple(logits.shape)} {logits.dtype} finite, peak memory {peak_gb:.2f} GB")

    prof = profile(run, timed, tag) if dev.type == "cuda" else {}
    return {"fps": statistics.median(fps), "fps_passes": fps, "windows": windows,
            "launches": counts, "peak_gb": peak_gb, "maps": out, **prof}


PROFILE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "build", "profile")
KERNEL_NAMES = {"grid_sample_cuda": "grid_sample_kernel",
                "grid_sample_backward_cuda": "grid_sample_backward_",  # index and gather
                "warp_chain_cuda": "warp_chain_",  # either design
                "resize_quantize_int8_cuda": "resize_quantize_kernel"}
# a window's device time by family of kernel names; the first family whose
# pattern a name contains takes it (cuDNN's implicit-GEMM convolutions
# before the matrix products, the casts before the other elementwise work)
KERNEL_FAMILIES = (
    ("K1-K3", tuple(KERNEL_NAMES.values())),
    ("convolutions", ("fprop", "cudnn")),
    ("matrix products", ("gemm", "nvjet", "cutlass")),
    ("copies and casts", ("copy", "CatArray")),
    ("softmax", ("softmax",)),
    ("reductions", ("reduce_kernel",)),
    ("other elementwise", ("",)),
)


def kernel_families(kernels, windows=2) -> dict:
    """ms a window of each KERNEL_FAMILIES family over trace kernel events."""
    ms = {name: 0.0 for name, _ in KERNEL_FAMILIES}
    for e in kernels:
        family = next(name for name, pats in KERNEL_FAMILIES
                      if any(p in e["name"] for p in pats))
        ms[family] += e["dur"] / (1e3 * windows)
    return ms


def profile(run, timed, tag) -> dict:
    """torch.profiler over two cached windows: device busy time and idle
    share per window, each kernel's time per window, kernel time by name."""
    from torch.profiler import ProfilerActivity, profile as tprofile
    os.makedirs(PROFILE_DIR, exist_ok=True)
    run(timed[0], first=True)
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for w in timed[1:3]:
            run(w)
        torch.cuda.synchronize()
    table = prof.key_averages().table(sort_by="cuda_time_total", row_limit=25)
    with open(os.path.join(PROFILE_DIR, f"{tag}_main_path_profile.txt"), "w") as f:
        f.write(table)
    trace = os.path.join(PROFILE_DIR, f"{tag}_main_path_trace.json")
    prof.export_chrome_trace(trace)
    with open(trace) as f:
        kernels = [e for e in json.load(f)["traceEvents"]
                   if e.get("ph") == "X" and e.get("cat") == "kernel"]
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in kernels)
    busy = union_us(spans)
    span = max(e for _, e in spans) - spans[0][0]
    per_kernel = {k: sum(e["dur"] for e in kernels if v in e["name"]) / 2e3
                  for k, v in KERNEL_NAMES.items()}
    families = kernel_families(kernels)
    log(f"  profiler, 2 cached windows: device busy {busy / 2e3:.3f} ms/window "
        f"of {span / 2e3:.3f} ms (idle share {1 - busy / span:.1%} under the "
        f"profiler); ms/window by kernel {per_kernel}; table and trace in "
        f"{PROFILE_DIR}")
    log(f"  {len(kernels) / 2:.0f} kernels a window; ms/window by family "
        f"{ {k: round(v, 3) for k, v in families.items()} }")
    log(table)
    return {"busy_ms": busy / 2e3, "span_ms": span / 2e3, "kernel_ms": per_kernel,
            "family_ms": families}


def time_int8_conv(name, x_q, w_q, padding, dilation, flush, cpm) -> dict:
    """One int8 conv's two pieces at its path's shape, CUDA events with the
    L2 flushed: the im2col copy and torch._int_mm, the GEMM beside its bound
    at the int8 peak."""
    k = w_q.shape[-1]
    w_mat = w_q.permute(0, 2, 3, 1).reshape(w_q.shape[0], -1).t()
    cols, _ = quant.im2col_nhwc(x_q, k, k, padding, dilation)
    m, kk = cols.shape
    r = {"im2col_ms": time_ms(lambda: quant.im2col_nhwc(x_q, k, k, padding, dilation),
                              flush, cpm, reps=10),
         "int_mm_ms": time_ms(lambda: torch._int_mm(cols, w_mat), flush, cpm, reps=10),
         "im2col_bytes": cols.numel() + x_q.numel(),
         "int_mm_tops": 2 * m * kk * w_mat.shape[1] / 1e12}
    r["int_mm_bound_ms"] = r["int_mm_tops"] * 1e12 / PEAK_INT8_OPS * 1e3
    log(f"  {name} {tuple(x_q.shape)} -> {w_q.shape[0]}: im2col {r['im2col_ms']:.4f} ms "
        f"({r['im2col_bytes'] / 1e9:.3f} GB moved at least), _int_mm "
        f"{r['int_mm_ms']:.4f} ms ({r['int_mm_tops']:.3f} TOP, bound "
        f"{r['int_mm_bound_ms']:.4f} ms at the int8 peak)")
    return r


def random_int8(shape, g, dev):
    return torch.randint(-127, 128, shape, generator=g, dtype=torch.int8).to(dev)


def time_decode_pieces(model, n=FRAME_DELTA) -> dict:
    """Phase 6b: the int8 SegHead's pieces at the main path's shapes (the
    key map, 1x65x65x4096, and the stack, 24x65x65x4096): its conv's im2col
    and torch._int_mm, and the whole decode (weights folded and quantized,
    the epilogue and the 1x1 conv included), CUDA events, L2 flushed."""
    dev = torch.device("cuda")
    flush, cpm = L2Flush(dev), sleep_cycles_per_ms()
    head = model.cls.state_dict()
    w_f, _ = quant.fold_bn(head["0.weight"], head["1.weight"], head["1.bias"],
                           head["1.running_mean"], head["1.running_var"])
    w_q, _ = quant.quantize_weight_per_channel(w_f)
    g = torch.Generator().manual_seed(3)
    absmax = torch.tensor(4.0, device=dev)
    res = {}
    for name, b in (("key map", 1), ("stack", n - 1)):
        x_q = random_int8((b,) + FEAT_HW + (4096,), g, dev)
        r = res[name] = time_int8_conv(f"the {name}'s 3x3", x_q, w_q, PAD1, (1, 1),
                                       flush, cpm)
        r["decode_ms"] = time_ms(lambda: quant.int8_seghead_decode(
            head, x_q, torch.bfloat16, act_absmax=absmax), flush, cpm, reps=10)
        log(f"  whole decode of the {name}: {r['decode_ms']:.4f} ms")
    return res


def time_deeplab_decode_pieces(model, n=FRAME_DELTA, feat_hw=DL_FEAT_HW) -> dict:
    """Phase 8b: the int8 DeepLabHead's pieces at the main path's shape (one
    decode call of n x 64x64x2048): each int8 conv's im2col and
    torch._int_mm, and the whole decode (weights folded and quantized, the
    pooling branch, the epilogues and the 1x1 classifier included), CUDA
    events, L2 flushed."""
    dev = torch.device("cuda")
    flush, cpm = L2Flush(dev), sleep_cycles_per_ms()
    head = model.classifier.state_dict()
    g = torch.Generator().manual_seed(3)
    convs = [("ASPP 1x1", "0.convs.0", 2048, 0)] + [
        (f"ASPP 3x3 rate {r}", f"0.convs.{i}", 2048, r)
        for i, r in enumerate((12, 24, 36), 1)] + [
        ("projection 1x1", "0.project", 1280, 0), ("head 3x3", "", 256, 1)]
    res = {}
    for name, key, cin, r in convs:
        conv, bn = (f"{key}.0", f"{key}.1") if key else ("1", "2")
        w_q, _, _ = quant._fold_quant(head, conv, bn, 1e-5)
        x_q = random_int8((n,) + tuple(feat_hw) + (cin,), g, dev)
        res[name] = time_int8_conv(name, x_q, w_q, ((r, r), (r, r)),
                                   (r, r) if r else (1, 1), flush, cpm)
        del x_q
    x_q = random_int8((n,) + tuple(feat_hw) + (2048,), g, dev)
    absmax = torch.tensor(4.0, device=dev)
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    decode_ms = time_ms(lambda: quant.int8_deeplab_decode(
        head, x_q, torch.bfloat16, act_absmax=absmax), flush, cpm, reps=5)
    peak_gb = (torch.cuda.max_memory_allocated(dev) - base) / 1e9
    log(f"  whole int8_deeplab_decode of {tuple(x_q.shape)}: {decode_ms:.4f} ms, "
        f"{peak_gb:.2f} GB above its input at peak")
    return res


# ------------------------------------------- from files: phases 3c, 10-12

FRAME_HW = (1072, 1920)  # the reference's frames (core/config.py resize)
CROP = 433               # PSPNet's train size, the CLI's default test crop
DATA_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "data")


def crop_route_grids(device, n=FRAME_DELTA, crop=CROP, frame_hw=FRAME_HW):
    """The grids phase 12 gives the kernels in its first window's first
    crop (offset (0, 0)): mvs_left renormalized to the crop, (n-1, 1, 27,
    27, 2), and the full-frame identity grid (1, 67, 120, 2) of the key-map
    resample. The in-memory clip has the tree's grids (the same motion)."""
    clip = synthetic_clip(n + 1, size=frame_hw, frame_ids=(), seed=0)
    ml = crop_motion_vectors_stack_np(clip["grids"][1:n], *frame_hw, crop, crop, 0, 0)
    return (torch.as_tensor(ml[:, None], device=device).contiguous(),
            torch.as_tensor(default_grid(*frame_hw), device=device)[None].contiguous())


def crop_feature_hw(model, device, crop=CROP):
    """The encoding's size of a crop, from the model itself."""
    with torch.inference_mode():
        f = model.encode(torch.zeros((1, crop, crop, 3), device=device))[0]
    return tuple(f.shape[1:3]), f.shape[3]


def check_crop_kernels(model, dev) -> tuple:
    """Phase 3c: K1 (1, 55, 55, 4096) -> 27x27 on the crop route's own
    first-window grid, K1 -> the 67x120 full-frame identity grid
    (align_corners=True, an up-sample), K2 23 steps on (1, 27, 27, 4096)
    from K1's output; float32 and bf16 against the plain versions (phase 3's
    tolerances), then bf16 timed beside bound and F.grid_sample."""
    feat_hw, c = crop_feature_hw(model, dev)
    log(f"  PSPNet-50 encodes a {CROP} px crop to {feat_hw + (c,)}")
    ml, dg = crop_route_grids(dev)
    geo = _chain_geometry(ml.shape[2] * ml.shape[3], c, 2, 8)
    log(f"  K2 at {ml.shape[2]}x{ml.shape[3]} points, C = {c} bf16: "
        f"{'ping-pong' if geo.table_points else 'single-buffer'} design, "
        f"{geo.c_tile}-channel tile, {geo.table_points} table point(s) a thread, "
        f"{c // geo.c_tile} blocks of {geo.threads} threads, {geo.smem} B shared memory")
    errs = {}
    g = torch.Generator().manual_seed(0)
    xs = torch.randn((1,) + feat_hw + (c,), generator=g)
    for dtype in (torch.float32, torch.bfloat16):
        tag = str(dtype).replace("torch.", "")
        x = xs.to(dev, dtype)
        for grid, align, what in ((ml[0], False, "crop chain head"),
                                  (dg, True, "full-frame identity")):
            note_err(errs, "grid_sample_cuda", dtype, compare(
                f"K1 {tag} x{tuple(x.shape)} {what} grid{tuple(grid.shape)} align={align}",
                grid_sample_cuda(x, grid, align), grid_sample(x, grid, align), dtype))
        y0 = grid_sample(x, ml[0], False)
        note_err(errs, "warp_chain_cuda", dtype, compare(
            f"K2 {tag} y0{tuple(y0.shape)} crop grids T={ml.shape[0] - 1} ({k2_design(y0)})",
            warp_chain_cuda(y0, ml[1:]), warp_chain_plain(y0, ml[1:]), dtype))
    flush, cpm = L2Flush(dev), sleep_cycles_per_ms()
    x = xs.to(dev, torch.bfloat16)
    xn = x.permute(0, 3, 1, 2).contiguous()
    y0 = grid_sample_cuda(x, ml[0], False)
    res = {
        "grid_sample_cuda (crop -> 27x27)": time_k1(x, xn, ml[0], ml[0].to(x.dtype), False,
                                                   flush, cpm),
        "grid_sample_cuda (crop -> 67x120 identity, align_corners=True)": time_k1(
            x, xn, dg, dg.to(x.dtype), True, flush, cpm),
        "warp_chain_cuda (27x27, 23 steps)": time_k2(y0, ml[1:], flush, cpm),
    }
    log_timing(res)
    return errs, res


def psnr(a, b) -> float:
    mse = float(((a.astype(np.float64) - b.astype(np.float64)) ** 2).mean())
    return 10 * np.log10(255.0 ** 2 / max(mse, 1e-12))


def codec_phase(threads=8, frames=32) -> dict:
    """Phase 10: a 1072x1920 synthetic frame through the port's JPEG
    encoder and decoder at q92; ms a frame on one thread (median of 5) and
    on ``threads`` threads (wall time of ``frames`` calls over their count)."""
    frame = synthetic_clip(1, size=FRAME_HW)["frames"][0]
    data = encode_jpeg(frame, 92)
    back = decode_jpeg(data)
    q = psnr(back, frame)
    log(f"  {FRAME_HW[0]}x{FRAME_HW[1]} q92: {len(data) / 1e3:.1f} kB, round trip "
        f"PSNR {q:.2f} dB (must exceed 35)")
    if not q > 35:
        raise AssertionError(f"JPEG round trip PSNR {q:.2f} dB")
    res = {"psnr_db": q, "jpeg_kb": len(data) / 1e3}
    for what, fn in (("decode", lambda: decode_jpeg(data)),
                     ("encode", lambda: encode_jpeg(frame, 92))):
        ts = []
        for _ in range(5):
            t0 = time.perf_counter()
            fn()
            ts.append((time.perf_counter() - t0) * 1e3)
        with ThreadPoolExecutor(threads) as pool:
            t0 = time.perf_counter()
            list(pool.map(lambda _: fn(), range(frames)))
            wall = (time.perf_counter() - t0) * 1e3
        res[f"{what}_ms"] = statistics.median(ts)
        res[f"{what}_ms_{threads}_threads"] = wall / frames
        log(f"  {what}: {res[f'{what}_ms']:.2f} ms a frame on 1 thread, "
            f"{wall / frames:.2f} ms a frame on {threads} threads ({os.cpu_count()} CPUs)")
    return res


def med_ms(fn, args):
    ts = []
    for a in args:
        t0 = time.perf_counter()
        fn(a)
        ts.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(ts)


def files_phase(model, dev, n=FRAME_DELTA, size=SIZE) -> dict:
    """Phase 11: bench.py's protocol from files. A 512 px tree from the
    port's writer ((CLIPS_TIMED + 2) windows), read by FlowDataset (JPEG
    decode, resize to 513, raw float32 pixels), DataLoader (8 threads,
    prefetch 4, device_put), PSPNet-50 bf16 through make_cached_flow_predict_fn.
    frames/s with the batches loaded before the timed loop (bench.py:206),
    then with the loader in the loop (--streaming), and the per-stage host
    breakdown (bench.py:390-435)."""
    root = os.path.join(DATA_DIR, "tree_512")
    t0 = time.perf_counter()
    shutil.rmtree(root, ignore_errors=True)
    generate_synthetic_dataset(root, num_frames=(CLIPS_TIMED + 2) * n + 1, size=(512, 512),
                               frame_delta=n, num_labeled=4)
    log(f"  tree: {(CLIPS_TIMED + 2) * n + 1} frames of 512x512 written in "
        f"{time.perf_counter() - t0:.1f} s")
    ds = FlowDataset("predict", root, type="u", frame_delta=n, predict_v_id="synth",
                     transform=build_test_transform(resize=(size, size), normalize=False))

    def put(b):
        return device_put(b, dev)

    t0 = time.perf_counter()
    batches = list(DataLoader(ds, batch_size=1, num_workers=8, prefetch=4, device_put=put))
    sync(dev)
    log(f"  {len(batches)} windows loaded in {time.perf_counter() - t0:.2f} s: frame_prev "
        f"{tuple(batches[0]['frame_prev'].shape)} {batches[0]['frame_prev'].dtype}, "
        f"mvs_left {tuple(batches[0]['mvs_left'].shape)}")
    full, cached = make_cached_flow_predict_fn(model, n=n, out_size=(size, size),
                                               default_grid=ds.default_grid, device=dev)
    variables = model.state_dict()
    state = {"feat": None, "next_id": None, "windows": 0}

    def run(b, first=False):
        pfid = int(b["prev_frame_id"][0])
        if first or state["feat"] is None or pfid != state["next_id"]:
            out, feat = full(variables, b["frame_prev"], b["frame_next"], b["mvs_left"],
                             b["mvs_right"])
        else:
            out, feat = cached(variables, state["feat"], b["frame_next"], b["mvs_left"],
                               b["mvs_right"])
        state["feat"], state["next_id"] = feat, int(b["next_frame_id"][0])
        state["windows"] += 1
        return out

    reset_launch_counts()
    preloaded = [run(batches[0], first=True), run(batches[1])]
    timed = batches[1:1 + CLIPS_TIMED]
    fps = []
    for _ in range(PASSES):
        sync(dev)
        t0 = time.perf_counter()
        for b in timed:
            out = run(b)
        sync(dev)
        fps.append(len(timed) * n / (time.perf_counter() - t0))
    log(f"  batches loaded before the loop: {statistics.median(fps):.2f} frames/s (median "
        f"of {PASSES} passes x {len(timed)} windows; {[round(f, 2) for f in fps]})")

    streamed = []
    state["feat"] = state["next_id"] = None
    t0 = None
    for i, b in enumerate(DataLoader(ds, batch_size=1, num_workers=8, prefetch=4,
                                     device_put=put)):
        if t0 is None:
            t0 = time.perf_counter()
        out = run(b, first=(i == 0))
        if i < 2:
            streamed.append(out.clone())
    sync(dev)
    streaming_fps = (len(batches) - 1) * n / (time.perf_counter() - t0)
    log(f"  loader in the loop (--streaming): {streaming_fps:.2f} frames/s over "
        f"{len(batches) - 1} windows after the first arrived")
    counts = launch_counts()
    windows = state["windows"]
    expected = {"grid_sample_cuda": 3 * windows, "grid_sample_backward_cuda": 0,
                "warp_chain_cuda": 2 * windows, "resize_quantize_int8_cuda": 0}
    log(f"  launches over {windows} windows: {counts}")
    if counts != expected:
        raise AssertionError(f"the cached route from files launched {counts}, "
                             f"expected {expected}")
    for i in range(2):
        same = torch.equal(streamed[i], preloaded[i])
        log(f"  window {i}: maps from the streaming loader "
            f"{'equal' if same else 'DIFFER FROM'} the preloaded batches' "
            f"{tuple(preloaded[i].shape)}")
        if not same:
            raise AssertionError("maps differ between the streamed and preloaded batches")
    if out.shape != (n, size, size) or int(out.min()) < 0 or int(out.max()) >= CLASSES:
        raise AssertionError(f"maps {tuple(out.shape)} out of range")

    idxs = list(range(min(6, len(ds))))
    bd = {"item_load_ms": med_ms(lambda i: ds.get(i, np.random.default_rng((0, 0, i))), idxs),
          "jpg_decode_ms": med_ms(lambda i: (imread(ds.frame_path("synth", i * n)),
                                             imread(ds.frame_path("synth", (i + 1) * n))),
                                  idxs),
          "grid_npy_ms": med_ms(lambda i: [ds._load_grid("synth", i * n + k + 1, name)
                                           for k in range(n - 1)
                                           for name in ("grids", "inv_grids")], idxs)}
    bd["transform_ms"] = max(0.0, bd["item_load_ms"] - bd["jpg_decode_ms"] - bd["grid_npy_ms"])
    items = [ds.get(i, np.random.default_rng((0, 0, i))) for i in idxs]
    bd["collate_ms"] = med_ms(lambda i: collate([items[i]]), idxs)
    host = [collate([it]) for it in items]

    def put_sync(i):
        put(host[i])
        sync(dev)

    bd["device_put_ms"] = med_ms(put_sync, idxs)
    bd["device_compute_ms_per_window"] = 1000 * n / statistics.median(fps)
    log(f"  host breakdown, ms a window (medians of {len(idxs)}): "
        f"{ {k: round(v, 3) for k, v in bd.items()} }")
    return {"fps": statistics.median(fps), "fps_passes": fps, "streaming_fps": streaming_fps,
            "breakdown": bd, "launches": counts, "windows": windows}


def union_us(spans) -> float:
    """The length of the union of (start, end) intervals."""
    total, cur = 0.0, None
    for s0, e0 in sorted(spans):
        if cur is None or s0 > cur[1]:
            total += 0.0 if cur is None else cur[1] - cur[0]
            cur = [s0, e0]
        else:
            cur[1] = max(cur[1], e0)
    return total + (0.0 if cur is None else cur[1] - cur[0])


def device_time(trace_path, windows) -> dict:
    """Device busy ms (the union of kernel intervals) and device-to-host
    copy ms a window from a chrome trace."""
    with open(trace_path) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    kernels = [(e["ts"], e["ts"] + e["dur"]) for e in events if e.get("cat") == "kernel"]
    busy = union_us(kernels)
    d2h = sum(e["dur"] for e in events if e.get("cat") == "gpu_memcpy"
              and "DtoH" in e.get("name", ""))
    return {"busy_ms": busy / 1e3 / windows, "d2h_ms": d2h / 1e3 / windows,
            "kernels": len(kernels) / windows}


def crop_route_phase(model, dev, n=FRAME_DELTA) -> dict:
    """Phase 12: the CLI's default predict route at full width through
    run_flow_predict: a 1072x1920 tree of 2n + 1 frames from the port's
    writer (2 windows), 433x433 crops (28 a window), n = 25, PSPNet-50
    bf16, metrics, palette PNGs and the AVI. torch.profiler (CUDA activity)
    over the run gives device busy and the device-to-host copies."""
    from torch.profiler import ProfilerActivity, profile as tprofile
    root = os.path.join(DATA_DIR, "tree_1072")
    out_dir = os.path.join(DATA_DIR, "predict_1072")
    for d in (root, out_dir):
        shutil.rmtree(d, ignore_errors=True)
    t0 = time.perf_counter()
    generate_synthetic_dataset(root, num_frames=2 * n + 1, size=FRAME_HW, frame_delta=n,
                               num_labeled=2)
    log(f"  tree: {2 * n + 1} frames of {FRAME_HW[0]}x{FRAME_HW[1]} written in "
        f"{time.perf_counter() - t0:.1f} s; {len(crop_offsets(*FRAME_HW, CROP, CROP))} "
        f"crops of {CROP} px a window")
    crops = len(crop_offsets(*FRAME_HW, CROP, CROP))
    prof = PhaseProfiler(sync=cuda_sync)
    video = os.path.join(out_dir, "synth.avi")
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    reset_launch_counts()
    t0 = time.perf_counter()
    os.makedirs(PROFILE_DIR, exist_ok=True)
    activity = ProfilerActivity.CUDA if dev.type == "cuda" else ProfilerActivity.CPU
    with tprofile(activities=[activity]) as tp:
        summary = run_flow_predict(model, model.state_dict(), root, "synth", frame_delta=n,
                                   resize=FRAME_HW, crop=(CROP, CROP), no_cropping=False,
                                   save_images_dir=os.path.join(out_dir, "frames"),
                                   video_path=video, profiler=prof, device=dev)
    total = time.perf_counter() - t0
    counts = launch_counts()
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9 if dev.type == "cuda" else 0.0
    windows = summary["frames"] // n
    trace = os.path.join(PROFILE_DIR, "pspnet_bf16_crop_route_trace.json")
    tp.export_chrome_trace(trace)
    dt = device_time(trace, windows)
    log(f"  summary: { {k: (round(v, 4) if isinstance(v, float) else v) for k, v in summary.items() if k != 'predict_miou1_epoch_classes'} }")
    # per crop: K1 for both chain heads and the key resample, K2 for both chains
    expected = {"grid_sample_cuda": 3 * crops * windows, "grid_sample_backward_cuda": 0,
                "warp_chain_cuda": 2 * crops * windows, "resize_quantize_int8_cuda": 0}
    log(f"  launches over {windows} windows: {counts} (expected {expected})")
    if windows != 2 or counts != expected:
        raise AssertionError(f"the crop route launched {counts} over {windows} windows")
    pngs = sorted(os.listdir(os.path.join(out_dir, "frames")))
    frames = read_mjpg_avi(video)
    log(f"  {len(pngs)} PNGs; the AVI ({os.path.getsize(video) / 1e6:.1f} MB) reads back "
        f"as {len(frames)} frames of {frames[0].shape if frames else None}")
    if len(pngs) != 2 * n or len(frames) != 2 * n or frames[0].shape != FRAME_HW + (3,):
        raise AssertionError(f"the crop route's PNGs or AVI are not {2 * n} frames")
    m = imread(os.path.join(out_dir, "frames", "0.png"))
    if m.shape != FRAME_HW or int(m.max()) >= CLASSES:
        raise AssertionError(f"PNG map {m.shape} with classes up to {int(m.max())}")
    per = {k: prof.mean(k) for k in ("predict_interference", "crop_forward",
                                      "crop_probs_to_host", "crop_canvas")}
    log(f"  seconds a window: {per['predict_interference']:.3f} (crops through the "
        f"device {per['crop_forward']:.3f}, probabilities to the host "
        f"{per['crop_probs_to_host']:.3f}, float64 canvas {per['crop_canvas']:.3f}); "
        f"whole run with PNGs and AVI {total:.1f} s")
    log(f"  device: busy {dt['busy_ms']:.1f} ms a window, {dt['kernels']:.0f} kernels, "
        f"device-to-host copies {dt['d2h_ms']:.1f} ms (torch.profiler); peak memory "
        f"{peak_gb:.2f} GB")
    return {"summary": summary, "launches": counts, "windows": windows, "peak_gb": peak_gb,
            "seconds": per, "total_s": total, **dt}


def crop_card_vs_cpu(n=5, frame_hw=(128, 192), crop=64, seed=1) -> None:
    """Phase 12b: the crop route in float32 on the card against the CPU at
    a small size (128x192 frames, 64 px crops, n = 5): probabilities within
    1e-4, maps equal away from near-ties (twice that)."""
    root = os.path.join(DATA_DIR, "tree_small")
    shutil.rmtree(root, ignore_errors=True)
    generate_synthetic_dataset(root, num_frames=n + 1, size=frame_hw, frame_delta=n,
                               num_labeled=1)
    ds = FlowDataset("predict", root, type="u", frame_delta=n, predict_v_id="synth",
                     transform=build_test_transform(resize=frame_hw, normalize=False))
    batch = collate([ds.get(0, np.random.default_rng(0))])
    cpu_model = random_model("pspnet", torch.float32, seed)
    gpu_model = copy.deepcopy(cpu_model)
    res = {}
    for dev, m in ((torch.device("cpu"), cpu_model), (torch.device("cuda"), gpu_model)):
        fn = make_flow_predict_crop_fn(m, n, CLASSES, default_grid=ds.default_grid, device=dev)
        seen = {}

        def recording(*args):
            seen["probs"] = fn(*args)
            return seen["probs"]

        maps = flow_sliding_window_predict(recording, m.state_dict(), batch, CLASSES, crop,
                                           crop, frame_hw)
        res[dev.type] = (seen["probs"].cpu().numpy(), maps.cpu().numpy())
    (pc, mc), (pg, mg) = res["cpu"], res["cuda"]
    err = float(np.abs(pg - pc).max())
    log(f"  probabilities {pc.shape}: max_abs_err {err:.3e} (tol 1e-4)")
    if not err <= 1e-4:
        raise AssertionError(f"crop probabilities differ between card and CPU: {err}")
    offs = crop_offsets(*frame_hw, crop, crop)
    canvas = np.zeros((n,) + frame_hw + (CLASSES,))
    count = np.zeros(frame_hw + (1,))
    for (h, w), p in zip(offs, pc):
        canvas[:, h:h + crop, w:w + crop] += p
        count[h:h + crop, w:w + crop] += 1
    top2 = np.sort(canvas / count, axis=-1)[..., -2:]
    clear = (top2[..., 1] - top2[..., 0]) > 2e-4
    same = mg == mc
    log(f"  maps {mc.shape}: {same.mean():.6f} equal, {int((~same & clear).sum())} differ "
        f"away from near-ties ({clear.mean():.4f} of pixels clear)")
    if (~same & clear).any():
        raise AssertionError("card and CPU crop-route maps differ away from near-ties")


# ------------------------------------------- training: 3t, 4t and 14-17

# phase 4t's hold on what a step changed: per tensor, the card's change
# against the CPU's within STEP_FLOOR_FACTOR times the CPU float32 change's
# own distance to the float64 change (its noise floor), and never held
# tighter than STEP_ABS; both relative to the tensor's largest change. The
# card's float32 change sat up to 11.2 times farther from the float64 one
# than the CPU's (layer4.2.conv1.weight, an H100 80GB HBM3): rounding that
# BN's backward amplifies differs by tensor, so the factor is about three
# times that
STEP_FLOOR_FACTOR = 32.0
STEP_ABS = 1e-3
# each architecture's warps in a training step of the repository's flow
# config (batch 2, the 433 px crop through round_train): the encoding's
# channels and size, the crop's block grid, the crop
TRAIN_SHAPES = {"pspnet": (4096, (55, 55), (27, 27), 433),
                "deeplabv3": (2048, (55, 55), (27, 27), 433),
                "vit": (768, (13, 13), (26, 26), 416)}
# a training step's device time by family of kernel names (the first family
# whose pattern a name contains takes it; cuBLAS's "xmma_gemm" products before
# cuDNN's "xmma_fprop_implicit_gemm" convolutions)
TRAIN_FAMILIES = (
    ("K1", ("grid_sample_kernel",)),
    ("K1-bwd", ("grid_sample_backward_",)),
    ("conv backward", ("dgrad", "wgrad", "bprop", "backward_data", "backward_filter")),
    ("conv forward", ("fprop", "conv", "cudnn", "implicit")),
    ("matrix products", ("gemm", "nvjet", "cutlass")),
    ("OHEM sort", ("sort", "Sort", "radix", "Radix")),
    ("optimizer", ("multi_tensor_apply",)),
    ("softmax", ("softmax", "Softmax")),
    ("reductions (BN and LayerNorm statistics)", ("reduce_kernel",)),
    ("copies and casts", ("copy", "CatArray")),
    ("other elementwise (BN, ReLU, dropout, blend, losses)", ("",)),
)


def train_crop_grids(seed=0, n=FRAME_DELTA, frame_hw=FRAME_HW, crop=CROP) -> torch.Tensor:
    """The training batch's own grids: two samples' left chains of a
    synthetic 1072x1920 clip through the flow train transform (random
    scale, flip and the ``crop`` px crop, as FlowDataset items take it),
    (n-1, 2, crop // 16, crop // 16, 2) float32 on the CPU."""
    clip = synthetic_clip(2 * n + 1, size=frame_hw, frame_ids=(), seed=seed)
    tf = build_train_transform(crop, crop, resize=frame_hw, with_rotate=False,
                               crop_padding=None, normalize=False)
    chains = []
    for b in range(2):
        sample = {"label": np.zeros(frame_hw, np.uint8),
                  "mvs_left": list(clip["grids"][1 + b * n:(b + 1) * n])}
        chains.append(np.stack(tf(sample, np.random.default_rng((seed, b)))["mvs_left"]))
    return torch.as_tensor(np.stack(chains, axis=1)).contiguous()


def train_grids(dev, seed=0, crop=CROP) -> dict:
    """Phase 3t's grids (2, gh, gw, 2) for a ``crop`` px crop: random in
    [-1.1, 1.1], the training batch's first and second crop grids (a chain's
    head and a chain step), the identity (block centres of the crop,
    align_corners=False) and one that clamps every point to the top-left
    corner (all of a point's taps, and so all atomics, on one source
    pixel)."""
    g = torch.Generator().manual_seed(seed)
    chain = train_crop_grids(seed, crop=crop)
    hw = (crop // 16, crop // 16)
    ident = torch.as_tensor(default_grid(hw[0] * 16, hw[1] * 16))[None].expand(2, -1, -1, -1)
    grids = {"random": torch.rand((2,) + hw + (2,), generator=g) * 2.2 - 1.1,
             "train-crop": chain[0], "train-crop step": chain[1], "identity": ident,
             "corner": torch.full((2,) + hw + (2,), -1.5)}
    return {k: v.to(dev).contiguous() for k, v in grids.items()}


def check_k1_bwd(name, go, grid, x_shape) -> float:
    """K1-bwd bit-equal, by integer view, to its plain version computed on
    the CPU from the same inputs (the CPU's index_add_ adds in the order the
    kernel keeps; on the card it is atomic), and two launches on one input
    bit-equal. Returns the max abs error, 0."""
    got = grid_sample_backward_cuda(go, grid, x_shape, False)
    again = grid_sample_backward_cuda(go, grid, x_shape, False)
    ref = grid_sample_backward(go.cpu(), grid.cpu(), x_shape, False)
    bits = torch.int32 if go.dtype == torch.float32 else torch.int16
    got, again = got.cpu(), again.cpu()
    differ = int((got.view(bits) != ref.view(bits)).sum())
    rerun = int((again.view(bits) != got.view(bits)).sum())
    err = float((got.float() - ref.float()).abs().max())
    ok = differ == 0 and rerun == 0
    log(f"  {name}: {differ} elements differ from the CPU's plain version, {rerun} between "
        f"two runs, max_abs_err {err:.3e} -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name} is not bit-equal to its plain version on the CPU "
                             f"({differ} elements) or to itself ({rerun})")
    return err


def kernel_split_us(fn, flush, pattern, reps=10) -> dict:
    """Device us a call of fn() by kernel, for the kernels whose names
    contain ``pattern`` (torch.profiler over ``reps`` calls, the L2 flushed
    before each): where a launch sequence spends its time."""
    from torch.profiler import ProfilerActivity, profile as tprofile
    fn()
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            flush()
            fn()
        torch.cuda.synchronize()
    split = {}
    for e in prof.key_averages():
        if pattern in e.key:
            name = re.sub(r"^(void )?(\(anonymous namespace\)::)?", "", e.key).split("(")[0]
            split[name] = split.get(name, 0.0) + e.device_time_total / reps
    return split


def time_k1_bwd(g_out, grid, x_shape, flush, cpm) -> dict:
    """K1-bwd's time beside its bound (grad_out and the grid read once,
    grad_x written once; 4 multiplies and 4 adds per element of grad_out),
    its plain version's and the library's: aten.grid_sampler_2d_backward on
    NCHW, the input's gradient only."""
    out = grid_sample_backward_cuda(g_out, grid, x_shape, False)
    b = bound(nbytes(g_out, grid, out), 8 * g_out.numel())
    gn = g_out.permute(0, 3, 1, 2).contiguous()
    xn = torch.zeros((x_shape[0], x_shape[3], x_shape[1], x_shape[2]), dtype=g_out.dtype,
                     device=g_out.device)
    grid_l = grid.to(g_out.dtype)
    return {
        "ms": time_ms(lambda: grid_sample_backward_cuda(g_out, grid, x_shape, False), flush, cpm),
        "plain_ms": time_ms(lambda: grid_sample_backward(g_out, grid, x_shape, False), flush,
                            cpm, reps=5),
        "library_ms": time_ms(lambda: torch.ops.aten.grid_sampler_2d_backward(
            gn, xn, grid_l, 0, 1, False, [True, False]), flush, cpm),
        "bound_ms": b[0], "bound_by": b[1],
        "split_us": kernel_split_us(lambda: grid_sample_backward_cuda(g_out, grid, x_shape,
                                                                      False),
                                    flush, "grid_sample_backward_"),
    }


def check_train_kernels(dev, arch="pspnet", dtypes=(torch.float32, torch.bfloat16)) -> tuple:
    """Phase 3t for one architecture's training shapes (TRAIN_SHAPES): K1
    and K1-bwd at (2, head, C) -> grid (a chain's head; for the ViT an
    up-sample of the token map) and (2, grid, C) -> grid (its steps), in
    ``dtypes``, on phase 3t's grids for its crop: K1 bit-equal to its plain
    version in float32, K1-bwd bit-equal to its plain version on the CPU
    and to itself from run to run (check_k1_bwd). Then both timed in
    float32 (the training dtype) on the training batch's grids, and K1-bwd
    in bf16 where bf16 is checked. Timing keys carry the architecture but
    PSPNet's."""
    c, head_hw, grid_hw, crop = TRAIN_SHAPES[arch]
    grids = train_grids(dev, crop=crop)
    g = torch.Generator().manual_seed(1)
    xs = {hw: torch.randn((2,) + hw + (c,), generator=g) for hw in (head_hw, grid_hw)}
    g_out = torch.randn((2,) + grid_hw + (c,), generator=g)
    errs = {}
    for dtype in dtypes:
        tag = str(dtype).replace("torch.", "")
        go = g_out.to(dev, dtype)
        for hw, x0 in xs.items():
            x = x0.to(dev, dtype)
            for what, grid in grids.items():
                out, ref = grid_sample_cuda(x, grid, False), grid_sample(x, grid, False)
                if dtype == torch.float32 and not torch.equal(out, ref):
                    raise AssertionError(f"K1 float32 B=2 {arch} {what} is not bit-equal to "
                                         f"its plain version")
                note_err(errs, "grid_sample_cuda", dtype, compare(
                    f"K1 {tag} x{tuple(x.shape)} {what}", out, ref, dtype))
                note_err(errs, "grid_sample_backward_cuda", dtype, check_k1_bwd(
                    f"K1-bwd {tag} grad_x{tuple(x.shape)} {what}", go, grid, tuple(x.shape)))
    flush, cpm = L2Flush(dev), sleep_cycles_per_ms()
    res = {}
    go = g_out.to(dev)
    label = "" if arch == "pspnet" else f"{arch} "
    for hw, part, grid in ((head_hw, "head", grids["train-crop"]),
                           (grid_hw, "step", grids["train-crop step"])):
        x = xs[hw].to(dev)
        shape = tuple(x.shape)
        res[f"grid_sample_cuda ({label}train {part}, float32)"] = time_k1(
            x, x.permute(0, 3, 1, 2).contiguous(), grid, grid, False, flush, cpm)
        res[f"grid_sample_backward_cuda ({label}train {part}, float32)"] = time_k1_bwd(
            go, grid, shape, flush, cpm)
    if torch.bfloat16 in dtypes:
        res[f"grid_sample_backward_cuda ({label}train head, bf16)"] = time_k1_bwd(
            go.to(torch.bfloat16), grids["train-crop"], (2,) + head_hw + (c,), flush, cpm)
    log_timing(res, "library")
    return errs, res


# the reference's full-frame block grid, whose K1-bwd index build does not fit
# one block's shared memory
WIDE_GRID = (67, 120)


def check_k1_bwd_workspace(dev, c=256, seed=2) -> tuple:
    """Phase 3t's K1-bwd where its index build keeps its working arrays in
    a device workspace: a (1, 67, 120) grid onto (1, 134, 240, c), on
    random grids, the block centres (the identity, align_corners=False) and
    the corner grid (all 32160 entries on one pixel), float32 and bf16, each
    bit-equal to its plain version on the CPU and from run to run; then
    timed in float32 on the random grid. Returns (errors, timing)."""
    gh, gw = WIDE_GRID
    x_shape = (1, 2 * gh, 2 * gw, c)
    if not warp_library().floodseg_grid_sample_backward_workspace(1, x_shape[1], x_shape[2],
                                                                  gh, gw):
        raise AssertionError(f"K1-bwd at {x_shape} would build its index in shared memory")
    g = torch.Generator().manual_seed(seed)
    go = torch.randn((1, gh, gw, c), generator=g)
    grids = {"random": torch.rand((1, gh, gw, 2), generator=g) * 2.2 - 1.1,
             "identity": torch.as_tensor(default_grid(gh * 16, gw * 16))[None],
             "corner": torch.full((1, gh, gw, 2), -1.5)}
    grids = {k: v.to(dev).contiguous() for k, v in grids.items()}
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        tag = str(dtype).replace("torch.", "")
        for what, grid in grids.items():
            note_err(errs, "grid_sample_backward_cuda", dtype, check_k1_bwd(
                f"K1-bwd {tag} grad_x{x_shape} {what} (workspace route)", go.to(dev, dtype),
                grid, x_shape))
    res = {"grid_sample_backward_cuda (workspace route, float32)": time_k1_bwd(
        go.to(dev), grids["random"], x_shape, L2Flush(dev), sleep_cycles_per_ms())}
    log_timing(res, "library")
    return errs, res


def check_k1_bwd_unaligned(dev, seed=4) -> tuple:
    """Phase 3t's K1-bwd on grad_out that is a contiguous view at an odd
    element offset, C = 5 (the one-element route, as the backward of a
    stack or an unbind may hand it over): the PSPNet head shape's grids and
    the workspace route's, float32 and bf16, bit-equal to the plain version
    on the CPU and from run to run. Returns (errors, {})."""
    g = torch.Generator().manual_seed(seed)
    errs = {}
    for grid_hw, x_hw in (((27, 27), (55, 55)), (WIDE_GRID, (134, 240))):
        b = 2 if grid_hw != WIDE_GRID else 1
        x_shape = (b,) + x_hw + (5,)
        grid = (torch.rand((b,) + grid_hw + (2,), generator=g) * 2.2 - 1.1).to(dev)
        for dtype in (torch.float32, torch.bfloat16):
            flat = torch.randn(1 + b * grid_hw[0] * grid_hw[1] * 5, generator=g)
            go = flat.to(dev, dtype)[1:].view((b,) + grid_hw + (5,))
            assert go.is_contiguous() and go.data_ptr() % 16 != 0
            tag = str(dtype).replace("torch.", "")
            note_err(errs, "grid_sample_backward_cuda", dtype, check_k1_bwd(
                f"K1-bwd {tag} grad_x{x_shape} random, grad_out at an odd offset", go, grid,
                x_shape))
    return errs, {}


def train_batch(seed=3, size=65, n=5, device="cpu") -> dict:
    """A flow training batch of two samples: normalised-range frames
    (size px), chains of n - 1 grids (size // 16 blocks, float32, the
    second sample's left chain 3 long), labels with 5% ignored."""
    rng = np.random.default_rng(seed)
    gh = size // 16
    base = np.stack(np.meshgrid(np.linspace(-0.9, 0.9, gh), np.linspace(-0.9, 0.9, gh)), -1)

    def chain():
        return torch.as_tensor((base[None, None] + rng.uniform(
            -0.1, 0.1, (n - 1, 2, gh, gh, 2))).astype(np.float32), device=device).contiguous()

    labels = rng.integers(0, CLASSES, (2, size, size))
    labels = np.where(rng.random(labels.shape) < 0.05, 255, labels).astype(np.int32)
    frames = {k: torch.as_tensor(rng.standard_normal((2, size, size, 3)).astype(np.float32),
                                 device=device)
              for k in ("frame_prev", "frame_next", "frame_current")}
    return {**frames, "mvs_left": chain(), "mvs_right": chain(),
            "left_index": np.array([1, 3], np.int32),
            "right_index": np.array([n - 1, n - 3], np.int32),
            "label": torch.as_tensor(labels, device=device)}


def fixed_keep_masks(model, store: dict, seed=5) -> list:
    """Every Dropout of ``model`` takes one keep mask per module name, drawn
    on the CPU (from ``seed`` and the name) at its first call and kept in
    ``store``: runs on the card and on the CPU that share ``store`` drop
    the same elements. Returns the hooks' handles."""
    handles = []
    for name, mod in model.named_modules():
        if not isinstance(mod, Dropout):
            continue

        def hook(mod, args, name=name):
            x = args[0]
            if name not in store:
                g = torch.Generator().manual_seed(seed + zlib.crc32(name.encode()))
                shape = [1 if d in mod.broadcast_dims else s for d, s in enumerate(x.shape)]
                store[name] = torch.rand(shape, generator=g) < 1.0 - mod.rate
            mod.keep = store[name].to(x.device)
        handles.append(mod.register_forward_pre_hook(hook))
    return handles


def train_steps(model, batch, masks, dev, dtype=torch.float32,
                steps=("interp", "plain", "eval")) -> dict:
    """``steps`` of ``model`` on ``dev`` in ``dtype``, each from ``model``'s
    own state (the flow config's SGD: lr 1e-4, the heads at 10x; OHEM with
    its min_kept, which skips mining at this size): interpolated, plain,
    "supervised" (single frame, the aux loss at 0.4) and "eval" (the flow
    eval step); every dropout takes the masks of ``masks`` (a store shared
    with the other runs, fixed_keep_masks). Returns each train step's loss
    and the state_dict after it (float64 on the CPU), and the eval counts."""
    batch = {k: (v.to(dev, dtype) if torch.is_tensor(v) and k.startswith("frame")
                 else v.to(dev) if torch.is_tensor(v) else v) for k, v in batch.items()}

    def fresh():
        m = copy.deepcopy(model).to(dev, dtype)
        for mod in m.modules():
            if hasattr(mod, "compute_dtype"):
                mod.compute_dtype = dtype
        if dev.type == "cuda":
            m.to(memory_format=torch.channels_last)
        fixed_keep_masks(m, masks)
        return m

    out = {}
    for name in steps:
        m = fresh()
        if name == "eval":
            ev = make_flow_eval_step(m, CLASSES, 255)(None, batch)
            out["eval"] = {k: v.cpu() for k, v in ev.items()}
            continue
        opt, sched = make_optimizer(m, FitConfig.lr, 10)
        if name == "supervised":
            step = make_train_step(m, make_loss_fn("ohem", 0.4, 255, 0.7, 100000), CLASSES, 255)
        else:
            interp, plain = make_flow_train_step(m, make_loss_fn("ohem", 0.0, 255, 0.7, 100000),
                                                 CLASSES, 255)
            step = interp if name == "interp" else plain
        _, metrics = step(TrainState(0, m, opt, sched), batch, None)
        out[name] = (float(metrics["loss"]), {k: v.detach().double().cpu().clone()
                                              for k, v in m.state_dict().items()})
    return out


def step_rel(a: dict, b: dict, p0: dict) -> dict:
    """Per tensor that ``b``'s step moved: max|a - b| / max|b - p0|, how far
    ``a``'s change (a - p0) is from ``b``'s relative to the largest
    change."""
    out = {}
    for k, ref in b.items():
        scale = float((ref - p0[k]).abs().max()) if ref.numel() else 0.0
        if scale > 0.0:
            out[k] = float((a[k] - ref).abs().max()) / scale
    return out


# phase 4t's models: (name, arch, frame size, train steps)
STEP_CHECKS = (("PSPNet-50", "pspnet", 65, ("interp", "plain", "supervised", "eval")),
               ("DeepLabV3-50", "deeplabv3", 65, ("interp", "plain", "eval")),
               ("ViT-B/32", "vit", 128, ("interp", "plain", "eval")))


def check_train_step_card_vs_cpu(arch="pspnet", size=65, n=5,
                                 steps=("interp", "plain", "eval")) -> None:
    """Phase 4t for one model: its ``steps`` (PSPNet-50 and DeepLabV3-50
    with their aux heads at 65 px; ViT-B/32 at 128 px, 4x4 tokens on 8x8
    grids, so each chain's head up-samples), batch 2, frame_delta 5,
    float32 with TF32 off (the steps run under full_precision_f32), on the
    card against the CPU, each step from the same initial state with the
    same dropout keep masks (the config's SGD, lr 1e-4): losses within rtol
    1e-4; every parameter and BN statistic within 1e-4 of its tensor's
    largest magnitude; the same tensors moved; and what the step changed
    (p1 - p0, the gradient through the warps' K1-bwd, the momentum and the
    weight decay, or the BN statistics' update) within the tensor's float32
    noise floor (STEP_FLOOR_FACTOR, STEP_ABS) of the CPU's change; eval
    counts within 1% of the pixels. The same steps in float64 on the CPU
    give that floor."""
    model = random_model(arch, torch.float32, seed=4, image_size=size, with_aux=True)
    p0 = {k: v.detach().double().clone() for k, v in model.state_dict().items()}
    masks = {}
    t0 = time.perf_counter()
    card = train_steps(model, train_batch(size=size, n=n), masks, torch.device("cuda"),
                       steps=steps)
    t_card = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu = train_steps(model, train_batch(size=size, n=n), masks, torch.device("cpu"),
                      steps=steps)
    f64 = train_steps(model, train_batch(size=size, n=n), masks, torch.device("cpu"),
                      torch.float64, steps=steps)
    kept = torch.cat([m.reshape(-1).float() for m in masks.values()])
    log(f"  card {t_card:.1f} s, CPU {time.perf_counter() - t0:.1f} s (float32 and float64) "
        f"for the {len(steps)} steps; {len(masks)} dropout masks, keeping "
        f"{float(kept.mean()):.3f} of {kept.numel()} elements")

    def rel_diffs(a, b):
        out = {}
        for k, ref in b.items():
            scale = float(ref.abs().max()) if ref.numel() else 0.0
            if scale > 0.0:
                out[k] = float((a[k] - ref).abs().max()) / scale
        return out

    for name in (s for s in steps if s != "eval"):
        (lc, sc), (lh, sh), (l64, s64) = card[name], cpu[name], f64[name]
        d = rel_diffs(sc, sh)
        key = max(d, key=d.get)
        ok = abs(lc - lh) <= 1e-4 * abs(lh) and d[key] <= 1e-4
        log(f"  {name} step: loss card {lc:.7f} CPU {lh:.7f} float64 {l64:.7f} (card vs "
            f"CPU rel {abs(lc - lh) / abs(lh):.2e}, tol 1e-4); largest parameter or BN "
            f"statistic difference {d[key]:.2e} of its tensor's largest magnitude ({key}; "
            f"tol 1e-4) -> {'ok' if ok else 'FAIL'}")
        # what the step changed: card vs CPU, against the CPU float32 floor
        moved = {k for k in sh if not torch.equal(sh[k], p0[k])}
        moved_card = {k for k in sc if not torch.equal(sc[k], p0[k])}
        e, floor = step_rel(sc, sh, p0), step_rel(sh, s64, p0)
        card_floor = step_rel(sc, s64, p0)
        limit = {k: max(STEP_ABS, STEP_FLOOR_FACTOR * floor.get(k, 0.0)) for k in e}
        worst = sorted(e, key=lambda k: e[k] / limit[k], reverse=True)[:5]
        step_ok = moved == moved_card and all(e[k] <= limit[k] for k in e)
        log(f"    the step's change, {len(e)} tensors moved ({len(moved_card)} on the card): "
            f"card vs CPU median {statistics.median(e.values()):.2e} of the tensor's largest "
            f"change; the float32 floor (CPU vs float64) median "
            f"{statistics.median(floor.values()):.2e}, card vs float64 median "
            f"{statistics.median(card_floor.values()):.2e}; card over CPU distance to float64 "
            f"at most {max(card_floor[k] / max(floor[k], 1e-30) for k in floor):.2f}x -> "
            f"{'ok' if step_ok else 'FAIL'}")
        log("    closest to the limit, card vs CPU | limit | CPU vs float64 | card vs float64: "
            + "; ".join(f"{k} {e[k]:.2e} | {limit[k]:.2e} | {floor.get(k, 0.0):.2e} | "
                        f"{card_floor.get(k, 0.0):.2e}" for k in worst))
        if not (ok and step_ok):
            raise AssertionError(f"the {arch} {name} train step on the card disagrees with "
                                 f"the CPU")
    pixels = float(cpu["eval"]["target"].sum())
    diff = {k: float((card["eval"][k] - cpu["eval"][k]).abs().sum()) for k in cpu["eval"]}
    log(f"  eval counts card vs CPU: summed differences {diff} of {pixels:.0f} pixels")
    if diff["target"] != 0 or max(diff.values()) > 0.01 * pixels:
        raise AssertionError(f"eval counts card vs CPU differ: {diff}")


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def train_tree(n=FRAME_DELTA, frame_hw=FRAME_HW, frames=100, labeled=40) -> str:
    """The training phases' tree: ``frames`` frames of 1072x1920 from the
    port's writer under build/data/train_tree, ``labeled`` of them with
    labels (28 train items, 6 val)."""
    root = os.path.join(DATA_DIR, "train_tree")
    shutil.rmtree(root, ignore_errors=True)
    t0 = time.perf_counter()
    generate_synthetic_dataset(root, num_frames=frames, size=frame_hw, frame_delta=n,
                               num_labeled=labeled)
    log(f"  tree: {frames} frames of {frame_hw[0]}x{frame_hw[1]} written in "
        f"{time.perf_counter() - t0:.1f} s")
    return root


# phases 14-17: (phase, tag, arch, trunk depth, method, crop, steps, warm-up,
# validation frames); the crop goes through round_train
TRAIN_PHASES = (
    ("14", "pspnet_f32_train", "pspnet", 50, "flow_supervised", CROP, 14, 2, 3),
    ("15", "deeplabv3_f32_train", "deeplabv3", 101, "flow_supervised", CROP, 8, 2, 2),
    ("16", "vit_f32_train", "vit", 0, "flow_supervised", CROP, 8, 2, 2),
    ("17", "pspnet_f32_supervised", "pspnet", 50, "supervised", 873, 8, 2, 2),
)


def train_phase(dev, root, tag, arch="pspnet", layers=50, method="flow_supervised",
                crop=CROP, steps=14, warmup=2, val_batches=3, profiled=2,
                n=FRAME_DELTA, frame_hw=FRAME_HW) -> dict:
    """Phases 14-17: training at full width through run_flow_fit
    (``flow_supervised``) or run_fit (``supervised``) on the tree at
    ``root``: the repository's configuration for the method (float32,
    batch 2, the crop through round_train, n = 25, SGD with the heads at
    10x, OHEM 0.7 / 100000; the single-frame method's rotating transform
    with MEAN padding and the aux loss at 0.4), ``steps`` steps
    (``warmup`` untimed, the last ``profiled`` under torch.profiler) and a
    validation pass over ``val_batches`` frames. The loader alone first.
    Checks: a finite loss; K1 48 and K1-bwd 48 launches every flow step
    (and K1 48 a validation frame), K2 and K3 none, and no launch at all in
    the single-frame method; every BN's running mean moved but, in flow
    training (which never runs it), the aux head's; after the first flow
    step each aux parameter equals p0 - 10 lr wd p0. (Smaller arguments
    rehearse it on the CPU.)"""
    from torch.profiler import ProfilerActivity, profile as tprofile
    flow = method == "flow_supervised"
    model = random_model(arch, torch.float32, seed=7, image_size=round_train(crop, arch),
                         with_aux=True, layers=layers)
    cfg = FitConfig(train_h=crop, train_w=crop, resize_h=frame_hw[0], resize_w=frame_hw[1],
                    frame_delta=n, max_epochs=1, limit_train_batches=steps,
                    limit_val_batches=val_batches)
    size = round_train(crop, arch)
    log(f"  {arch} ({sum(p.numel() for p in model.parameters()) / 1e6:.1f} M parameters), "
        f"{method}, {size} px crops; TF32 off (the steps run under full_precision_f32); {cfg}")
    # the loader alone: host ms a batch (8 threads), before any training
    lst = os.path.join(root, "list", "all", "train.txt")
    if flow:
        ds = FlowDataset("train", root, lst, transform=flow_transforms(cfg, arch)["train"],
                         frame_delta=n)
    else:
        ds = SemDataset("train", root, lst, sem_transforms(cfg, arch)["train"])
    loader = DataLoader(ds, batch_size=cfg.batch_size, shuffle=True, num_workers=cfg.workers,
                        seed=cfg.seed, drop_last=True)
    t0, stamps = time.perf_counter(), []
    for b in loader:
        stamps.append(time.perf_counter())
    loader_ms = 1e3 * (stamps[-1] - stamps[0]) / (len(stamps) - 1)
    log(f"  the loader alone: {len(stamps)} batches of {tuple(b['frame_current'].shape)}, "
        f"first after {stamps[0] - t0:.2f} s, then {loader_ms:.1f} ms a batch (8 threads)")

    aux_prefix = {"pspnet": "aux.", "deeplabv3": "aux_classifier."}.get(arch)
    aux0 = {k: v.detach().clone() for k, v in model.named_parameters()
            if aux_prefix and k.startswith(aux_prefix)}
    bn0 = {k: v.clone() for k, v in model.state_dict().items() if k.endswith("running_mean")}
    counts_by_step, prev = [], {}
    tp = tprofile(activities=[ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if dev.type == "cuda" else []))
    aux_err = []

    def on_step(step, state, metrics):
        now = launch_counts()
        counts_by_step.append({k: v - prev.get(k, 0) for k, v in now.items()})
        prev.update(now)
        if step == 0 and flow:
            lr = state.schedule(0) * 10
            for k, p0 in aux0.items():
                p1 = dict(model.named_parameters())[k].detach().cpu()
                want = p0 - lr * (1e-4 * p0)
                aux_err.append(float((p1 - want).abs().max() / want.abs().max().clamp_min(1e-30)))
        if step == steps - profiled - 1:
            _sync(dev)
            tp.start()
        if step == steps - 1:
            _sync(dev)
            tp.stop()

    prof = PhaseProfiler(sync=lambda: _sync(dev))
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    reset_launch_counts()
    t0 = time.perf_counter()
    run = run_flow_fit if flow else run_fit
    summary = run(model, root, cfg, profiler=prof, on_step=on_step, device=dev)
    total = time.perf_counter() - t0
    counts = launch_counts()
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9 if dev.type == "cuda" else 0.0
    step_s = prof.recorded_durations["train_step"]
    load_s = prof.recorded_durations["train_load"]
    timed = slice(warmup, steps - profiled)
    step_ms = 1e3 * statistics.median(step_s[timed])
    wait_ms = 1e3 * statistics.median(load_s[timed])
    epoch = summary["epochs"][0]
    log(f"  {summary['steps']} steps in {total:.1f} s with validation; ms a step (median of "
        f"{len(step_s[timed])}, synchronised): {step_ms:.1f} -> "
        f"{1e3 * cfg.batch_size / step_ms:.2f} samples/s; the step's wait for its batch "
        f"{wait_ms:.1f} ms (median); every step's ms {[round(1e3 * s, 1) for s in step_s]}")
    log(f"  train loss {epoch['train_loss']:.5f}, val mIoU {epoch['val_miou']:.4f} over "
        f"{val_batches} frames; peak memory {peak_gb:.2f} GB")
    if not np.isfinite(epoch["train_loss"]):
        raise AssertionError(f"the training loss is not finite: {epoch['train_loss']}")
    warps = 2 * (n - 1) if dev.type == "cuda" and flow else 0  # two chains of n - 1 warps
    per_step = {"grid_sample_cuda": warps, "grid_sample_backward_cuda": warps,
                "warp_chain_cuda": 0, "resize_quantize_int8_cuda": 0}
    bad = [(i, c) for i, c in enumerate(counts_by_step) if c != per_step]
    expected = {"grid_sample_cuda": warps * (steps + val_batches),
                "grid_sample_backward_cuda": warps * steps, "warp_chain_cuda": 0,
                "resize_quantize_int8_cuda": 0}
    log(f"  launches: {counts} (expected {expected}); every step {per_step}: "
        f"{'yes' if not bad else bad}")
    if bad or counts != expected:
        raise AssertionError(f"the training path launched {counts}, steps {bad}")
    if flow and aux0:
        log(f"  aux head after the first step: largest |p1 - (p0 - 10 lr wd p0)| "
            f"{max(aux_err):.2e} of its tensor's largest magnitude (tol 1e-6)")
        if not aux_err or max(aux_err) > 1e-6:
            raise AssertionError(f"the aux head did not take the zero-gradient update: "
                                 f"{aux_err}")
    after = model.state_dict()
    moved = {k: not torch.equal(v, after[k].cpu()) for k, v in bn0.items()}
    in_aux = {k for k in moved if aux_prefix and k.startswith(aux_prefix)}
    stuck = [k for k, m in moved.items() if not m and not (flow and k in in_aux)]
    aux_moved = [k for k in in_aux if flow and moved[k]]
    log(f"  BN running means moved: {sum(moved.values())} of {len(moved)}"
        + (f" (the aux head's {len(in_aux)} are not run by flow training)" if flow and in_aux
           else "" if moved else " (the ViT has no BN)"))
    if stuck or aux_moved:
        raise AssertionError(f"BN statistics: not moved {stuck}, aux moved {aux_moved}")

    os.makedirs(PROFILE_DIR, exist_ok=True)
    trace = os.path.join(PROFILE_DIR, f"{tag}_trace.json")
    tp.export_chrome_trace(trace)
    with open(os.path.join(PROFILE_DIR, f"{tag}_profile.txt"), "w") as f:
        f.write(tp.key_averages().table(sort_by="cuda_time_total", row_limit=40))
    with open(trace) as f:
        kernels = [e for e in json.load(f)["traceEvents"]
                   if e.get("ph") == "X" and e.get("cat") == "kernel"]
    dt = device_time(trace, profiled)
    span = (max(e["ts"] + e["dur"] for e in kernels) - min(e["ts"] for e in kernels)) / 1e3 \
        if kernels else float("nan")
    # each family's kernels as the union of their spans: K1-bwd's gather is
    # resident, waiting, while its index build runs
    spans = {name: [] for name, _ in TRAIN_FAMILIES}
    for e in kernels:
        fam = next(name for name, pats in TRAIN_FAMILIES if any(p in e["name"] for p in pats))
        spans[fam].append((e["ts"], e["ts"] + e["dur"]))
    families = {name: union_us(v) / (1e3 * profiled) for name, v in spans.items()}
    log(f"  profiler over {profiled} steps: device busy {dt['busy_ms']:.1f} ms a step of "
        f"{span / profiled:.1f} (idle share {1 - dt['busy_ms'] * profiled / span:.1%}); "
        f"{dt['kernels']:.0f} kernels a step; ms a step by family "
        f"{ {k: round(v, 3) for k, v in families.items()} }")
    log(tp.key_averages().table(sort_by="cuda_time_total", row_limit=15))
    return {"launches": counts, "step_ms": step_ms, "wait_ms": wait_ms, "loader_ms": loader_ms,
            "peak_gb": peak_gb, "busy_ms": dt["busy_ms"], "span_ms": span / profiled,
            "family_ms": families, "train_loss": epoch["train_loss"]}


def training_phases(dev) -> tuple:
    """Phases 3t, 4t and 14-17 in order; returns (3t's errors, 3t's timing,
    each phase's result by tag)."""
    log("[3t] K1 and K1-bwd at the training shapes (batch 2, 433 px crops, C = 4096; "
        "DeepLabV3 C = 2048; the ViT's 416 px crops, C = 768)")
    errs, timing = {}, {}
    checked = [check_train_kernels(dev, arch) for arch in TRAIN_SHAPES]
    checked += [check_k1_bwd_workspace(dev), check_k1_bwd_unaligned(dev)]
    for e, t in checked:
        timing.update(t)
        for kname, by in e.items():
            for tag, v in by.items():
                errs.setdefault(kname, {})[tag] = max(errs.get(kname, {}).get(tag, 0.0), v)
    for name, arch, size, steps in STEP_CHECKS:
        log(f"[4t] train steps on the card against the CPU ({name}, {size} px, float32: "
            f"{', '.join(steps)})")
        check_train_step_card_vs_cpu(arch, size=size, steps=steps)
    log("[14-17] training at full width")
    root = train_tree()
    results = {}
    names = {"pspnet": "PSPNet-50", "deeplabv3": "DeepLabV3-101", "vit": "ViT-B/32"}
    for phase, tag, arch, layers, method, crop, steps, warmup, val in TRAIN_PHASES:
        t0 = time.perf_counter()
        log(f"[{phase}] {method} through {'run_flow_fit' if method != 'supervised' else 'run_fit'}"
            f": {names[arch]} float32, batch 2, {round_train(crop, arch)} px crops of "
            f"{FRAME_HW[0]}x{FRAME_HW[1]} frames" + (f", n = {FRAME_DELTA}"
                                                      if method != "supervised" else ""))
        results[tag] = train_phase(dev, root, tag, arch, layers, method, crop, steps, warmup,
                                   val)
        log(f"  phase {phase}: {time.perf_counter() - t0:.1f} s")
    return errs, timing, results


# ------------------------------------------------------------------ main

# slow-pipe conversions and functions, the divide's range check, calls
SLOW_PIPE = ("MUFU", "F2I", "I2F", "FRND", "F2F", "FCHK", "CALL")


def kernel_label(mangled: str) -> str:
    """'warp_chain_kernel<bf16, 8, 1>' from an instantiation's mangled name
    (the template arguments this file's kernels take: types and integers)."""
    m = re.search(r"([a-z_]+_kernel)I(\w*)", mangled)
    if not m:
        return mangled
    args, rest = [], m.group(2)
    while rest and rest[0] != "E":
        lit = re.match(r"L[a-z](\d+)E", rest)
        named = re.match(r"(\d+)", rest)
        if lit:
            args.append(lit.group(1))
            rest = rest[lit.end():]
        elif named:
            n, k = int(named.group(1)), named.end()
            args.append({"__nv_bfloat16": "bf16"}.get(rest[k:k + n], rest[k:k + n]))
            rest = rest[k + n:]
        elif rest[0] == "f":
            args.append("float")
            rest = rest[1:]
        else:
            break
    return f"{m.group(1)}<{', '.join(args)}>"


def ptxas_usage(log_text: str):
    """(label, registers, spill stores, spill loads) for each function in
    nvcc's -Xptxas -v output."""
    rows, fn, spill = [], None, (0, 0)
    for line in log_text.splitlines():
        m = re.search(r"(?:Function properties for|Compiling entry function) '?(\w+)", line)
        if m:
            fn = m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            spill = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and fn:
            rows.append((kernel_label(fn), int(m.group(1)), *spill))
            fn, spill = None, (0, 0)
    return rows


def sass_loops(lib, kernels) -> None:
    """For each instantiation of the named kernels in the built library: its
    instructions inside loops (from a backward branch's target to the
    branch, by ``cuobjdump -sass``) and the SLOW_PIPE ones among them."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        log("  cuobjdump not found: no SASS count")
        return
    text = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True,
                          timeout=120, check=True).stdout
    for func in text.split("Function : ")[1:]:
        label = kernel_label(func.splitlines()[0].strip())
        if label.split("<")[0] not in kernels:
            continue
        ins = [(int(a, 16), op) for a, op in re.findall(
            r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9]*)", func)]
        branches = [(int(t, 16), int(a, 16)) for a, t in re.findall(
            r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?BRA\s+(?:`\(\S+\)\s+)?0x([0-9a-f]+)",
            func)]
        loops = [(t, a) for t, a in branches if t < a]
        inside = [op for a, op in ins if any(t <= a <= b for t, b in loops)]
        ops = [op for _, op in ins]
        slow_in = {o: inside.count(o) for o in SLOW_PIPE if o in inside}
        slow_all = {o: ops.count(o) for o in SLOW_PIPE if o in ops}
        log(f"  SASS {label}: {len(ins)} instructions, {len(inside)} in "
            f"loops; slow-pipe in loops {slow_in or 'none'}, in all {slow_all or 'none'}")


# the kernels whose loops phase 2 counts, by source
SASS_KERNELS = {"warp": ("warp_chain_kernel", "warp_chain_single_kernel"),
                "resize": ("resize_quantize_kernel",)}


def build_kernels(sources) -> None:
    """Build the sources at once (one compiler each); log ptxas's registers
    and spills and the SASS loop counts of the CUDA ones."""
    t0 = time.perf_counter()
    paths = build.build(sources)
    each = ", ".join(f"{s} {build.BUILD_INFO[s]['seconds']:.1f} s" for s in sources)
    log(f"  {' and '.join(f'csrc/{build._source(s).name}' for s in sources)} built in "
        f"{time.perf_counter() - t0:.1f} s ({each})")
    for src in sources:
        if src not in SASS_KERNELS:
            continue
        for label, regs, st, ld in ptxas_usage(build.BUILD_INFO[src]["log"]):
            log(f"  ptxas {src}.cu {label}: {regs} registers, spill stores {st} B, "
                f"spill loads {ld} B")
        sass_loops(paths[src], SASS_KERNELS[src])


def k2_alone(seed=0) -> int:
    """--k2: build csrc/warp.cu, check K2 in float32 and bf16 (phase 3's
    cases and the degenerate grids), then time it in bf16 on the main
    path's first-window grids from K1's output on a seeded 65x65x4096 key
    encoding, and on seeded random grids of the same shape, since bank
    conflicts in the gather depend on the grid."""
    log(f"[k2] {nvidia_smi_line()} | torch {torch.__version__} CUDA {torch.version.cuda}")
    build_kernels(["warp"])
    dev = torch.device("cuda")
    mvs, dg = main_path_grids(dev)
    for dtype in (torch.float32, torch.bfloat16):
        x, _, y0, grids, y0w, gridsw = kernel_cases(dev, dtype)
        check_k2(x, y0, grids, y0w, gridsw, mvs, dg)
    flush, cpm = L2Flush(dev), sleep_cycles_per_ms()
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((1, 65, 65, 4096), generator=g).to(dev, torch.bfloat16)
    y0 = grid_sample_cuda(x, mvs[0], False)
    rand = (torch.rand(tuple(mvs[1:].shape), generator=g) * 2.2 - 1.1).to(dev)
    for what, gs in (("main-path grids", mvs[1:]), ("random grids", rand)):
        r = time_k2(y0, gs, flush, cpm, full=False)
        log(f"  warp_chain_cuda y0{tuple(y0.shape)} bf16, {what} T={gs.shape[0]}: kernel "
            f"{r['ms']:.4f} ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']}) -> "
            f"{r['bound_ms'] / r['ms']:.1%} of bound")
    return 0


def k3_alone(seed=0) -> int:
    """--k3: build csrc/resize.cu, then phase 3 for K3 on a seeded stack of
    the int8 main path's shape (24x32x32x4096 bf16, scale from its absmax).
    The stack is post-ReLU like the encoder features the path blends (half
    of its lanes 0); it is timed again as drawn, without the ReLU, since a
    kernel's cost can depend on the data."""
    log(f"[k3] {nvidia_smi_line()} | torch {torch.__version__} CUDA {torch.version.cuda}")
    build_kernels(["resize"])
    g = torch.Generator().manual_seed(seed)
    drawn = (torch.randn((FRAME_DELTA - 1, 32, 32, 4096), generator=g) * 3).to(
        "cuda", torch.bfloat16)
    stack = drawn.clamp_min(0)
    scale = quant.scale_from_absmax(stack.float().abs().amax())
    check_k3(stack, scale)
    for what, x in (("post-ReLU", stack), ("as drawn", drawn)):
        log(f"  stack {what}:")
        time_k3(x, quant.scale_from_absmax(x.float().abs().amax()))
    return 0


def k1_bwd_alone() -> int:
    """--k1-bwd: build csrc/warp.cu, then phase 3t's checks and timings of
    K1 and K1-bwd at every architecture's training shapes, and K1-bwd's
    workspace route and grad_out at an odd offset."""
    log(f"[k1-bwd] {nvidia_smi_line()} | torch {torch.__version__} CUDA {torch.version.cuda}")
    build_kernels(["warp"])
    dev = torch.device("cuda")
    for arch in TRAIN_SHAPES:
        check_train_kernels(dev, arch)
    check_k1_bwd_workspace(dev)
    check_k1_bwd_unaligned(dev)
    return 0


def train_alone() -> int:
    """--train: build csrc/warp.cu and the codec, then phases 3t, 4t and 14-17."""
    log(f"[1] environment: {nvidia_smi_line()} | torch {torch.__version__} CUDA "
        f"{torch.version.cuda}")
    build_kernels(["warp", "jpeg"])
    training_phases(torch.device("cuda"))
    return 0


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on the card",
              file=sys.stderr)
        return 1
    if sys.argv[1:] == ["--k2"]:
        return k2_alone()
    if sys.argv[1:] == ["--k3"]:
        return k3_alone()
    if sys.argv[1:] == ["--train"]:
        return train_alone()
    if sys.argv[1:] == ["--k1-bwd"]:
        return k1_bwd_alone()
    t_start = time.perf_counter()
    smi = nvidia_smi_line()
    name = torch.cuda.get_device_name(0)
    log(f"[1] environment: {smi} | torch {torch.__version__} CUDA "
        f"{torch.version.cuda} | {name} x{torch.cuda.device_count()} | python "
        f"{sys.version.split()[0]}")

    log("[2] build (nvcc for the kernels, the host compiler for the image codec)")
    build_kernels(["warp", "resize", "jpeg"])

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    model = random_model("pspnet", torch.bfloat16, seed=0)
    wins = clip_windows(FRAME_DELTA, (512, 512), CLIPS_TIMED + 2, SIZE, dev)
    log(f"  set-up {time.perf_counter() - t0:.1f} s: PSPNet-50 bf16, {len(wins)} "
        f"windows of {FRAME_DELTA} frames, key frames "
        f"{tuple(wins[0]['frame_prev'].shape)}, grids {tuple(wins[0]['mvs_left'].shape)}")

    log("[3] kernels against their plain versions (main-path shapes)")
    errs = check_kernels(dev)
    stack, scale = capture_k3_input(model, wins, dev)
    errs["resize_quantize_int8_cuda"] = check_k3(stack, scale)
    timing = time_kernels(dev)
    timing["resize_quantize_int8_cuda"] = time_k3(stack, scale)
    del stack

    log("[3d] the kernels at the DeepLabV3 path's shapes (C = 2048)")
    t0 = time.perf_counter()
    dl_model = random_model("deeplabv3", torch.bfloat16, seed=0)
    dl_wins = clip_windows(FRAME_DELTA, (512, 512), CLIPS_TIMED + 2, DL_SIZE, dev)
    log(f"  set-up {time.perf_counter() - t0:.1f} s: DeepLabV3-50 bf16, key frames "
        f"{tuple(dl_wins[0]['frame_prev'].shape)}")
    dl_errs = check_kernels(dev, k1_shape=(1,) + DL_FEAT_HW + (2048,))
    stack, scale = capture_k3_input(dl_model, dl_wins, dev, size=DL_SIZE,
                                    feat_hw=DL_FEAT_HW, channels=2048)
    dl_errs["resize_quantize_int8_cuda"] = check_k3(stack, scale, feat_hw=DL_FEAT_HW,
                                                    every=False)
    dl_timing = time_kernels(dev, k1_shape=(1,) + DL_FEAT_HW + (2048,))
    dl_timing["resize_quantize_int8_cuda"] = time_k3(stack, scale, feat_hw=DL_FEAT_HW)
    del stack
    dl_model.cpu()

    log("[3v] K1 and K2 at the ViT path's shapes (C = 768)")
    vit_shape = (1,) + VIT_TOKENS_HW + (VIT_D,)
    vit_errs = check_kernels(dev, k1_shape=vit_shape)
    vit_timing = time_kernels(dev, k1_shape=vit_shape)
    geo = _chain_geometry(32 * 32, VIT_D, 2, 8)
    log(f"  K2 at C = {VIT_D} bf16: {geo.c_tile}-channel tile, {VIT_D // geo.c_tile} "
        f"blocks of {geo.threads} threads on "
        f"{torch.cuda.get_device_properties(dev).multi_processor_count} SMs")

    log("[3c] K1 and K2 at the crop route's shapes (PSPNet-50, 433 px crops, C = 4096)")
    crop_errs, crop_timing = check_crop_kernels(model, dev)
    log("[4] slice on the card against the slice on the CPU (float32)")
    check_slice_card_vs_cpu()
    check_slice_card_vs_cpu(int8=True)
    log("[4b] int8 decode on the card against the CPU")
    check_int8_decode_card_vs_cpu(model)
    log("[4d] DeepLabV3 slice on the card against the CPU (float32)")
    check_slice_card_vs_cpu("deeplabv3")
    check_slice_card_vs_cpu("deeplabv3", int8=True)
    log("[4e] DeepLabV3 int8 decode on the card against the CPU")
    check_int8_deeplab_decode_card_vs_cpu(dl_model)
    log("[4v] ViT-B/32 slice on the card against the CPU (float32, then bf16)")
    check_slice_card_vs_cpu("vit", size=128)
    check_slice_card_vs_cpu("vit", size=128, dtype=torch.bfloat16)
    vit_model = random_model("vit", torch.bfloat16, seed=0)
    models = {"pspnet": model, "deeplabv3": dl_model, "vit": vit_model}
    names = {"pspnet": "PSPNet-50", "deeplabv3": "DeepLabV3-50", "vit": "ViT-B/32"}
    paths = {}
    for phase, arch, ws, size, int8 in (
            ("[5]", "pspnet", wins, SIZE, False),
            ("[6]", "pspnet", wins, SIZE, True),
            ("[7]", "deeplabv3", dl_wins, DL_SIZE, False),
            ("[8]", "deeplabv3", dl_wins, DL_SIZE, True),
            ("[9]", "vit", dl_wins, DL_SIZE, False)):
        tag = f"{arch}_{'int8' if int8 else 'bf16'}"
        m = models[arch]
        for held in models.values():  # its own peak memory
            if held is not m:
                held.cpu()
        log(f"{phase} main path: {names[arch]} bf16, {size} px key frames, "
            f"n = {FRAME_DELTA}, {'int8' if int8 else 'bf16'} decoder")
        r = paths[tag] = run_main_path(m, ws, int8, tag, size=size)
        log(f"  {r['fps']:.2f} frames/s (median of {PASSES} passes x {CLIPS_TIMED} "
            f"windows; passes {[round(f, 2) for f in r['fps_passes']]}), peak memory "
            f"{r['peak_gb']:.2f} GB on {smi}")
        if int8:
            other = paths[f"{arch}_bf16"]["maps"]
            agree = float((r["maps"] == other).float().mean())
            log(f"  the int8 and bf16 decoders' maps of the last timed window agree on "
                f"{agree:.4f} of pixels")
            pieces = (time_decode_pieces(m) if arch == "pspnet"
                      else time_deeplab_decode_pieces(m))
            convs = pieces.values()
            busy = r["busy_ms"]
            k3_ms = r["kernel_ms"]["resize_quantize_int8_cuda"]
            im2col = sum(p["im2col_ms"] for p in convs)
            int_mm = sum(p["int_mm_ms"] for p in convs)
            log(f"  int8 window split (ms of {busy:.3f} busy): K3 {k3_ms:.4f} (profiler), "
                f"im2col {im2col:.4f}, _int_mm {int_mm:.4f} (events, L2 flushed), the rest "
                f"{busy - k3_ms - im2col - int_mm:.4f}")

    for held in models.values():
        held.cpu()
    t_files = time.perf_counter()
    log("[10] the image codec on this machine")
    codec = codec_phase()
    log(f"[11] the cached route from files: PSPNet-50 bf16, a 512 px tree resized to {SIZE}, "
        f"n = {FRAME_DELTA} (bench.py's protocol, with and without --streaming)")
    paths["pspnet_bf16_files"] = files_phase(model, dev)
    log(f"[12] the CLI's default crop route: PSPNet-50 bf16, {FRAME_HW[0]}x{FRAME_HW[1]} "
        f"frames, {CROP} px crops, n = {FRAME_DELTA}, through run_flow_predict")
    paths["pspnet_bf16_crop"] = crop = crop_route_phase(model, dev)
    model.cpu()
    log("[12b] the crop route card vs CPU (float32, 128x192 frames, 64 px crops, n = 5)")
    crop_card_vs_cpu()
    log(f"  phases 10-12: {time.perf_counter() - t_files:.1f} s")
    t_train = time.perf_counter()
    train_errs, train_timing, train_paths = training_phases(dev)
    paths.update(train_paths)
    log(f"  phases 3t, 4t, 14-17: {time.perf_counter() - t_train:.1f} s")

    sources = {"grid_sample_cuda": ("floodseg_tpu/ops/pallas_warp.py:70", "warp.cu"),
               "grid_sample_backward_cuda": (
                   "none: XLA's autodiff of floodseg_tpu/ops/grid_sample.py:79", "warp.cu"),
               "warp_chain_cuda": ("floodseg_tpu/ops/pallas_warp.py:139", "warp.cu"),
               "resize_quantize_int8_cuda": ("floodseg_tpu/ops/pallas_resize.py:135",
                                             "resize.cu")}
    # K1-bwd's main numbers are at the shape of 46 of a step's 48 launches
    timing["grid_sample_backward_cuda"] = train_timing[
        "grid_sample_backward_cuda (train step, float32)"]
    extra_rows = {"grid_sample_cuda": {
        "crop": crop_timing["grid_sample_cuda (crop -> 27x27)"],
        "crop_key_resample": crop_timing[
            "grid_sample_cuda (crop -> 67x120 identity, align_corners=True)"]},
        "grid_sample_backward_cuda": {
            "workspace_f32": train_timing[
                "grid_sample_backward_cuda (workspace route, float32)"]},
        "warp_chain_cuda": {"crop": crop_timing["warp_chain_cuda (27x27, 23 steps)"]}}
    # the training rows, "train_{head,step}_f32[_arch]" (K1-bwd's PSPNet step
    # row is its main timing above)
    for arch in TRAIN_SHAPES:
        label, suffix = ("", "") if arch == "pspnet" else (f"{arch} ", f"_{arch}")
        for kname in ("grid_sample_cuda", "grid_sample_backward_cuda"):
            for part in ("head", "step"):
                if (kname, arch, part) != ("grid_sample_backward_cuda", "pspnet", "step"):
                    extra_rows[kname][f"train_{part}_f32{suffix}"] = train_timing[
                        f"{kname} ({label}train {part}, float32)"]
        extra_rows["grid_sample_backward_cuda"][f"train_head_bf16{suffix}"] = train_timing[
            f"grid_sample_backward_cuda ({label}train head, bf16)"]
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    kernels = []
    for kname, (replaces, src) in sources.items():
        t = timing[kname]
        by_path = {p: r["launches"][kname] for p, r in paths.items()}
        by_dtype = {}
        for e in (errs, dl_errs, vit_errs, crop_errs, train_errs):
            for tag, v in e.get(kname, {}).items():
                by_dtype[tag] = max(by_dtype.get(tag, 0.0), v)
        kernels.append({
            "name": kname, "route": "cuda", "source": f"floodseg_tpu_torch/csrc/{src}",
            "replaces": replaces, "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "max_abs_err": max(by_dtype.values()), "max_abs_err_by_dtype": by_dtype,
            **{k: t[k] for k in keys},
            **({"deeplabv3": {k: dl_timing[kname][k] for k in keys}} if kname in dl_timing
               else {}),
            **({"vit": {k: vit_timing[kname][k] for k in keys}} if kname in vit_timing
               else {}),
            **{shape: {k: r[k] for k in keys} for shape, r in extra_rows.get(kname, {}).items()},
            "passed": True})
    log(f"  codec {json.dumps({k: round(v, 3) for k, v in codec.items()})}; crop route "
        f"{crop['seconds']['predict_interference']:.3f} s a window; training ms a step "
        f"{ {tag: round(r['step_ms'], 1) for tag, r in train_paths.items()} }")
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
