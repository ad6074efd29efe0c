"""The flow-predict generator: keyframe-warp video through the port's cached
whole-frame route, a closed loop with one window in flight.

Traffic parameters (``traffic/<mix>.json``): ``n`` (frames a window, the
key-frame interval), ``video_hw`` (the video's frames; the grid is its
16 px macroblocks), ``key_hw`` (the key frames' size after the predict
resize), ``out_hw`` (the class maps' size), ``windows_per_video`` (videos
play back to back), ``videos`` (distinct seeded videos staged on the card
and cycled), ``pan_px`` and ``local_px`` (the global pan's and the local
drift's peak speeds, pixels a frame), ``checked_windows`` and
``check_within`` (the sample of windows the reference checks).

The entry is ``make_cached_flow_predict_fn``: ``full_fn`` on a video's
first window, ``cached_fn`` on every later one with the previous window's
next-key encoding, as ``run_predict`` calls them. A window ends when its
int32 maps are complete on the card (a sync), as ``run_predict`` consumes
them. Inputs and weights are on the card before the window opens.

``correct``: the sampled windows' maps and next-key encodings against the
plain reference (``reference/flow.py``) in float32 on the same weights and
inputs, after the program's state is freed:

- ``maps_gap``: the widest gap, over every pixel of the sampled windows'
  maps, by which the reference's logit of the program's class lies below
  the reference's best, in units of the spread of the window's reference
  logits over frames and pixels (each class's mean taken out). Rounding
  flips only near-ties; a wrong warp, blend or decode flips pixels that
  lead by more;
- ``enc_err``: the relative L2 error of each sampled window's next-key
  encoding, the largest.

Seeded random weights put one class ahead nearly everywhere, which no
warp moves; so before the program is built, the decoder's last bias
(``REFERENCE.DECODE_BIAS``) is set so that each class's mean logit over the
first video's first key frame is zero, and the maps hold every class.
"""

import time
from typing import Dict, List

import torch

from benchmark.core import counts, trace
from benchmark.core.clock import log
from benchmark.core.outcome import Check, Options, Outcome, Reading, Unit, p95, sub_seed
from benchmark.core.program import DTYPES
from benchmark.core.synthetic import identity_grid, make_video
from benchmark.core.weights import make_weights
from benchmark.reference import flow as ref_flow
from benchmark.reference.ops import FlopCounter, Params, full_float32, normalize, resize

STRETCH_WINDOWS = 10
OUT_BLOCK = 5  # frames a block in the reference's output-size resize


def _flops(cell, key_hw) -> Dict[str, int]:
    """Operations of one encoder pass and one frame's decode, and the
    feature map's shape, from the reference on the meta device."""
    ref = cell.config_module.REFERENCE
    spec = ref.spec(cell.config)
    enc = FlopCounter()
    f, _ = ref.encode(counts.meta_params(spec, enc),
                      torch.empty((1, 3, *key_hw), device="meta"), cell.config)
    dec = FlopCounter()
    ref.decode(counts.meta_params(spec, dec), f, cell.config)
    return {"encode": enc.forward, "decode": dec.forward, "feat": tuple(f.shape)}


def run(cell, opts: Options, setup_done) -> Outcome:
    t = cell.traffic
    cfg = cell.config
    dev = opts.device
    sync = trace.sync_for(dev)
    n, wpv = int(t["n"]), int(t["windows_per_video"])
    video_hw, key_hw, out_hw = (tuple(t[k]) for k in ("video_hw", "key_hw", "out_hw"))

    log("generator started")
    videos = [make_video(sub_seed(opts.seed, f"video{v}"), wpv, n, video_hw, key_hw,
                         float(t["pan_px"]), float(t["local_px"]), dev)
              for v in range(int(t["videos"]))]
    sync()
    log(f"{len(videos)} videos made")
    spec = cell.config_module.REFERENCE.spec(cfg)
    weights = make_weights(spec, sub_seed(opts.seed, "weights"), dev)
    _centre_classes(cell.config_module.REFERENCE, weights, videos[0]["keys"][0], cfg)
    model = cell.config_module.program_model(cfg, weights, dev)
    sync()
    log("weights made and loaded")
    identity = identity_grid(*video_hw)
    from floodseg_tpu_torch.train.flow import make_cached_flow_predict_fn
    int8 = bool(cfg.get("int8_decode")) or opts.control
    full_fn, cached_fn = make_cached_flow_predict_fn(
        model, n=n, out_size=out_hw, default_grid=identity.numpy(), int8_decode=int8,
        int8_encode=opts.control, device=dev)
    variables = model.state_dict()
    log("programs built")
    fl = _flops(cell, key_hw)
    unit_flops = {"full": 2 * fl["encode"] + n * fl["decode"],
                  "cached": fl["encode"] + n * fl["decode"]}

    state = {"enc": None}

    def window(i: int):
        """Window i of the schedule (videos back to back, cycled)."""
        v, w = divmod(i, wpv)
        vid = videos[v % len(videos)]
        if w == 0:
            out, enc = full_fn(variables, vid["keys"][0], vid["keys"][1], vid["left"][0],
                               vid["right"][0])
            kind = "full"
        else:
            out, enc = cached_fn(variables, state["enc"], vid["keys"][w + 1], vid["left"][w],
                                 vid["right"][w])
            kind = "cached"
        state["enc"] = enc
        return kind, out, enc

    # warm-up: both programs at the cell's shapes
    for i in range(3):
        window(i)
    sync()
    log("warm-up: 3 windows")

    rng = torch.Generator().manual_seed(sub_seed(opts.seed, "sample"))
    within = int(t["check_within"])
    sampled = {0, wpv} | {int(j) for j in
                          torch.randperm(within - 1, generator=rng)[:int(t["checked_windows"])] + 1}
    kept = {}
    units: List[Unit] = []
    setup_done()
    start = time.perf_counter()
    i = 0
    while True:
        t0 = time.perf_counter()
        kind, out, enc = window(i)
        t1 = time.perf_counter()
        sync()
        t2 = time.perf_counter()
        units.append(Unit(kind, t1 - t0, t2 - t0, unit_flops[kind]))
        if i in sampled:
            kept[i] = (out, enc)
        i += 1
        if t2 - start >= opts.seconds:
            break
    window_s = time.perf_counter() - start
    frames = n * len(units)
    log(f"window: {len(units)} windows in {window_s:.3f} s; a window's mean enqueue "
        f"{1e3 * sum(u.enqueue_s for u in units) / len(units):.3f} ms, "
        f"total {1e3 * sum(u.total_s for u in units) / len(units):.3f} ms")

    stretch = None
    counters = {}
    if opts.trace:
        # cached windows of the first video, after its full window, each
        # ending in a sync as in the measured window
        ids = range(1, 1 + min(STRETCH_WINDOWS, wpv - 1))
        window(0)
        stretch = trace.profile_stretch([lambda j=j: (window(j), sync()) for j in ids],
                                        [f"bench.window.{j}" for j in ids], sync,
                                        opts.trace_path)
        counters["warp_bytes"] = float(sum(
            _warp_bytes(videos[0], j, identity.to(dev), fl["feat"], n, DTYPES[cfg["dtype"]].itemsize)
            for j in ids))
        log(f"stretch: {len(ids)} windows profiled")
    memory_peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    del full_fn, cached_fn, variables, model, state
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    checks, notes = _check(cell, weights, videos, kept, identity.to(dev), n, wpv, out_hw)
    log(f"reference: {len(kept)} windows checked")
    reading = Reading(cfg, t, units, window_s, stretch, counters)
    e2e = {"frames_per_s": frames / window_s,
           "window_ms_p95": 1e3 * p95([u.total_s for u in units])}
    return Outcome(e2e, len(units), 0, checks, reading, memory_peak, notes)


def _warp_bytes(vid, w: int, identity: torch.Tensor, feat, n: int, itemsize: int) -> int:
    """Bytes window w's warps must move: the two chains' first warps (K1),
    the key map's resample (K1, align_corners=True) and the two chains (K2),
    in the configuration's dtype."""
    _, c, fh, fw = feat
    gh, gw = identity.shape[:2]
    total = counts.warp_bytes((1, fh, fw, c), itemsize, identity[None], True)
    for grids in (vid["left"][w], vid["right"][w]):
        total += counts.warp_bytes((1, fh, fw, c), itemsize, grids[0], False)
        total += counts.chain_bytes(gh, gw, c, itemsize, n - 2)
    return total


def _centre_classes(ref, weights, key, cfg) -> None:
    """Set the decoder's last bias so that each class's mean logit over the
    key frame (1, H, W, 3) is zero: the reference in float32."""
    name = ref.DECODE_BIAS
    p = Params(weights)
    with torch.no_grad(), full_float32():
        logits = ref.decode(p, ref.encode(p, normalize(key), cfg)[0], cfg)
        weights[name] -= logits.mean(dim=(0, 2, 3)).to(weights[name].dtype)


def _check(cell, weights, videos, kept, identity, n, wpv, out_hw):
    """The reference over each sampled window the program ran: the numbers
    compared, and notes on the reference's maps for control.py."""
    ref = cell.config_module.REFERENCE
    cfg = cell.config
    lim = cell.limits
    gap_limit = lim["maps_gap"]["limit"]
    p = Params({k: v.float() for k, v in weights.items()})
    classes = int(cfg["classes"])
    enc_err, widest = 0.0, 0.0
    pixels, flips, leading = 0, 0, 0
    shares = torch.zeros(classes, dtype=torch.float64)
    with torch.no_grad(), full_float32():
        for i, (maps, enc) in sorted(kept.items()):
            v, w = divmod(i, wpv)
            vid = videos[v % len(videos)]
            logits, f_next = ref_flow.window_logits(
                lambda x: ref.encode(p, x, cfg)[0], lambda f: ref.decode(p, f, cfg),
                normalize(vid["keys"][w]), normalize(vid["keys"][w + 1]), vid["left"][w],
                vid["right"][w], identity, n)
            scale = float((logits - logits.mean(dim=(0, 2, 3), keepdim=True)).std())
            for b in range(0, n, OUT_BLOCK):
                up = resize(logits[b:b + OUT_BLOCK], out_hw, align_corners=True)
                chosen = up.gather(1, maps[b:b + OUT_BLOCK].long()[:, None])[:, 0]
                top2, best = up.topk(2, dim=1)
                gap = (top2[:, 0] - chosen) / scale
                widest = max(widest, float(gap.max()))
                pixels += gap.numel()
                flips += int((gap > 0).sum())
                leading += int(((top2[:, 0] - top2[:, 1]) / scale > gap_limit).sum())
                shares += torch.bincount(best[:, 0].flatten(), minlength=classes).double().cpu()
            e = enc.permute(0, 3, 1, 2).float()
            enc_err = max(enc_err, float((e - f_next).norm() / f_next.norm()))
    notes = {"flip_pct": 100.0 * flips / pixels, "leading_pct": 100.0 * leading / pixels,
             **{f"class{k}_pct": float(100.0 * shares[k] / pixels) for k in range(classes)}}
    return [Check("maps_gap", widest, gap_limit),
            Check("enc_err", enc_err, lim["enc_err"]["limit"])], notes
