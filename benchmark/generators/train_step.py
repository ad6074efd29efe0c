"""The training generator: the port's ``supervised`` step, back to back.

Traffic parameters (``traffic/<mix>.json``): ``batch``, ``crop`` (square
crops, pixels), ``pool`` (seeded batches staged on the card and cycled),
``regions`` (class regions an image), ``ignore_share`` (the share of
regions labelled ``ignore_index``), and the step's settings: ``lr``,
``momentum``, ``weight_decay``, ``head_lr_scale``, ``power``,
``max_iter`` (the poly schedule), ``aux_weight``, ``ohem_thresh``,
``ohem_min_kept``, ``ignore_index``.

The entry is ``train/supervised.py::make_train_step`` over
``train/optim.py::make_optimizer`` and ``train/state.py::
create_train_state``, as ``run_fit`` builds them; each step gets a fresh
CPU generator for its dropout, as the fit loop gives it one. Frames are
normalised NHWC float32, labels int32 Voronoi regions of the classes with
a share of ignored regions. Steps run back to back with no sync; the
window ends with one.

``correct``: set-up builds the one training state the window uses and
drives it through its first three steps on three different batches
through the window's own step. After the window, with the program's state
freed, the plain reference (``reference/train.py``) follows those three
steps from the same weights, batches and dropout draws, in float32 with
TF32 off:

- ``loss_gap``: the largest relative gap of a step's loss;
- ``grad_gap``: the first gradient as the optimizer got it (its momentum
  buffer after one step, less the weight decay), the gap between the
  program's and the reference's norm of each parameter over the larger of
  the reference's norm of that parameter and of the median parameter, the
  worst parameter;
- ``change_gap``: the same of each parameter's change over the three
  steps, over the parameters whose reference gradient is at least a
  thousandth of the median parameter's (the others move by round-off).
"""

import time
from typing import Dict, List

import torch

from benchmark.core import counts, trace
from benchmark.core.clock import log
from benchmark.core.outcome import Check, Options, Outcome, Reading, Unit, sub_seed
from benchmark.core.weights import make_weights, parameter_names
from benchmark.reference import train as ref_train
from benchmark.reference.ops import MEAN, STD, FlopCounter, Params, full_float32

CHECKED_STEPS = 3
STRETCH_STEPS = 5
PALETTE = ((0, 0, 0), (30, 95, 170), (65, 117, 5), (212, 98, 1), (255, 244, 1))


def make_batches(seed: int, t: dict, classes: int, device) -> List[Dict[str, torch.Tensor]]:
    """``pool`` batches: each image a Voronoi partition of ``regions``
    seeded points, each region a class (or ``ignore_index`` for a share of
    them), coloured by class with a smooth texture and noise, normalised."""
    gen = torch.Generator(device=device).manual_seed(seed)
    b, s, k = int(t["batch"]), int(t["crop"]), int(t["regions"])
    ys = torch.arange(s, device=device, dtype=torch.float32)
    yy, xx = ys[:, None], ys[None, :]
    palette = torch.tensor(PALETTE, dtype=torch.float32, device=device)
    mean = torch.tensor(MEAN, device=device)
    std = torch.tensor(STD, device=device)
    out = []
    for _ in range(int(t["pool"])):
        pts = torch.rand((b, k, 2), generator=gen, device=device) * s
        cls = torch.randint(0, classes, (b, k), generator=gen, device=device)
        ignored = torch.rand((b, k), generator=gen, device=device) < float(t["ignore_share"])
        d = ((yy[None, None] - pts[:, :, 0, None, None]) ** 2
             + (xx[None, None] - pts[:, :, 1, None, None]) ** 2)
        nearest = d.argmin(dim=1)                                       # (B, S, S)
        region_cls = cls.gather(1, nearest.view(b, -1)).view(b, s, s)
        region_ign = ignored.gather(1, nearest.view(b, -1)).view(b, s, s)
        coarse = torch.randn((b, 3, s // 16 + 1, s // 16 + 1), generator=gen, device=device)
        tex = torch.nn.functional.interpolate(coarse, size=(s, s), mode="bilinear",
                                              align_corners=False).permute(0, 2, 3, 1)
        noise = torch.randn((b, s, s, 3), generator=gen, device=device)
        img = (palette[region_cls] * 0.6 + 60 + 25 * tex + 4 * noise).clamp(0, 255)
        label = torch.where(region_ign, torch.full_like(region_cls, int(t["ignore_index"])),
                            region_cls).to(torch.int32)
        out.append({"frame_current": ((img - mean) / std).contiguous(), "label": label})
    return out


def step_seed(seed: int, k: int) -> int:
    return sub_seed(seed, f"step{k}")


def _flops(cell) -> int:
    ref = cell.config_module.REFERENCE
    counter = FlopCounter()
    s = int(cell.traffic["crop"])
    x = torch.empty((int(cell.traffic["batch"]), 3, s, s), device="meta")
    ref.forward(counts.meta_params(ref.spec(cell.config), counter, requires_grad=True), x,
                cell.config, train=True)
    return counter.step


def run(cell, opts: Options, setup_done) -> Outcome:
    from floodseg_tpu_torch.train.optim import make_optimizer
    from floodseg_tpu_torch.train.state import create_train_state
    from floodseg_tpu_torch.train.supervised import make_loss_fn, make_train_step

    t, cfg, dev = cell.traffic, cell.config, opts.device
    sync = trace.sync_for(dev)
    ref = cell.config_module.REFERENCE
    spec = ref.spec(cfg)
    log("generator started")
    weights = make_weights(spec, sub_seed(opts.seed, "weights"), dev)
    batches = make_batches(sub_seed(opts.seed, "batches"), t, int(cfg["classes"]), dev)
    sync()
    log("weights and batches made")
    model = cell.config_module.program_model(cfg, weights, dev)
    opt, schedule = make_optimizer(model, float(t["lr"]), int(t["max_iter"]), "sgd",
                                   float(t["momentum"]), float(t["weight_decay"]),
                                   float(t["power"]), float(t["head_lr_scale"]))
    state = create_train_state(model, opt, schedule)
    loss_fn = make_loss_fn("ohem", float(t["aux_weight"]), int(t["ignore_index"]),
                           float(t["ohem_thresh"]), int(t["ohem_min_kept"]))
    train_step = make_train_step(model, loss_fn, int(cfg["classes"]), int(t["ignore_index"]))
    named = dict(model.named_parameters())
    step_flops = _flops(cell)
    log("the step built")

    def step(k: int):
        batch = batches[k % len(batches)]
        return train_step(state, batch, torch.Generator().manual_seed(step_seed(opts.seed, k)))

    # the first steps: set-up's warm-up, and what the reference follows
    losses = []
    for k in range(CHECKED_STEPS):
        _, metrics = step(k)
        losses.append(metrics["loss"])
        if k == 0:
            first = {n: _buffer(opt, p) for n, p in named.items()}
    moved = {n: p.detach().clone() for n, p in named.items()}
    sync()
    log(f"the first {CHECKED_STEPS} steps")

    units: List[Unit] = []
    setup_done()
    start = time.perf_counter()
    k = CHECKED_STEPS
    while time.perf_counter() - start < opts.seconds:
        t0 = time.perf_counter()
        step(k)
        units.append(Unit("step", time.perf_counter() - t0, 0.0, step_flops))
        k += 1
    sync()
    window_s = time.perf_counter() - start
    log(f"window: {len(units)} steps in {window_s:.3f} s")

    stretch = None
    if opts.trace:
        stretch = trace.profile_stretch(
            [lambda j=j: step(j) for j in range(k, k + STRETCH_STEPS)],
            [f"bench.step.{j}" for j in range(k, k + STRETCH_STEPS)], sync, opts.trace_path)
        log(f"stretch: {STRETCH_STEPS} steps profiled")
    memory_peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    losses = [float(x) for x in losses]
    del state, opt, model, named, train_step, metrics
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    with full_float32():
        checks = _check(cell, weights, batches, losses, first, moved, opts)
    log(f"reference: {CHECKED_STEPS} steps followed")
    samples = len(units) * int(t["batch"])
    return Outcome({"samples_per_s": samples / window_s}, len(units), 0, checks,
                   Reading(cfg, t, units, window_s, stretch), memory_peak)


def _buffer(opt, p):
    """The momentum buffer of ``p`` after the first step (None without one:
    the optimizer never stepped)."""
    buf = opt.state.get(p, {}).get("momentum_buffer")
    return None if buf is None else buf.clone()


def _first_grad_norm(buf, p0, wd) -> torch.Tensor:
    return torch.zeros(()) if buf is None else (buf - wd * p0).norm()


def _gap(prog: torch.Tensor, ref: torch.Tensor, floor: float) -> float:
    return abs(float(prog) - float(ref)) / max(float(ref), floor)


def _check(cell, weights, batches, losses, first, moved, opts) -> List[Check]:
    """The reference follows the first ``CHECKED_STEPS`` steps."""
    t, cfg = cell.traffic, cell.config
    ref = cell.config_module.REFERENCE
    dev = opts.device
    names = parameter_names(ref.spec(cfg))
    wd = float(t["weight_decay"])
    params = {n: weights[n].clone().requires_grad_(True) for n in names}
    bufs: Dict[str, torch.Tensor] = {}
    ref_losses, ref_first = [], None
    for k in range(CHECKED_STEPS):
        batch = batches[k % len(batches)]
        x = batch["frame_current"].permute(0, 3, 1, 2)
        seed = int(torch.randint(0, 2 ** 62, (1,),
                                 generator=torch.Generator().manual_seed(step_seed(opts.seed, k))))
        keeps = ref_train.dropout_keeps(seed, ref.dropout_masks(cfg, x.shape[0], x.shape[-2:]),
                                        dev)
        p = Params(params, tf32=opts.control)
        out = ref.forward(p, x, cfg, train=True, keeps=keeps)
        loss = ref_train.loss(out, batch["label"], t)
        grads = dict(zip(names, torch.autograd.grad(loss, [params[n] for n in names])))
        ref_losses.append(float(loss.detach()))
        if k == 0:
            ref_first = {n: g.norm() for n, g in grads.items()}
        with torch.no_grad():
            ref_train.sgd_step(params, grads, bufs, ref_train.poly_lr(t, k), t, ref.HEADS)
        del out, loss, grads

    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(losses, ref_losses))
    g_ref = torch.stack([ref_first[n] for n in names])
    g_med = float(g_ref.median())
    grad_gap = max(_gap(_first_grad_norm(first[n], weights[n], wd), ref_first[n], g_med)
                   for n in names)
    with torch.no_grad():
        d_ref = {n: (params[n] - weights[n]).norm() for n in names}
    counted = [n for n in names if float(ref_first[n]) >= 1e-3 * g_med]
    d_med = float(torch.stack([d_ref[n] for n in counted]).median())
    change_gap = max(_gap((moved[n] - weights[n]).norm(), d_ref[n], d_med) for n in counted)
    lim = cell.limits
    return [Check("loss_gap", loss_gap, lim["loss_gap"]["limit"]),
            Check("grad_gap", grad_gap, lim["grad_gap"]["limit"]),
            Check("change_gap", change_gap, lim["change_gap"]["limit"])]
