"""One rank of the port's data-parallel tests (tests/test_torch_parallel.py),
after tests/multihost_worker.py; also the shared cases that the test
process runs as the one-rank oracle. Imports no JAX.

    FLOODSEG_MULTIHOST=1 FLOODSEG_COORDINATOR=localhost:PORT \\
    FLOODSEG_NUM_PROCESSES=2 FLOODSEG_PROCESS_ID={0,1} \\
    python tests/torch_dist_worker.py TASK.pt OUT_PREFIX

rendezvouses through the port's FLOODSEG_* path (parallel/dist.py, gloo on
the CPU), runs every case of the task file on this rank's slice of each
global batch (``run_case``) and saves the results to OUT_PREFIX.rank{r}.pt.

A case is a dict: ``method`` (supervised, flow_supervised, gan, flow_gan,
contrastive; fit, cli, flow_predict and segm, the entry points; and for the JAX comparisons
sup_vit, semi_vit, crop_forward and predict), ``batches`` (the global
numpy batch of each step), and what the method needs. The train cases' model is ``TinySegNet``: float64, the
port's Conv2d, BatchNorm2d and both kinds of Dropout (channel dropout with
a batch axis drawn at the global shape, element dropout), an aux head and
a 256-channel rep head, encode/decode for the flow steps, at 16 px; a
case's ``remat`` (True or False) adds a bottleneck, rematerialised or not.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn as nn  # noqa: E402

from floodseg_tpu_torch.core.config import default_fit_config  # noqa: E402
from floodseg_tpu_torch.data.dataset import _INT_KEYS  # noqa: E402
from floodseg_tpu_torch.models import S4GANDiscriminator, SegmenterViT, with_rep  # noqa: E402
from floodseg_tpu_torch.models.layers import (  # noqa: E402
    BatchNorm2d,
    Conv2d,
    Dropout,
    init_from_generator_,
)
from floodseg_tpu_torch.models.resnet import Bottleneck  # noqa: E402
from floodseg_tpu_torch.parallel import (  # noqa: E402
    World,
    current_world,
    make_dp_predict_fn,
    maybe_initialize_multihost,
    shard_batch,
)
from floodseg_tpu_torch.train import (  # noqa: E402
    ContrastiveConfig,
    create_u2pl_state,
    make_optimizer,
    make_u2pl_steps,
    sync_teacher,
)
from floodseg_tpu_torch.train.evaluate import make_crop_forward  # noqa: E402
from floodseg_tpu_torch.train.fit import (  # noqa: E402
    run_flow_fit,
    run_test,
    run_validate,
    step_generator,
)
from floodseg_tpu_torch.train.flow import make_flow_predict_fn, make_flow_train_step  # noqa: E402
from floodseg_tpu_torch.train.gan import (  # noqa: E402
    flow_g_forward,
    make_gan_train_step,
    single_frame_g_forward,
)
from floodseg_tpu_torch.train.state import TrainState, create_train_state  # noqa: E402
from floodseg_tpu_torch.train.supervised import make_loss_fn, make_train_step  # noqa: E402

CLASSES, SIZE, T, WIDTH = 5, 16, 3, 8
F64 = torch.float64
CCFG = dict(num_queries=16, num_negatives=8, max_enqueue=16)
CAPS = dict(bank_capacity=24, bank_class0_capacity=32)


class TinySegNet(nn.Module):
    """NHWC in, NHWC out: encode -> (features,), decode -> logits at the
    same size; forward -> {"pred", "aux"} (and "rep" with ``rep``). With
    ``remat`` True or False the stem is followed by a ResNet bottleneck,
    rematerialised or not."""

    def __init__(self, rep: bool = False, remat=None):
        super().__init__()
        self.stem = nn.Sequential(Conv2d(3, WIDTH, 3, padding=1, dtype=F64),
                                  BatchNorm2d(WIDTH, F64), nn.ReLU(),
                                  Dropout(0.25, broadcast_dims=(2, 3)))
        if remat is not None:
            self.stem.append(Bottleneck(WIDTH, WIDTH // 4, dtype=F64))
            self.stem[-1].remat = remat
        self.cls = nn.Sequential(Conv2d(WIDTH, WIDTH, 3, padding=1, dtype=F64),
                                 BatchNorm2d(WIDTH, F64), nn.ReLU(), Dropout(0.1),
                                 Conv2d(WIDTH, CLASSES, 1, dtype=F64))
        self.aux = nn.Sequential(Conv2d(WIDTH, CLASSES, 1, dtype=F64))
        self.rep = (nn.Sequential(Conv2d(WIDTH, WIDTH, 1, dtype=F64), BatchNorm2d(WIDTH, F64),
                                  nn.ReLU(), Conv2d(WIDTH, 256, 1, dtype=F64))
                    if rep else None)

    def encode(self, x):
        return (self.stem(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1),)

    def decode(self, f):
        return self.cls(f.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)

    def forward(self, x):
        f = self.encode(x)[0]
        nchw = f.permute(0, 3, 1, 2)
        out = {"pred": self.decode(f), "aux": self.aux(nchw).permute(0, 2, 3, 1)}
        if self.rep is not None:
            out["rep"] = self.rep(nchw).permute(0, 2, 3, 1)
        return out


def tiny_model(seed: int, rep: bool = False, remat=None) -> nn.Module:
    return init_from_generator_(TinySegNet(rep, remat).double(),
                                torch.Generator().manual_seed(seed))


def narrow_vit(config: dict, rep: bool, state_dict) -> nn.Module:
    """The float64 narrow Segmenter ViT (dropout 0) of the JAX cases, with
    the weights the test process bridged from the JAX variables."""
    m = SegmenterViT(classes=CLASSES, dropout=0.0, dtype=F64, **config)
    m = (with_rep(m, F64) if rep else m).double()
    m.load_state_dict(state_dict)
    return m


def _torch(batch):
    """A host batch as the loader's device_put gives it: tensors, the ids
    host-side."""
    if all(isinstance(v, dict) for v in batch.values()):
        return {k: _torch(v) for k, v in batch.items()}
    return {k: (v if k in _INT_KEYS else torch.from_numpy(np.ascontiguousarray(v)))
            for k, v in batch.items()}


def _local(batch, world):
    if all(isinstance(v, dict) for v in batch.values()):
        return {k: shard_batch(v, world) for k, v in batch.items()}
    return shard_batch(batch, world)


def _flat(prefix: str, module_or_opt) -> dict:
    """Tensors of a module's state_dict or an optimizer's state, copied."""
    out = {}
    if isinstance(module_or_opt, nn.Module):
        for k, v in module_or_opt.state_dict().items():
            out[f"{prefix}{k}"] = v.detach().clone()
        return out
    for i, st in module_or_opt.state_dict()["state"].items():
        for k, v in st.items():
            out[f"{prefix}{i}.{k}"] = torch.as_tensor(v).detach().clone()
    return out


def _metrics(step: int, metrics: dict) -> dict:
    return {f"m{step}.{k}": v.detach().clone() for k, v in metrics.items()}


class ReplayDraws:
    """The draws a one-rank step recorded (``draws``: (method, value) in
    call order), given back in the same order."""

    def __init__(self, draws):
        self.draws = list(draws)

    def _next(self, name):
        got, value = self.draws.pop(0)
        assert got == name, (got, name)
        return value

    def coin(self):
        return self._next("coin")

    def box(self, i, h, w, ratio=2.0):
        return self._next("box")

    def class_scores(self, i, num_classes):
        return self._next("class_scores")

    def subset_scores(self, c, size):
        return self._next("subset_scores")

    def choice(self, c, mask_flat, n):
        return self._next("choice")

    def negatives(self, c, count, n):
        return self._next("negatives")


def run_case(case: dict, world: World) -> dict:
    """Run one case over ``world`` (a world of one: the one-rank oracle on
    the global batches) and return its results by name."""
    method = case["method"]
    if method in ("crop_forward", "predict"):
        return _run_inference(case, world)
    if method == "fit":
        return _run_fit(case, world)
    if method == "cli":
        return _run_cli(case)
    if method == "flow_predict":
        return _run_flow_predict(case, world)
    if method == "segm":
        return _run_segm(case)
    batches = [_torch(_local(b, world)) for b in case["batches"]]
    seed = case.get("seed", 0)  # the JAX cases' weights come in the case
    out = {}
    if method in ("supervised", "flow_supervised", "sup_vit"):
        model = (narrow_vit(case["config"], False, case["state_dict"]) if method == "sup_vit"
                 else tiny_model(seed, remat=case.get("remat")))
        opt, sched = make_optimizer(model, 1e-2, 10, head_lr_scale=case.get("head_lr_scale",
                                                                            1.0))
        state = create_train_state(model, opt, sched)
        loss_fn = make_loss_fn("ohem", case.get("aux_weight", 0.4), 255, 0.7, 50)
        if method == "flow_supervised":
            interp, plain = make_flow_train_step(model, make_loss_fn("ohem", 0.0, 255, 0.7, 50),
                                                 CLASSES, 255, world=world)
            steps = [plain if kind == "plain" else interp for kind in case["kinds"]]
        else:
            steps = [make_train_step(model, loss_fn, CLASSES, 255, world)] * len(batches)
        for i, (step, b) in enumerate(zip(steps, batches)):
            state, m = step(state, b, step_generator(seed, i))
            out.update(_metrics(i, m))
        out.update(_flat("model.", model))
        out.update(_flat("opt.", opt))
        return out
    if method in ("gan", "flow_gan"):
        model = tiny_model(seed)
        disc = init_from_generator_(S4GANDiscriminator(CLASSES, ndf=8, dtype=F64).double(),
                                    torch.Generator().manual_seed(seed + 7))
        opt_g, sched_g = make_optimizer(model, 1e-2, 10, head_lr_scale=1.0)
        opt_d, sched_d = make_optimizer(disc, 1e-3, 10, "adam", weight_decay=0.0,
                                        head_lr_scale=1.0, betas=(0.9, 0.99))
        state_g, state_d = TrainState(0, model, opt_g, sched_g), TrainState(0, disc, opt_d,
                                                                            sched_d)
        flow = method == "flow_gan"
        g_forward = flow_g_forward(model) if flow else single_frame_g_forward(model)
        step = make_gan_train_step(g_forward, CLASSES, 255, threshold_st=0.5,
                                   gt_norm_by_labeled_max=not flow, world=world)
        for i, b in enumerate(batches):
            state_g, state_d, m = step(state_g, state_d, b, step_generator(seed, i))
            out.update(_metrics(i, m))
        out.update(_flat("model.", model))
        out.update(_flat("opt.", opt_g))
        out.update(_flat("d.", disc))
        out.update(_flat("dopt.", opt_d))
        return out
    if method in ("contrastive", "semi_vit"):
        ccfg = ContrastiveConfig(**CCFG, num_devices=case["num_devices"])
        if method == "semi_vit":
            model = narrow_vit(case["config"], True, case["state_dict"])
            teacher = narrow_vit(case["config"], True, case["teacher_state_dict"])
        else:
            model, teacher = tiny_model(seed, rep=True), tiny_model(seed + 1, rep=True)
        opt, sched = make_optimizer(model, 1e-2, 10, head_lr_scale=case.get("head_lr_scale",
                                                                            1.0))
        state = create_u2pl_state(model, opt, sched, teacher, num_classes=CLASSES,
                                  max_enqueue=CCFG["max_enqueue"], **CAPS)
        sup, semi = make_u2pl_steps(CLASSES, ccfg, 255, case.get("aux_weight", 0.4), 0.7, 50,
                                    world=world)
        draws = case.get("draws")
        for i, (kind, b) in enumerate(zip(case["kinds"], batches)):
            rng = step_generator(seed, i)
            if kind == "sup":
                state, m = sup(state, b, rng)
            else:
                if not state.teacher_synced:
                    sync_teacher(state)
                d = None if draws is None else draws[i]
                state, m = semi(state, b, rng, 0.5, i,
                                d if d is None or hasattr(d, "coin") else ReplayDraws(d))
            out.update(_metrics(i, m))
        out.update(_flat("model.", model))
        out.update(_flat("teacher.", state.teacher))
        out.update(_flat("opt.", opt))
        bank = state.bank
        out.update({"bank.counts": bank.counts.clone(), "bank.ptrs": bank.ptrs.clone(),
                    "bank.keys": bank.keys.clone()})
        return out
    raise ValueError(f"unknown case method {method!r}")


def _run_fit(case: dict, world: World) -> dict:
    """``run_flow_fit``, then ``run_validate`` and ``run_test`` on its
    weights, of the float64 narrow ViT (dropout 0.1) drawn from ``seed``, on
    the tree at ``root``; ``cfg``: FitConfig overrides, ``batch_size``
    this rank's share of the global batch."""
    m = SegmenterViT(classes=CLASSES, dtype=F64, **case["config"]).double()
    init_from_generator_(m, torch.Generator().manual_seed(case["seed"]))
    cfg = default_fit_config(**case["cfg"])
    w = world if world.parallel else None
    summary = run_flow_fit(m, case["root"], cfg, device="cpu", world=w)
    out = _flat("model.", m)
    for e, rec in enumerate(summary["epochs"]):
        out.update({f"epoch{e}.{k}": torch.as_tensor(rec[k])
                    for k in ("train_loss", "train_miou", "val_miou")})
    for name, res in (("val", run_validate(m, case["root"], cfg, "flow_supervised",
                                          device="cpu", world=w)),
                      ("test", run_test(m, case["root"], cfg, "flow_supervised", device="cpu",
                                        world=w))):
        out.update({f"{name}.{k}": torch.as_tensor(v) for k, v in res.items()})
    return out


def _run_cli(case: dict) -> dict:
    """``cli.main.run(argv)`` (``fit``: the epochs, restore_best, the test)
    with the Runner's model the float64 narrow ViT drawn
    from ``seed``, in the world the process is in. Returns the state the
    test ran on, the run's summary and whether this rank writes the run's
    files."""
    from floodseg_tpu_torch.cli import main as cli
    from floodseg_tpu_torch.cli.runner import Runner

    def build(self):
        m = SegmenterViT(classes=CLASSES, dtype=F64, **case["config"]).double()
        return init_from_generator_(m.eval(), torch.Generator().manual_seed(case["seed"]))

    own, Runner._build_model = Runner._build_model, build
    try:
        runner = cli.run(case["argv"])
    finally:
        Runner._build_model = own
    out = _flat("model.", runner.state.model)
    out.update({f"summary.{k}": torch.as_tensor(v) for k, v in runner.logger.summary.items()
                if not isinstance(v, (list, str)) and k not in (
                    "predict_time_mean", "predict_time_sum", "frames_per_second")})
    out["writes"] = torch.tensor(runner.logger.writes)
    return out


def _run_segm(case: dict) -> dict:
    """``segm.train.main(argv)`` (the epochs, each with its sliding-window
    evaluation, the checkpoints, log.txt) with the float64 narrow Segmenter
    drawn from ``seed``, in the world the process is in: the last
    checkpoint's weights and log.txt's numbers."""
    import json

    from floodseg_tpu_torch.core.checkpoint import read_model_state
    from floodseg_tpu_torch.models import vit
    from floodseg_tpu_torch.segm import train

    own_cls, own_init = vit.SegmenterViT, train.init_model
    vit.SegmenterViT = lambda **kw: own_cls(**dict(kw, dtype=F64)).double()
    train.init_model = lambda m, seed: init_from_generator_(
        m, torch.Generator().manual_seed(case["seed"]))
    try:
        train.main(case["argv"], device="cpu")
    finally:
        vit.SegmenterViT, train.init_model = own_cls, own_init
    if torch.distributed.is_initialized():
        torch.distributed.barrier()  # rank 0 has written log.txt
    log_dir = case["argv"][case["argv"].index("--log-dir") + 1]
    out = {f"model.{k}": v for k, v in
           read_model_state(os.path.join(log_dir, "checkpoints", "last")).items()}
    with open(os.path.join(log_dir, "log.txt")) as f:
        for e, line in enumerate(f):
            out.update({f"epoch{e}.{k}": torch.tensor(float(v), dtype=F64)
                        for k, v in json.loads(line).items()})
    return out


def _run_flow_predict(case: dict, world: World) -> dict:
    """``run_flow_predict`` of the tree's video on the whole-frame route
    (one window a rank over ``world``) with the float32 narrow ViT of the
    case, PNGs to ``png_dir``; the summary's numbers but the times."""
    from floodseg_tpu_torch.train import run_flow_predict
    m = SegmenterViT(classes=CLASSES, dtype=torch.float32, **case["config"])
    m.load_state_dict(case["state_dict"])
    summary = run_flow_predict(m.eval(), m.state_dict(), case["root"], "synth", frame_delta=5,
                               resize=case["resize"], no_cropping=True, num_classes=CLASSES,
                               save_images_dir=case["png_dir"], workers=1, device="cpu",
                               world=world if world.parallel else None)
    return {k: torch.as_tensor(v) for k, v in summary.items()
            if k not in ("predict_time_mean", "predict_time_sum", "frames_per_second")}


def _run_inference(case: dict, world: World) -> dict:
    """The DP crop forward on ``crops`` and DP predict on ``clips``, with
    the float32 narrow ViT of the case."""
    m = SegmenterViT(classes=CLASSES, dtype=torch.float32, **case["config"])
    m.load_state_dict(case["state_dict"])
    m.eval()
    if case["method"] == "crop_forward":
        fwd = make_crop_forward(m, CLASSES, flip=True, device="cpu", world=world)
        return {"probs": fwd(m.state_dict(), case["crops"]).clone()}
    fn = make_flow_predict_fn(m, n=case["n"], out_size=case["out_size"],
                              default_grid=case["default_grid"], device="cpu")
    dp = make_dp_predict_fn(fn, world)
    clips = case["clips"]
    out = {}
    for name in ("full", "remainder"):
        c = clips[name]
        out[name] = dp(m.state_dict(), c["frame_prev"], c["frame_next"], c["mvs_left"],
                       c["mvs_right"]).clone()
    return out


def main(task_path: str, out_prefix: str) -> None:
    assert maybe_initialize_multihost(device="cpu"), "FLOODSEG_MULTIHOST is not set"
    world = current_world()
    task = torch.load(task_path, weights_only=False)
    results = {name: run_case(case, world) for name, case in task.items()}
    torch.save(results, f"{out_prefix}.rank{world.rank}.pt")
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
