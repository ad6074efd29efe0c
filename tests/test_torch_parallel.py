"""Data parallelism of the port (floodseg_tpu_torch/parallel/, the global-batch
steps) on the CPU: two gloo ranks spawned from tests/torch_dist_worker.py,
which rendezvous through ``maybe_initialize_multihost`` on a free localhost
port and import no JAX, against the port's one-rank run in this process and
against the JAX package on a 2-device CPU mesh (conftest.py exposes 8).

- (i) For each method (``supervised``; ``flow_supervised``'s interpolated,
  plain and interpolated steps; ``gan``; ``flow_gan``; ``contrastive``'s
  sup step, the sync and two semi steps, ``num_devices`` 2 on both sides),
  two steps on the float64 ``TinySegNet`` (synchronised BN, channel and
  element dropout, aux and rep heads) with each rank on its half of a
  global batch of 4 end with the state of the one-rank steps on the whole
  batch: every parameter, BN statistic, optimizer state, discriminator,
  teacher and memory-bank key within 1e-10 of its tensor's largest
  magnitude, the integer counts (metric counts, ``st_count``, the bank's
  counts and pointers) equal, the losses within 1e-10 relative. The two
  ranks end bit-equal. Also ``run_flow_fit`` (two epochs, validation),
  ``run_validate`` and ``run_test`` of the float64 narrow ViT over the two
  ranks, each loading its share, against one rank with the doubled batch,
  and the CLI's single-frame ``fit`` (checkpoints, restore_best, the
  test; rank 0 alone writes) the same way; ``trainer.num_devices`` below the
  world raises.
- The contrastive loss is divided by ``num_devices`` (the world's size in
  a run): the one-rank semi step with 2 gives half the one with 1.
- (ii) ``supervised`` and the contrastive semi step of the float64 narrow
  ViT (dropout 0) over the two ranks against the JAX package's steps under
  ``sharded_jit`` on a 2-device mesh with the state replicated, by the
  one-device tests' tolerances: losses within rtol 1e-8 (the contrastive
  and total loss 2e-6: JAX computes the cosine logits in float32), every
  parameter within 1e-7 of its tensor's largest magnitude, counts equal;
  the semi step's draws are JAX's (``JaxDraws``), recorded in the port's
  one-rank step and replayed on the ranks.
- (iii) ``shard_batch`` gives each rank the rows the JAX ``shard_batch``
  puts on its device, the time-major grids split on their second dim.
- (iv) The DP crop forward (3 crops, padded to 4) against the JAX
  ``make_crop_forward(mesh=...)`` within 1e-4 (tests/test_torch_evaluate.py's
  tolerance), and DP predict (two windows, then a ragged remainder of one)
  equal to the port's one-rank predict window by window and on at least
  99% of the pixels to the JAX ``make_dp_predict_fn`` (float32 narrow ViT;
  a pixel whose two best logits are within float32 rounding may differ);
  ``run_flow_predict``'s whole-frame route over the ranks gives one rank's
  summary and PNGs, byte for byte.
- (v) A half-configured FLOODSEG_COORDINATOR launch raises naming what is
  missing; without FLOODSEG_MULTIHOST nothing initializes.
- (vi) A world of one launches no collective: every train step and the DP
  wrappers run with ``torch.distributed``'s collectives patched to raise.
"""

import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from floodseg_tpu.models.vit import SegmenterViT as JaxSegmenterViT
from floodseg_tpu.parallel import create_mesh, make_sharded_train_step, replicated_sharding
from floodseg_tpu.parallel import shard_batch as jax_shard_batch
from floodseg_tpu.parallel.mesh import make_dp_predict_fn as jax_make_dp_predict_fn
from floodseg_tpu.parallel.mesh import sharded_jit
from floodseg_tpu.train import contrastive as jcon
from floodseg_tpu.train import supervised as jsup
from floodseg_tpu.train.evaluate import make_crop_forward as jax_make_crop_forward
from floodseg_tpu.train.flow import make_flow_predict_fn as jax_make_flow_predict_fn
from floodseg_tpu.train.optim import make_optimizer as jax_make_optimizer
from floodseg_tpu.train.state import TrainState as JaxTrainState

from floodseg_tpu_torch.data import generate_synthetic_dataset
from floodseg_tpu_torch.parallel import World, maybe_initialize_multihost, shard_batch
from floodseg_tpu_torch.video import default_grid

import torch_dist_worker as worker
from torch_port_fixtures import (
    jnorm,
    numpy_leaves,
    port_state,
    smooth_grids,
    vit_pair,
    write_ade_tree,
)
from torch_u2pl_fixtures import JaxDraws

WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_dist_worker.py")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANKS, GLOBAL_B, STEPS = 2, 4, 2
C, S, T = worker.CLASSES, worker.SIZE, worker.T
REL = 1e-10
VIT = dict(image_size=64, patch_size=32, d_model=64, n_layers=1, dec_layers=1, n_heads=2)
VIT_B, VIT_SIZE = 2, 64
JAX_REL, JAX_LOSS, JAX_F32_LOSS = 1e-7, 1e-8, 2e-6
TRAIN_METHODS = ("supervised", "flow_supervised", "gan", "flow_gan", "contrastive")
INT_KEYS = ("intersection", "union", "target", "st_count", "bank.counts", "bank.ptrs")


# ---------------------------------------------------------------- the cases

def _labels(rng, b, size):
    labels = rng.integers(0, C, (b, size, size))
    return np.where(rng.random(labels.shape) < 0.05, 255, labels).astype(np.int32)


def _frames(rng, b, size):
    return rng.standard_normal((b, size, size, 3))


def _flow(rng, b):
    base = np.stack(np.meshgrid(np.linspace(-1, 1, S), np.linspace(-1, 1, S)), -1)

    def grids():
        return (base[None, None] + rng.uniform(-0.1, 0.1, (T, b, S, S, 2))).astype(np.float32)

    return {"frame_prev": _frames(rng, b, S), "frame_next": _frames(rng, b, S),
            "frame_current": _frames(rng, b, S), "mvs_left": grids(), "mvs_right": grids(),
            "left_index": rng.integers(0, T + 1, b).astype(np.int32),
            "right_index": rng.integers(1, T + 1, b).astype(np.int32)}


def _tiny_batches(method, rng):
    b = GLOBAL_B
    if method in ("supervised", "flow_supervised"):
        return [{**_flow(rng, b), "label": _labels(rng, b, S)} for _ in range(3)]
    if method in ("gan", "flow_gan"):
        def role(labels):
            r = _flow(rng, b) if method == "flow_gan" else {"frame_current": _frames(rng, b, S)}
            return {**r, "label": labels}
        return [{"l": role(_labels(rng, b, S)), "u": role(np.zeros((b, S, S), np.int32)),
                 "gt": role(_labels(rng, b, S))} for _ in range(STEPS)]
    return [{"l": {"frame_current": _frames(rng, b, S), "label": _labels(rng, b, S)},
             "u": {"frame_current": _frames(rng, b, S)}} for _ in range(3)]


def tiny_case(method, num_devices=RANKS):
    case = {"method": method, "seed": 3,
            "batches": _tiny_batches(method, np.random.default_rng(TRAIN_METHODS.index(method)))}
    if method == "flow_supervised":
        case["kinds"] = ("interp", "plain", "interp")
    if method == "contrastive":
        case.update(kinds=("sup", "semi", "semi"), num_devices=num_devices)
    return case


def _vit_variables(rep, seed):
    jm = JaxSegmenterViT(classes=C, dropout=0.0, with_rep=rep, dtype=jnp.float64, **VIT)
    k = jax.random.PRNGKey(0)
    with jax.enable_x64(True):
        shapes = jax.eval_shape(lambda: jm.init({"params": k, "dropout": k},
                                                jnp.zeros((VIT_B, VIT_SIZE, VIT_SIZE, 3)),
                                                train=rep))
    return jm, {"params": numpy_leaves(shapes["params"], np.random.default_rng(seed))}


def _vit_batches(rng, semi):
    if semi:
        return [{"l": {"frame_current": _frames(rng, VIT_B, VIT_SIZE).astype(np.float32),
                       "label": _labels(rng, VIT_B, VIT_SIZE)},
                 "u": {"frame_current": _frames(rng, VIT_B, VIT_SIZE).astype(np.float32)}}]
    return [{"frame_current": _frames(rng, VIT_B, VIT_SIZE).astype(np.float32),
             "label": _labels(rng, VIT_B, VIT_SIZE)} for _ in range(STEPS)]


class RecordingDraws:
    """``JaxDraws`` whose every draw is kept as (method, value), in call
    order, for ``torch_dist_worker.ReplayDraws``."""

    def __init__(self, draws):
        self.inner, self.record = draws, []

    def __getattr__(self, name):
        fn = getattr(self.inner, name)

        def call(*args):
            value = fn(*args)
            self.record.append((name, value))
            return value
        return call


@pytest.fixture(scope="module")
def vit_cases():
    """The JAX comparisons' cases: the supervised ViT (2 steps) and the
    contrastive semi step (teacher synced), their JAX variables and the
    semi step's JAX draws recorded in the port's one-rank step."""
    jm_sup, v_sup = _vit_variables(False, 40)
    jm_semi, v_semi = _vit_variables(True, 41)
    _, v_teacher = _vit_variables(True, 42)
    rng = np.random.default_rng(43)
    common = dict(config=VIT, head_lr_scale=10.0, aux_weight=0.0)
    sup = dict(method="sup_vit", batches=_vit_batches(rng, False),
               state_dict=port_state(v_sup), **common)
    semi = dict(method="semi_vit", batches=_vit_batches(rng, True), kinds=("semi",),
                num_devices=1, state_dict=port_state(v_semi),
                teacher_state_dict=port_state(v_teacher), **common)
    key = jax.random.PRNGKey(44)
    with jax.enable_x64(True):
        rec = RecordingDraws(JaxDraws.of_step(key, batch=VIT_B, classes=C))
        one_rank = worker.run_case({**semi, "draws": [rec]}, World())
    semi["draws"] = [rec.record]
    return dict(sup=sup, semi=semi, jm_sup=jm_sup, v_sup=v_sup, jm_semi=jm_semi,
                v_semi=v_semi, v_teacher=v_teacher, semi_key=key, semi_one_rank=one_rank)


@pytest.fixture(scope="module")
def inference_cases():
    """The float32 narrow ViT, three crops, and two windows plus one."""
    jm, variables, port = vit_pair(size=VIT_SIZE, **{k: VIT[k] for k in (
        "patch_size", "d_model", "n_layers", "dec_layers", "n_heads")})
    rng = np.random.default_rng(50)
    crops = rng.uniform(0, 255, (3, VIT_SIZE, VIT_SIZE, 3)).astype(np.float32)
    n, gh = 3, VIT_SIZE // 16

    def clips(k):
        frames = {key: rng.integers(0, 256, (k, VIT_SIZE, VIT_SIZE, 3), dtype=np.uint8)
                  for key in ("frame_prev", "frame_next")}
        grids = {key: np.concatenate([smooth_grids(rng, n - 1, gh, gh) for _ in range(k)], 1)
                 for key in ("mvs_left", "mvs_right")}
        return {**frames, **grids}

    common = dict(config=VIT, state_dict=port.state_dict())
    predict = dict(method="predict", n=n, out_size=(VIT_SIZE, VIT_SIZE),
                   default_grid=default_grid(VIT_SIZE, VIT_SIZE),
                   clips={"full": clips(RANKS), "remainder": clips(1)}, **common)
    return dict(jm=jm, variables=variables, crop=dict(method="crop_forward", crops=crops,
                                                      **common), predict=predict)


FIT_CFG = dict(train_h=64, train_w=64, resize_h=128, resize_w=160, frame_delta=5, max_epochs=2,
               limit_train_batches=2, batch_size_val=1, batch_size_test=1, workers=1,
               workers_test=1)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return generate_synthetic_dataset(str(tmp_path_factory.mktemp("dp_tree")), num_frames=30,
                                      frame_delta=5, size=(128, 160), num_labeled=8)


@pytest.fixture(scope="module")
def fit_case(tree):
    return dict(method="fit", root=tree, seed=5, config=VIT, cfg=dict(FIT_CFG, batch_size=1))


def cli_argv(tree, log_dir, batch):
    """``fit`` of the single-frame supervised method from the repository's
    configs, cut to 2 epochs of 2 steps at 64 px crops of the 128x160
    tree (the flow methods' predict runs K1, which takes no float64)."""
    configs = ("train_base", "train_supervised", "dataset_flow", "vit")
    out = ["fit"] + [a for c in configs for a in ("--config", os.path.join(REPO, "configs",
                                                                           f"{c}.yaml"))]
    return out + ["--device", "cpu", "--data.data_root", tree, "--data.train_w", "64",
                  "--data.resize_h", "128", "--data.resize_w", "160", "--data.frame_delta", "5",
                  "--data.predict_v_id", "synth", "--data.batch_size", str(batch),
                  "--data.workers", "1", "--data.workers_test", "1",
                  "--trainer.max_epochs", "2", "--trainer.limit_train_batches", "2",
                  "--trainer.limit_test_batches", "1", "--trainer.log_dir", log_dir,
                  "--trainer.run_name", "dp", "--model.save_video", "false",
                  "--model.test_base_size", "128", "--model.pretrained", "false"]


@pytest.fixture(scope="module")
def cli_case(tree, tmp_path_factory):
    return dict(method="cli", seed=6, config=VIT,
                argv=cli_argv(tree, str(tmp_path_factory.mktemp("dp_cli")), 1))


def segm_argv(tree, log_dir, batch):
    """``segm.train`` on an ADE20K-layout tree (4 training images, 2
    validation ones): one epoch of 2 steps at 64 px crops and its
    evaluation, one image a rank."""
    return ["--log-dir", log_dir, "--dataset", "ade20k", "--data-root", tree, "--im-size", "64",
            "--patch-size", "32", "--d-model", "64", "--n-layers", "1", "--dec-layers", "1",
            "--batch-size", str(batch), "--epochs", "1", "--workers", "1"]


@pytest.fixture(scope="module")
def segm_case(tmp_path_factory):
    tree = write_ade_tree(str(tmp_path_factory.mktemp("dp_ade")))
    return dict(method="segm", seed=8, tree=tree,
                argv=segm_argv(tree, str(tmp_path_factory.mktemp("dp_segm")), 1))


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def launch(tmp_path, task, timeout=600):
    """Run ``task`` on two ranks; each rank's results."""
    path, prefix = str(tmp_path / "task.pt"), str(tmp_path / "out")
    torch.save(task, path)
    env = {**os.environ, "FLOODSEG_MULTIHOST": "1",
           "FLOODSEG_COORDINATOR": f"localhost:{_free_port()}",
           "FLOODSEG_NUM_PROCESSES": str(RANKS), "OMP_NUM_THREADS": "2"}
    procs = [subprocess.Popen([sys.executable, WORKER, path, prefix],
                              env={**env, "FLOODSEG_PROCESS_ID": str(r)},
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(RANKS)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{out[-4000:]}"
    return [torch.load(f"{prefix}.rank{r}.pt", weights_only=False) for r in range(RANKS)]


@pytest.fixture(scope="module")
def flow_predict_case(tree, inference_cases, tmp_path_factory):
    return dict(method="flow_predict", root=tree, resize=(128, 160), config=VIT,
                state_dict=inference_cases["predict"]["state_dict"],
                png_dir=str(tmp_path_factory.mktemp("dp_pngs")))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, vit_cases, inference_cases, fit_case, cli_case, flow_predict_case,
          segm_case):
    """Every case on two ranks, in one launch."""
    task = {m: tiny_case(m) for m in TRAIN_METHODS}
    task.update({f"supervised_remat_{r}": dict(tiny_case("supervised"), remat=r)
                 for r in (False, True)})
    task.update(sup_vit=vit_cases["sup"], semi_vit=vit_cases["semi"],
                crop_forward=inference_cases["crop"], predict=inference_cases["predict"],
                fit=fit_case, cli=cli_case, flow_predict=flow_predict_case, segm=segm_case)
    return launch(tmp_path_factory.mktemp("ranks"), task)


# ----------------------------------------------------------------- checks

def _assert_close(ours, ref, rel, what):
    assert ours.keys() == ref.keys(), (what, sorted(set(ours) ^ set(ref)))
    for k in ref:
        a, b = ours[k], ref[k]
        if not a.is_floating_point() or k.endswith(INT_KEYS):
            assert torch.equal(a.to(b.dtype), b), (what, k)
            continue
        scale = float(b.abs().max()) if b.numel() else 0.0
        torch.testing.assert_close(a, b, rtol=0, atol=rel * max(scale, 1e-300),
                                   msg=f"{what}: {k}")


@pytest.mark.parametrize("case", TRAIN_METHODS + ("sup_vit", "semi_vit", "crop_forward",
                                                  "predict", "fit", "cli", "flow_predict"))
def test_ranks_end_bit_equal(ranks, case):
    a, b = (r[case] for r in ranks)
    assert a.keys() == b.keys()
    for k in a:
        if k != "writes":
            assert torch.equal(a[k], b[k]), (case, k)


@pytest.mark.parametrize("method", TRAIN_METHODS)
def test_d_rank_step_equals_one_rank_step(ranks, method):
    ref = worker.run_case(tiny_case(method), World())
    ours = ranks[0][method]
    _assert_close(ours, ref, REL, method)
    # the step did something: every method moved the model, and BN's
    # running statistics moved
    init = worker.tiny_model(3, rep=method == "contrastive").state_dict()
    moved = [k for k, v in init.items() if not torch.equal(v, ours[f"model.{k}"])]
    assert any(k.endswith("running_var") for k in moved) and any(
        k.endswith("weight") for k in moved)


def test_d_rank_remat_step_equals_plain_step(ranks):
    """A model with a bottleneck, stepped over the ranks with the block
    rematerialised (its BN's all-reduce repeated in the recompute, inside
    the backward) and without: every rank's loss, parameters, BN
    statistics and optimizer state equal bit for bit."""
    for r in ranks:
        plain, remat = r["supervised_remat_False"], r["supervised_remat_True"]
        assert plain.keys() == remat.keys()
        assert any(k.startswith("model.stem.4.bn3.running") for k in plain)
        for k in plain:
            assert torch.equal(plain[k], remat[k]), k


def test_d_rank_fit_test_and_validate_equal_one_rank(ranks, fit_case):
    ref = worker.run_case(dict(fit_case, cfg=dict(FIT_CFG, batch_size=RANKS)), World())
    _assert_close(ranks[0]["fit"], ref, REL, "fit")
    assert "epoch1.val_miou" in ref and "test.test_miou_epoch" in ref


def test_cli_fit_over_ranks_equals_one_rank(ranks, tree, cli_case, tmp_path):
    """The CLI's ``fit`` (epochs, checkpoints, restore_best, the
    multi-scale test with each frame's crops shared out) on two ranks of
    batch 1 ends with the state and the summary of one rank of batch 2;
    rank 0 alone wrote metrics.json and the checkpoints."""
    ref = worker.run_case(dict(method="cli", seed=6, config=VIT,
                               argv=cli_argv(tree, str(tmp_path), RANKS)), World())
    assert [bool(r["cli"]["writes"]) for r in ranks] == [True, False]
    run_dir = os.path.join(cli_case["argv"][cli_case["argv"].index("--trainer.log_dir") + 1],
                           "dp")
    for name in ("metrics.json", "metrics.jsonl", "early_stop.json", "checkpoints/last"):
        assert os.path.exists(os.path.join(run_dir, name)), name
    _assert_close(ranks[0]["cli"], ref, REL, "cli")
    assert "summary.test_miou_epoch" in ref and "summary.best_val_miou" in ref


def test_segm_train_over_ranks_equals_one_rank(ranks, segm_case, tmp_path):
    """The standalone Segmenter trainer on two ranks of batch 1 (the
    evaluation's images shared out) ends with the weights and log.txt of
    one rank of batch 2; both ranks end equal."""
    ref = worker.run_case(dict(segm_case, argv=segm_argv(segm_case["tree"], str(tmp_path),
                                                         RANKS)), World())
    a, b = ranks[0]["segm"], ranks[1]["segm"]
    assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
    assert "epoch0.val_mean_iou" in ref and "epoch0.train_loss" in ref
    _assert_close(a, ref, REL, "segm")


def test_run_flow_predict_over_ranks_equals_one_rank(ranks, flow_predict_case, tmp_path):
    """``run_flow_predict`` on the whole-frame route, one window a rank,
    gives one rank's (cached) route's summary, and rank 0 wrote the same
    PNGs byte for byte."""
    ref = worker.run_case(dict(flow_predict_case, png_dir=str(tmp_path)), World())
    _assert_close(ranks[0]["flow_predict"], ref, REL, "flow_predict")
    names = sorted(os.listdir(tmp_path))
    assert names and sorted(os.listdir(flow_predict_case["png_dir"])) == names
    for n in names:
        with open(tmp_path / n, "rb") as a, \
                open(os.path.join(flow_predict_case["png_dir"], n), "rb") as b:
            assert a.read() == b.read(), n


def test_num_devices_below_the_world_raises(tmp_path):
    from floodseg_tpu_torch.cli.runner import Runner
    from floodseg_tpu_torch.core.config import load_config
    from floodseg_tpu_torch.parallel import resolve_num_devices
    assert resolve_num_devices(None, World(0, 2)) == 2
    assert resolve_num_devices(4, World(1, 2)) == 2
    assert resolve_num_devices(2, World()) == 1  # min(n, size), as the JAX Runner reads it
    with pytest.raises(ValueError, match="every launched rank takes part"):
        resolve_num_devices(1, World(0, 2))
    cfg = load_config([], {"trainer.num_devices": "1", "trainer.log_dir": str(tmp_path),
                           "model.arch": "vit"})
    with pytest.raises(ValueError, match="below the world of 2 ranks"):
        Runner(cfg, device="cpu", world=World(0, 2))


def test_contrastive_loss_divided_by_world_size():
    """From the same state (the sup step does not read num_devices), the
    first semi step's contrastive loss with 2 is half the one with 1."""
    one, two = (worker.run_case(tiny_case("contrastive", d), World()) for d in (1, 2))
    assert torch.equal(one["m0.loss"], two["m0.loss"])
    assert torch.equal(one["m1.sup_loss"], two["m1.sup_loss"])
    c1, c2 = one["m1.contra_loss"], two["m1.contra_loss"]
    assert float(c1) > 0
    assert torch.equal(c1 / 2, c2)


# ------------------------------------------------------ against JAX's mesh

@pytest.fixture(scope="module")
def mesh():
    return create_mesh(("data",), devices=jax.devices()[:RANKS])


def _jax_to_port(params):
    return {k: v for k, v in port_state({"params": jax.device_get(params)}).items()}


def test_supervised_ranks_match_jax_sharded_step(ranks, vit_cases, mesh):
    case, jm = vit_cases["sup"], vit_cases["jm_sup"]
    with jax.enable_x64(True):
        tx = jax_make_optimizer(1e-2, 10)
        params = jax.tree.map(jnp.asarray, vit_cases["v_sup"]["params"])
        st = JaxTrainState(step=jnp.zeros((), jnp.int32), params=params, batch_stats={},
                           opt_state=tx.init(params), tx=tx)
        step = make_sharded_train_step(
            jsup.make_train_step(jm, jsup.make_loss_fn("ohem", 0.0, 255, 0.7, 50), C, 255), mesh)
        st = jax.device_put(st, replicated_sharding(mesh))
        ref = []
        for i, b in enumerate(case["batches"]):
            st, m = step(st, jax_shard_batch(b, mesh), jax.random.PRNGKey(i))
            ref.append({k: np.asarray(v) for k, v in m.items()})
        params = _jax_to_port(st.params)
    ours = ranks[0]["sup_vit"]
    for i, m in enumerate(ref):
        np.testing.assert_allclose(float(ours[f"m{i}.loss"]), float(m["loss"]), rtol=JAX_LOSS)
        for k in ("intersection", "union", "target"):
            np.testing.assert_array_equal(ours[f"m{i}.{k}"].numpy(), m[k])
    _assert_close({k: ours[f"model.{k}"] for k in params}, params, JAX_REL, "sup_vit")


def test_contrastive_ranks_match_jax_sharded_semi_step(ranks, vit_cases, mesh):
    case, jm = vit_cases["semi"], vit_cases["jm_semi"]
    with jax.enable_x64(True):
        tx = jax_make_optimizer(1e-2, 10)
        params = jax.tree.map(jnp.asarray, vit_cases["v_semi"]["params"])
        st = JaxTrainState(step=jnp.zeros((), jnp.int32), params=params, batch_stats={},
                           opt_state=tx.init(params), tx=tx)
        jcfg = jcon.ContrastiveConfig(**{k: worker.CCFG[k] for k in worker.CCFG},
                                      num_devices=1)
        state = jcon.U2PLState(
            student=st, teacher_params=jax.tree.map(jnp.asarray,
                                                    vit_cases["v_teacher"]["params"]),
            teacher_batch_stats={},
            bank=jcon.create_memory_bank(C, 256, worker.CAPS["bank_capacity"],
                                         worker.CAPS["bank_class0_capacity"]),
            teacher_synced=jnp.asarray(False))
        state = jcon.sync_teacher(state)
        _, semi = jcon.make_u2pl_steps(jm, C, jcfg, 255, 0.0, 0.7, 50)
        b = case["batches"][0]
        state, m = sharded_jit(semi, mesh)(
            jax.device_put(state, replicated_sharding(mesh)),
            {r: jax_shard_batch(v, mesh) for r, v in b.items()}, vit_cases["semi_key"],
            jnp.float32(0.5), jnp.int32(0))
        m = {k: np.asarray(v) for k, v in m.items()}
        params = _jax_to_port(state.student.params)
        counts, ptrs, keys = (np.asarray(v) for v in (state.bank.counts, state.bank.ptrs,
                                                       state.bank.keys))
    ours = ranks[0]["semi_vit"]
    for k, rtol in (("sup_loss", JAX_LOSS), ("unsup_loss", JAX_LOSS),
                    ("contra_loss", JAX_F32_LOSS), ("loss", JAX_F32_LOSS)):
        np.testing.assert_allclose(float(ours[f"m0.{k}"]), float(m[k]), rtol=rtol, err_msg=k)
    for k in ("intersection", "union", "target"):
        np.testing.assert_array_equal(ours[f"m0.{k}"].numpy(), m[k])
    np.testing.assert_array_equal(ours["bank.counts"].numpy(), counts)
    np.testing.assert_array_equal(ours["bank.ptrs"].numpy(), ptrs)
    np.testing.assert_allclose(ours["bank.keys"].numpy(), keys, rtol=0,
                               atol=REL * np.abs(keys).max())
    _assert_close({k: ours[f"model.{k}"] for k in params}, params, JAX_REL, "semi_vit")
    # and the ranks equal the port's one-rank step on the global batch
    _assert_close(ours, vit_cases["semi_one_rank"], REL, "semi_vit one rank")


def test_shard_batch_matches_jax_layouts(mesh):
    rng = np.random.default_rng(60)
    batch = {"frame_prev": rng.standard_normal((4, 8, 8, 3)).astype(np.float32),
             "mvs_left": rng.standard_normal((3, 4, 2, 2, 2)).astype(np.float32),
             "left_index": np.arange(4, dtype=np.int32)}
    ref = jax_shard_batch(batch, mesh)
    for r in range(RANKS):
        ours = shard_batch(batch, World(r, RANKS))
        for k, v in ref.items():
            shard = next(s for s in v.addressable_shards if s.device == mesh.devices[r])
            np.testing.assert_array_equal(ours[k], np.asarray(shard.data))
    assert shard_batch(batch, World()) is not batch
    assert all(shard_batch(batch, World())[k] is v for k, v in batch.items())


def test_dp_crop_forward_matches_jax(ranks, inference_cases, mesh):
    jm, variables = inference_cases["jm"], inference_cases["variables"]
    crops = inference_cases["crop"]["crops"]
    ref = np.asarray(jax_make_crop_forward(jm, C, flip=True, mesh=mesh)(variables, crops))
    ours = ranks[0]["crop_forward"]["probs"].numpy()
    assert ours.shape == ref.shape == (3, VIT_SIZE, VIT_SIZE, C)
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-4)
    one = worker.run_case(inference_cases["crop"], World())["probs"].numpy()
    np.testing.assert_allclose(ours, one, rtol=0, atol=1e-6)


def test_dp_predict_matches_jax_and_one_rank(ranks, inference_cases, mesh):
    case = inference_cases["predict"]
    jm, variables = inference_cases["jm"], inference_cases["variables"]
    n, out_size, dg = case["n"], case["out_size"], case["default_grid"]
    single = jax_make_flow_predict_fn(jm, n=n, out_size=out_size, default_grid=dg)
    dp = jax_make_dp_predict_fn(single, mesh)
    one = worker.run_case(case, World())
    for name, k in (("full", RANKS), ("remainder", 1)):
        c = case["clips"][name]
        norm = [jnorm(c[key]) for key in ("frame_prev", "frame_next")]
        if k == RANKS:
            ref = np.asarray(dp(variables, *norm, c["mvs_left"], c["mvs_right"]))
            ref = ref.reshape((-1,) + ref.shape[2:])
        else:
            ref = np.asarray(single(variables, *norm, c["mvs_left"], c["mvs_right"]))
        ours = ranks[0]["predict"][name].numpy()
        assert ours.shape == ref.shape == (k * n,) + out_size
        np.testing.assert_array_equal(ours, one[name].numpy())
        assert (ours == ref).mean() > 0.99


# ------------------------------------------------- rendezvous, world of one

def test_half_configured_rendezvous_raises():
    base = {"FLOODSEG_MULTIHOST": "1", "FLOODSEG_COORDINATOR": "localhost:1"}
    with pytest.raises(RuntimeError, match="FLOODSEG_NUM_PROCESSES, FLOODSEG_PROCESS_ID"):
        maybe_initialize_multihost(base, device="cpu")
    with pytest.raises(RuntimeError, match="FLOODSEG_PROCESS_ID is not"):
        maybe_initialize_multihost({**base, "FLOODSEG_NUM_PROCESSES": "2"}, device="cpu")
    assert maybe_initialize_multihost({}, device="cpu") is False
    assert not dist.is_initialized()


def test_world_of_one_launches_no_collective(monkeypatch, inference_cases):
    def refuse(*args, **kwargs):
        raise AssertionError("a world of one launched a collective")

    for name in ("all_reduce", "all_gather", "all_gather_into_tensor", "barrier", "broadcast"):
        monkeypatch.setattr(dist, name, refuse)
    for method in TRAIN_METHODS:
        assert worker.run_case(tiny_case(method), World(0, 1))
    assert worker.run_case(inference_cases["crop"], World(0, 1))
    assert worker.run_case(inference_cases["predict"], World(0, 1))
