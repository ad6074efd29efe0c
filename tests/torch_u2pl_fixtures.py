"""Shared set-up of the U2PL parity tests (tests/test_torch_u2pl_*.py).

``JaxDraws`` is the port's draws object (ops/u2pl.py::U2PLDraws) replaying
the JAX step's keys: a semi step's key splits into (r_aug, r_coin, r_s,
r_t, r_contra); the augmentation splits r_aug into one key a sample and
each sample's into three (bw, x0, y0), or uses it whole for the class-mix
scores; the contrastive loss splits r_contra into three keys a class
(subset scores, anchors, negatives). Each method calls the JAX function
the JAX step calls with its key, on the port's mask or count, so both
packages draw the same values.

The step and fit tests' model: the narrow Segmenter ViT of
tests/torch_gan_fixtures.py (``CONFIG``: d = 128, 2 heads, 2 + 2 layers,
patch 32, 64 px) with its U2PL rep head (a 1-layer MaskTransformer with
256 classes), float64, the student's and the teacher's weights drawn in
numpy in the init's shapes (two seeds: the teacher has its own init); the
JAX steps (``make_u2pl_steps``: sup, semi, and semi with ``true_ema``)
jitted once a process under ``jax.enable_x64``; flax's dropout masks
recorded by module path and the port's module names of every Dropout.
"""

import functools
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import torch

from floodseg_tpu.ops import u2pl as ju2pl
from floodseg_tpu.models.vit import SegmenterViT as JaxSegmenterViT
from floodseg_tpu.train import contrastive as jcon
from floodseg_tpu.train import supervised as jsup
from floodseg_tpu.train.optim import make_optimizer as jax_make_optimizer
from floodseg_tpu.train.state import TrainState as JaxTrainState

from floodseg_tpu_torch.models import SegmenterViT, with_rep
from floodseg_tpu_torch.train import ContrastiveConfig, create_u2pl_state, make_optimizer

from torch_port_fixtures import flax_keep_masks_fn, numpy_leaves, port_state, vit_mask_names

SIZE, B, CLASSES = 64, 2, 5
CONFIG = dict(image_size=SIZE, patch_size=32, d_model=128, n_layers=2, dec_layers=2,
              n_heads=2)
LR, MAX_ITER = 1e-3, 8
# the caps wrap within the trajectory's semi steps (the narrow ViT's negatives
# are few: the unlabeled pixels where the pseudo-label's class ranks 3rd or
# lower, which the cutmix makes); max_enqueue below them
CCFG = ContrastiveConfig(num_queries=16, num_negatives=8, max_enqueue=16)
CAPS = dict(bank_capacity=24, bank_class0_capacity=32)
NAMES = {**{k: f"model.model.{v}" for k, v in vit_mask_names(CONFIG["n_layers"],
                                                           CONFIG["dec_layers"]).items()},
         **{f"rep/block0/{site}": f"rep.rep_model.blocks.0.{port}" for site, port in (
             ("attn/Dropout_0", "attn.attn_drop"), ("attn/Dropout_1", "attn.proj_drop"),
             ("mlp/Dropout_0", "mlp.drop1"), ("mlp/Dropout_1", "mlp.drop2"))}}
METRICS = ("loss", "sup_loss", "unsup_loss", "contra_loss")
COUNTS = ("intersection", "union", "target")


def t(a):
    return torch.from_numpy(np.array(a))


class JaxDraws:
    """ops/u2pl.py::U2PLDraws drawn with the JAX step's keys (see the
    module note); ``batch`` samples and ``classes`` classes. Run it under
    ``jax.enable_x64`` as the JAX step ran: the draws' dtypes follow it."""

    def __init__(self, r_aug, r_coin, r_contra, batch: int, classes: int):
        self.r_coin = r_coin
        self.aug = None if r_aug is None else jax.random.split(r_aug, batch)
        self.contra = jax.random.split(r_contra, classes * 3).reshape(classes, 3, -1)

    @classmethod
    def of_step(cls, key, batch=B, classes=CLASSES):
        r_aug, r_coin, _, _, r_contra = jax.random.split(key, 5)
        return cls(r_aug, r_coin, r_contra, batch, classes)

    def coin(self):
        return t(jax.random.uniform(self.r_coin))

    def box(self, i, h, w, ratio=2.0):
        r_w, r_x, r_y = jax.random.split(self.aug[i], 3)
        bw = jax.random.randint(r_w, (), int(w / ratio) + 1, w)
        bh = jnp.round(h * w / ratio / bw).astype(jnp.int32)
        x0 = jax.random.randint(r_x, (), 0, jnp.maximum(w - bw + 1, 1))
        y0 = jax.random.randint(r_y, (), 0, jnp.maximum(h - bh + 1, 1))
        return tuple(t(v).long() for v in (bw, x0, y0))

    def class_scores(self, i, num_classes):
        return t(jax.random.uniform(self.aug[i], (num_classes,)))

    def subset_scores(self, c, size):
        return t(jax.random.uniform(self.contra[c, 0], (size,)))

    def choice(self, c, mask_flat, n):
        return t(ju2pl.masked_choice(self.contra[c, 1], jnp.asarray(mask_flat.numpy()), n)).long()

    def negatives(self, c, count, n):
        top = jnp.maximum(jnp.asarray(int(count), jnp.int32), 1)
        return t(jax.random.randint(self.contra[c, 2], (n,), 0, top)).long()


def jax_model(dropout=0.1):
    return JaxSegmenterViT(classes=CLASSES, dropout=dropout, with_rep=True, dtype=jnp.float64,
                           **CONFIG)


@functools.lru_cache(maxsize=None)
def weights(seed):
    """Float64 variables of the ViT with its rep head in the init's shapes
    (``numpy_leaves``; drawn in numpy, so no init compiles)."""
    k = jax.random.PRNGKey(0)
    with jax.enable_x64(True):
        shapes = jax.eval_shape(lambda: jax_model().init(
            {"params": k, "dropout": k}, jnp.zeros((B, SIZE, SIZE, 3)), train=True))
    return {"params": numpy_leaves(shapes["params"], np.random.default_rng(seed))}


def port_model(v):
    m = with_rep(SegmenterViT(classes=CLASSES, dropout=0.1, dtype=torch.float64, **CONFIG),
                 torch.float64).double()
    m.load_state_dict(port_state(v))
    return m


def port_params(module):
    return {k: v.detach().numpy().copy() for k, v in module.state_dict().items()}


def jax_params(tree):
    return {k: v.numpy() for k, v in port_state({"params": tree}).items()}


@functools.lru_cache(maxsize=None)
def oracle():
    """The JAX side, made once a process: the flax model, the optimizer as
    ``_build_states_and_steps`` makes it (one object: a state's ``tx`` is
    part of jit's cache key), the jitted sup, semi and true-EMA semi steps
    (no aux head: aux_weight 0) for a schedule of ``max_iter`` steps
    (``steps(max_iter)``), the eval step, and the mask recorders of a
    labeled batch and of a joint one.

    ``max_iter`` enters the jitted steps as a traced int32, so that the
    trajectory's 8-step schedule and the fit's 4-step one share one
    compile of each step: inside, the student's optimizer is
    ``make_optimizer(LR, max_iter)`` made on it, whose poly schedule
    computes ``minimum(count, max_iter) / max_iter`` in the dtypes a Python
    int gives it (int32 in, float32 out), so each learning rate is the one
    a constant ``max_iter`` gives; the state carries ``tx`` in and out."""
    jm = jax_model()
    tx = jax_make_optimizer(LR, MAX_ITER)
    jcfg = jcon.ContrastiveConfig(**{k: getattr(CCFG, k) for k in (
        "num_queries", "num_negatives", "max_enqueue")})
    sup, semi = jcon.make_u2pl_steps(jm, CLASSES, jcfg, 255, 0.0)
    _, semi_ema = jcon.make_u2pl_steps(jm, CLASSES, jcfg, 255, 0.0, true_ema=True)

    def scheduled(step):
        def run(max_iter, state, *args):
            student = state.student.replace(tx=jax_make_optimizer(LR, max_iter))
            new, metrics = step(state._replace(student=student), *args)
            return new._replace(student=new.student.replace(tx=tx)), metrics

        return jax.jit(run)

    jitted = {"sup": scheduled(sup), "semi": scheduled(semi), "semi_ema": scheduled(semi_ema)}

    def steps(max_iter):
        m = jnp.int32(max_iter)
        return SimpleNamespace(**{k: functools.partial(f, m) for k, f in jitted.items()})

    frames = np.zeros((B, SIZE, SIZE, 3))
    return SimpleNamespace(
        jm=jm, tx=tx, steps=steps, ev=jax.jit(jsup.make_eval_step(jm, CLASSES, 255)),
        rec_l=flax_keep_masks_fn(jm, frames),
        rec_all=flax_keep_masks_fn(jm, np.zeros((2 * B, SIZE, SIZE, 3))))


def jax_state(o, student, teacher):
    params = jax.tree.map(jnp.asarray, student["params"])
    st = JaxTrainState(step=jnp.zeros((), jnp.int32), params=params, batch_stats={},
                       opt_state=o.tx.init(params), tx=o.tx)
    return jcon.U2PLState(student=st, teacher_params=jax.tree.map(jnp.asarray,
                                                                  teacher["params"]),
                          teacher_batch_stats={},
                          bank=jcon.create_memory_bank(CLASSES, 256, CAPS["bank_capacity"],
                                                       CAPS["bank_class0_capacity"]),
                          teacher_synced=jnp.asarray(False))


def step_masks(o, student_params, teacher_params, key, semi):
    """The flax masks of one step's calls: the student's (r_s) and the
    teacher's, in call order (a semi step's eval-mode forward draws none)."""
    if semi:
        _, _, r_s, r_t, _ = jax.random.split(key, 5)
        rec = o.rec_all
        teacher = [{}, rec({"params": teacher_params}, r_t)]
    else:
        r_s, r_t = jax.random.split(key)
        rec = o.rec_l
        teacher = [rec({"params": teacher_params}, r_t)]
    return [rec({"params": student_params}, r_s)], teacher


def port_state_of(student, teacher, max_iter=MAX_ITER):
    """The port's U2PLState from the float64 weights: SGD over the trunk
    and head groups, the bank's caps."""
    m, tm = port_model(student), port_model(teacher)
    opt, sched = make_optimizer(m, LR, max_iter)
    return create_u2pl_state(m, opt, sched, tm, num_classes=CLASSES,
                             max_enqueue=CCFG.max_enqueue, **CAPS)


def bank_of(bank):
    """(counts, ptrs, keys) of either package's bank, numpy copies."""
    if hasattr(bank, "buffer"):
        return tuple(v.cpu().numpy().copy() for v in (bank.counts, bank.ptrs, bank.keys))
    return np.asarray(bank.counts), np.asarray(bank.ptrs), np.asarray(bank.keys)
