"""The port's checkpoints (floodseg_tpu_torch/core/checkpoint.py) against
the JAX package's orbax CheckpointManager (floodseg_tpu/core/checkpoint.py),
on the CPU.

Both managers take the same save sequence: metrics present and missing,
save_top_k of 0, -1 and 2, a crash orphan in index.json. They must agree
on the directory listing (the port's files carry ``.pt``), index.json,
best_path, last_epoch, the ``last`` link and ``last`` resolution. Each
method's state (a TrainState, the s4GAN pair, a U2PLState with its bank)
round-trips bit for bit; a resume continues at the next epoch and step
with the early-stopping state of early_stop.json, as
tests/test_cli.py::test_early_stopping_state_survives_resume holds the JAX
Runner to it.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from floodseg_tpu.core.checkpoint import CheckpointManager as JaxManager

from floodseg_tpu_torch.cli.runner import Runner
from floodseg_tpu_torch.core.checkpoint import SUFFIX, CheckpointManager
from floodseg_tpu_torch.core.config import fit_config, load_config
from floodseg_tpu_torch.models import S4GANDiscriminator, SegmenterViT, init_from_generator_
from floodseg_tpu_torch.models import with_rep
from floodseg_tpu_torch.train import enqueue, method_state, sync_teacher
from floodseg_tpu_torch.train.fit import _fit_loop

VIT = dict(image_size=64, patch_size=32, d_model=64, n_layers=1, dec_layers=1, n_heads=2)

# (epoch, metrics) saves: metric None on epochs without validation
SEQUENCE = [(0, {"val_miou_epoch": 0.25}), (1, {}), (2, {"val_miou_epoch": 0.5}),
            (3, {"val_miou_epoch": 0.125}), (4, {"val_miou_epoch": 0.75}), (5, {}),
            (6, {"val_miou_epoch": 0.5})]


def _listing(directory):
    out = {}
    for f in sorted(os.listdir(directory)):
        p = os.path.join(directory, f)
        name = f[:-len(SUFFIX)] if f.endswith(SUFFIX) else f
        out[name] = (os.path.basename(os.readlink(p)).removesuffix(SUFFIX)
                     if os.path.islink(p) else None)
    return out


def _name(path):
    return None if path is None else os.path.basename(path).removesuffix(SUFFIX)


def _agree(ours, ref):
    assert _listing(ours.directory) == _listing(ref.directory)
    with open(os.path.join(ours.directory, "index.json")) as f, \
            open(os.path.join(ref.directory, "index.json")) as g:
        assert json.load(f) == json.load(g)
    assert _name(ours.best_path) == _name(ref.best_path)
    assert ours.last_epoch == ref.last_epoch
    assert _name(ours.last_path) == _name(ref.last_path)


def _tiny_state(value: float):
    model = torch.nn.Linear(2, 2)
    with torch.no_grad():
        model.weight.fill_(value)
    opt = torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9)
    from floodseg_tpu_torch.train import TrainState
    return TrainState(int(value), model, opt, lambda step: 0.1)


@pytest.mark.parametrize("links", [True, False])
def test_top_k_epoch_writes_its_bytes_once(tmp_path, monkeypatch, links):
    """An epoch that enters the top k: its last-{epoch} is a hard link of
    the top-k file, which outlives the link when the next save removes
    it (two saves later, as the crash fallback stays until then); without
    hard links both files are written, with the same state."""
    if not links:
        def refuse(src, dst):
            raise OSError("no hard links here")
        monkeypatch.setattr(os, "link", refuse)
    ours = CheckpointManager(str(tmp_path / "ckpt"), save_top_k=2)
    ours.save(_tiny_state(1.0), 0, {"val_miou_epoch": 0.5})
    top, last = ours.best_path, ours.last_path
    assert os.path.samefile(top, last) is links
    ours.save(_tiny_state(2.0), 1, {})
    ours.save(_tiny_state(3.0), 2, {})
    assert not os.path.exists(last) and ours.best_path == top
    restored = ours.restore(_tiny_state(0.0), top)
    assert restored.step == 1 and torch.equal(restored.model.weight, torch.ones(2, 2))


@pytest.mark.parametrize("top_k", [2, 0, -1])
def test_manager_matches_jax(tmp_path, top_k):
    ours = CheckpointManager(str(tmp_path / "port"), save_top_k=top_k)
    ref = JaxManager(str(tmp_path / "jax"), save_top_k=top_k)
    for epoch, metrics in SEQUENCE:
        ours.save(_tiny_state(epoch), epoch, metrics)
        ref.save({"w": jnp.full((2,), float(epoch))}, epoch, metrics)
        ref.wait()  # the JAX manager writes asynchronously; the port's save is done
        _agree(ours, ref)
        assert os.path.realpath(os.path.join(ours.directory, "last")) == os.path.realpath(
            ours.last_path)
    # the last link resolves to the newest last checkpoint on both
    for m in (ours, ref):
        assert os.path.realpath(os.path.join(m.directory, "last")) == os.path.realpath(
            m.last_path)
    restored = ours.restore(_tiny_state(-1.0), os.path.join(ours.directory, "last"))
    assert restored.step == 6 and bool((restored.model.weight == 6.0).all())
    got = JaxManager(str(tmp_path / "jax")).restore(
        {"w": jnp.zeros((2,))}, os.path.join(ref.directory, "last"))
    assert float(got["w"][0]) == 6.0
    # a crash orphan (an index entry whose file never landed) is dropped by
    # a new manager on both sides
    for m in (ours, ref):
        with open(os.path.join(m.directory, "index.json")) as f:
            index = json.load(f)
        index.append({"name": "epoch=9-val_miou_epoch=0.9900", "epoch": 9, "metric": 0.99})
        with open(os.path.join(m.directory, "index.json"), "w") as f:
            json.dump(index, f, indent=1)
    ours2, ref2 = CheckpointManager(ours.directory, save_top_k=top_k), JaxManager(
        ref.directory, save_top_k=top_k)
    assert ours2._index == ref2._index
    _agree(ours2, ref2)
    assert _name(ours2.best_path) != "epoch=9-val_miou_epoch=0.9900"
    # a stale last link (from an earlier fit) resolves to the newest file
    os.remove(os.path.join(ours.directory, "last"))
    os.symlink("last-0" + SUFFIX, os.path.join(ours.directory, "last"))
    assert ours2.restore(_tiny_state(-1.0), os.path.join(ours.directory, "last")).step == 6


def _vit(seed, rep=False):
    m = SegmenterViT(classes=5, **VIT)
    m = with_rep(m) if rep else m
    return init_from_generator_(m.eval(), torch.Generator().manual_seed(seed))


def _cfg():
    return fit_config(load_config([], {"model.arch": "vit", "data.train_w": "64",
                                       "model.contrastive.bank_capacity": "64",
                                       "model.contrastive.bank_class0_capacity": "96",
                                       "model.contrastive.max_enqueue": "16"}))


def _touch(state, seed):
    """Give every parameter a gradient and take one optimizer step, so the
    optimizer state is not empty."""
    g = torch.Generator().manual_seed(seed)
    for p in state.model.parameters():
        p.grad = torch.randn(p.shape, generator=g)
    state.apply_gradients()


def _flat(state):
    """Every tensor and value of a state, by name."""
    from floodseg_tpu_torch.core.checkpoint import state_payload
    out = {}

    def walk(prefix, v):
        if isinstance(v, dict):
            for k, x in v.items():
                walk(f"{prefix}.{k}", x)
        elif isinstance(v, (list, tuple)):
            for i, x in enumerate(v):
                walk(f"{prefix}[{i}]", x)
        else:
            out[prefix] = v

    walk("", state_payload(state))
    return out


def _bit_equal(a, b):
    fa, fb = _flat(a), _flat(b)
    assert fa.keys() == fb.keys()
    for k in fa:
        x, y = fa[k], fb[k]
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and x.shape == y.shape, k
            assert torch.equal(x.reshape(-1).view(torch.uint8) if x.is_floating_point() else x,
                               y.reshape(-1).view(torch.uint8) if y.is_floating_point() else y), k
        else:
            assert x == y, k


@pytest.mark.parametrize("method", ["flow_supervised", "flow_gan", "contrastive"])
def test_method_state_round_trips_bit_for_bit(tmp_path, method):
    """A TrainState, the s4GAN (generator, discriminator) pair with its Adam,
    and a U2PLState (student, teacher aliased after the sync, the bank with
    keys) saved and restored into a fresh state of other weights."""
    cfg = _cfg()
    rep = method == "contrastive"
    state = method_state(_vit(0, rep), cfg, method, 2, device="cpu")
    for ts in (state if isinstance(state, tuple) else
               [state.student] if rep else [state]):
        _touch(ts, 1)
    if rep:
        sync_teacher(state, alias=True)
        state.teacher_synced = True
        keys = torch.randn((20, 256), generator=torch.Generator().manual_seed(2))
        enqueue(state.bank, 1, keys, torch.arange(20) < 13)
        enqueue(state.bank, 0, keys, torch.ones(20, dtype=torch.bool))
    ckpt = CheckpointManager(str(tmp_path), save_top_k=1)
    ckpt.save(state, 0, {"val_miou_epoch": 0.5})
    fresh = method_state(_vit(7, rep), cfg, method, 2, device="cpu",
                         discriminator=init_from_generator_(
                             S4GANDiscriminator(5), torch.Generator().manual_seed(9)))
    restored = ckpt.restore(fresh, ckpt.best_path)
    assert restored is fresh
    _bit_equal(restored, state)
    if rep:
        assert restored.teacher_synced
        # the aliasing is restored: the teacher's parameters are the student's
        for (_, t), (_, s) in zip(restored.teacher.named_parameters(),
                                  restored.student.model.named_parameters()):
            assert t is s
        assert int(restored.bank.counts[1]) == 13 and int(restored.bank.counts[0]) == 20


def test_resume_continues_epoch_step_and_early_stopping(tmp_path):
    """The Runner as the fit loop's hooks: a fit of 3 epochs with a constant
    validation mIoU (epoch 0 best, 2 waits), then a resume with max_epochs 5
    and patience 4 starts at epoch 3 and step 3 * steps_per_epoch, restores
    the state of epoch 2, and keeps counting from the saved wait: best epoch
    0 and wait 4 (a reset would give best epoch 3, wait 1)."""
    def runner(max_epochs, patience):
        cfg = load_config([], {"model.arch": "vit", "data.train_w": "64",
                               "trainer.log_dir": str(tmp_path), "trainer.run_name": "es",
                               "trainer.max_epochs": str(max_epochs),
                               "trainer.early_stopping_patience": str(patience),
                               "model.pretrained": "false"})
        r = object.__new__(Runner)
        r.cfg, r.fit_cfg, r._torch_ckpt = cfg, fit_config(cfg), None
        from floodseg_tpu_torch.core.logging import RunLogger
        r.logger = RunLogger(str(tmp_path), "es")
        r.ckpt = CheckpointManager(os.path.join(r.logger.log_dir, "checkpoints"), save_top_k=5)
        return r

    z = torch.zeros(5)
    metrics = {"loss": torch.tensor(0.0), "intersection": z, "union": z, "target": z}
    o = torch.ones(5)

    def fit(r, state):
        steps = []

        def train_fn(s, batch, gen):
            s.step += 1
            with torch.no_grad():
                s.model.weight.add_(1.0)
            return s, metrics

        def batches():
            while True:
                yield {}

        summary = _fit_loop(r.fit_cfg, state, train_fn,
                            lambda s, b: {"intersection": o, "union": o, "target": o},
                            {"l": batches()}, [{}], 2, None,
                            lambda step, s, m: steps.append(step), hooks=r)
        r.logger.close()
        return summary, steps

    r1 = runner(3, 10)
    s1, steps1 = fit(r1, _tiny_state(0.0))
    assert steps1 == list(range(6)) and s1["best_epoch"] == 0
    with open(tmp_path / "es" / "early_stop.json") as f:
        es = json.load(f)
    assert es["best_epoch"] == 0 and es["wait_count"] == 2
    # the previous last checkpoint stays until the next save
    assert sorted(os.listdir(tmp_path / "es" / "checkpoints"))[-2:] == ["last-1.pt", "last-2.pt"]
    r2 = runner(5, 4)
    s2, steps2 = fit(r2, _tiny_state(-5.0))
    assert steps2 == [6, 7, 8, 9] and [e["epoch"] for e in s2["epochs"]] == [3, 4]
    with open(tmp_path / "es" / "early_stop.json") as f:
        es = json.load(f)
    assert es["best_epoch"] == 0 and es["wait_count"] == 4
    # restored at epoch 2's state (6 steps: weight 6), then 4 more steps
    assert s2["state"].step == 10 and float(s2["state"].model.weight[0, 0].detach()) == 10.0
    records = [json.loads(line) for line in open(tmp_path / "es" / "metrics.jsonl")]
    assert [r["epoch"] for r in records if "epoch" in r] == [0, 1, 2, 3, 4]
    assert all(r["val_miou_epoch"] == 1.0 for r in records if "val_miou_epoch" in r)
    assert np.isclose(records[-1]["step"], 10)
