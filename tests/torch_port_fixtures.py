"""Shared set-up for the port's parity tests (tests/test_torch_*.py).

A JAX PSPNet-50 or DeepLabV3-50 initialised from PRNGKey(``key``) (or, on
request, drawn from numpy in the init's shapes, which skips compiling the
init), with every BatchNorm's scale, bias, running mean and running variance replaced
by values from a seeded numpy generator so that no BN is the identity, or
a JAX SegmenterViT whose LayerNorms, biases and cls token are replaced the
same way (flax initialises them to the identity and zeros), carried into
the port through the weight bridge (floodseg_tpu_torch/models/convert.py);
and the flow tests' inputs: block grids, two windows of a synthetic clip,
and the port's predict builders driven over them; and for the training
tests, flax's dropout keep masks recorded by module path and injected into
the port's Dropout modules by name.
"""

import contextlib
import os
from types import SimpleNamespace

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from floodseg_tpu.data.transforms import MEAN as JAX_MEAN, STD as JAX_STD
from floodseg_tpu.models import build_model as jax_build_model
from floodseg_tpu.models.vit import SegmenterViT as JaxSegmenterViT
from floodseg_tpu.train.optim import head_mask as jax_head_mask
from floodseg_tpu_torch.data import predict_windows, resize_frames, synthetic_clip
from floodseg_tpu_torch.data.image import write_jpeg, write_png
from floodseg_tpu_torch.models import SegmenterViT, build_model, convert, load_jax_variables
from floodseg_tpu_torch.train import make_cached_flow_predict_fn, make_flow_predict_fn
from floodseg_tpu_torch.video import default_grid


@pytest.fixture(scope="module")
def one_torch_thread():
    """The port's CPU ops of a test module on one thread. Tier-1 runs six
    workers on the machine's cores; there a multi-threaded small kernel
    (the int8 trunk's quantizations and im2cols, a float64 step's BN)
    waits on its descheduled threads for orders of magnitude longer than
    it computes. Every comparison of a module runs at the one count."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _perturb_bn(params, stats, rng):
    """Replace every BN's (scale, bias) and (mean, var) in place."""
    for name, sub in params.items():
        if not isinstance(sub, dict):
            continue
        if "scale" in sub and "bias" in sub:
            c = sub["scale"].shape[0]
            sub["scale"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
            sub["bias"] = rng.normal(0.0, 0.1, c).astype(np.float32)
            stats[name]["mean"] = rng.normal(0.0, 0.1, c).astype(np.float32)
            stats[name]["var"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
        else:
            _perturb_bn(sub, stats.get(name, {}), rng)


def port_state(variables):
    """The weight bridge's state_dict of a JAX variable tree with each
    array's own dtype kept (the bridge writes float32; the float64 training
    comparisons need float64), as torch tensors."""
    f32 = convert._f32
    convert._f32 = np.asarray
    try:
        out = convert.from_jax_variables(jax.device_get(variables))
    finally:
        convert._f32 = f32
    return {k: torch.from_numpy(np.array(v)) for k, v in out.items()}


def _to_dict(tree):
    if hasattr(tree, "items"):
        return {k: _to_dict(v) for k, v in tree.items()}
    return np.asarray(tree)


def _numpy_init(shapes, rng):
    """Variables in the shapes of ``shapes`` (jax.eval_shape of an init):
    every kernel normal with variance 1 / fan_in (flax's lecun_normal, not
    truncated), BN scales and variances ones, every other leaf zeros."""
    out = {}
    for name, sub in shapes.items():
        if hasattr(sub, "items"):
            out[name] = _numpy_init(sub, rng)
        elif name == "kernel":
            fan_in = int(np.prod(sub.shape[:-1]))
            out[name] = (rng.standard_normal(sub.shape) / np.sqrt(fan_in)).astype(np.float32)
        else:
            out[name] = np.full(sub.shape, float(name in ("scale", "var")), np.float32)
    return out


def numpy_leaves(shapes, rng):
    """Float64 values in the init's shapes (``jax.eval_shape`` of a ViT's
    or a discriminator's init): kernels normal with variance
    1 / fan_in, LayerNorm scales in [0.5, 1.5], biases normal at 0.1, the
    MaskTransformer's projections normal at d**-0.5 and every other leaf
    (the cls token, the position and class embeddings) normal at 0.02, so
    that no LayerNorm is the identity (drawn in numpy: no init compiles)."""
    out = {}
    for name, leaf in shapes.items():
        if hasattr(leaf, "items"):
            out[name] = numpy_leaves(leaf, rng)
        elif name == "kernel":
            out[name] = rng.standard_normal(leaf.shape) / np.sqrt(np.prod(leaf.shape[:-1]))
        elif name == "scale":
            out[name] = rng.uniform(0.5, 1.5, leaf.shape)
        elif name == "bias":
            out[name] = rng.normal(0.0, 0.1, leaf.shape)
        elif name in ("proj_patch", "proj_classes"):
            out[name] = rng.normal(0.0, leaf.shape[0] ** -0.5, leaf.shape)
        else:
            out[name] = rng.normal(0.0, 0.02, leaf.shape)
    return out


def _pair(arch: str, size: int, seed: int, classes: int, key: int,
          compiled_init: bool = True):
    jm = jax_build_model(arch, classes=classes, layers=50, with_aux=False)
    x0 = jnp.zeros((1, size, size, 3), jnp.float32)

    def init():
        return jm.init({"params": jax.random.PRNGKey(key)}, x0, train=False)

    if compiled_init:
        variables = _to_dict(jax.device_get(jax.jit(init)()))
    else:
        variables = _numpy_init(jax.eval_shape(init), np.random.default_rng(key))
    _perturb_bn(variables["params"], variables["batch_stats"],
                np.random.default_rng(seed))
    port = load_jax_variables(
        build_model(arch, classes=classes, layers=50, with_aux=False), variables)
    return jm, variables, port


def pspnet50_pair(size: int = 65, seed: int = 0, classes: int = 5, key: int = 0,
                  compiled_init: bool = True):
    """(jax_model, variables as numpy dicts, port PSPNet-50 with the same
    weights), both float32 and without the aux head. ``compiled_init=False``
    draws the weights from a numpy generator seeded with ``key`` in the
    init's shapes (``_numpy_init``) instead of compiling flax's init."""
    return _pair("pspnet", size, seed, classes, key, compiled_init)


def deeplabv3_pair(size: int = 65, seed: int = 0, classes: int = 5, key: int = 0,
                   compiled_init: bool = True):
    """(jax_model, variables as numpy dicts, port DeepLabV3-50 with the same
    weights), both float32 and without the aux head; ``compiled_init`` as
    in ``pspnet50_pair``."""
    return _pair("deeplabv3", size, seed, classes, key, compiled_init)


def _perturb_vit(params, rng):
    """Replace every LayerNorm's scale and bias, every Dense bias and the
    cls token in place."""
    for name, sub in params.items():
        if isinstance(sub, dict):
            _perturb_vit(sub, rng)
        elif name == "scale":
            params[name] = rng.uniform(0.5, 1.5, sub.shape).astype(np.float32)
        elif name in ("bias", "cls_token"):
            params[name] = rng.normal(0.0, 0.1, sub.shape).astype(np.float32)


def vit_pair(size: int = 64, seed: int = 0, classes: int = 5, key: int = 0,
             dtype=jnp.float32, **config):
    """(jax_model, variables as numpy dicts, port SegmenterViT with the same
    weights) computing in ``dtype`` (jnp.float32 or jnp.bfloat16; the port's
    in the torch dtype of the same name). ``config``: SegmenterViT's
    image_size, patch_size, d_model, n_layers, dec_layers, n_heads,
    decoder_type, as both packages name them; by default a narrow ViT/32
    (d = 128, 2 heads, 2 + 2 layers) at ``size`` px. The variables come
    from an init at ``size`` px."""
    config = {"image_size": size, "patch_size": 32, "d_model": 128, "n_layers": 2,
              "dec_layers": 2, "n_heads": 2, **config}
    jm = JaxSegmenterViT(classes=classes, dropout=0.0, dtype=dtype, **config)
    x0 = jnp.zeros((1, size, size, 3), jnp.float32)
    variables = _to_dict(jax.device_get(jax.jit(
        lambda: jm.init({"params": jax.random.PRNGKey(key)}, x0, train=False))()))
    _perturb_vit(variables["params"], np.random.default_rng(seed))
    tdtype = torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32
    port = load_jax_variables(SegmenterViT(classes=classes, dtype=tdtype, **config).eval(),
                              variables)
    return jm, variables, port


def smooth_grids(rng, t, gh, gw):
    """Smooth near-identity grids (T, 1, gh, gw, 2); the jitter pushes the
    edge points past [-1, 1], so the border clamp is exercised."""
    base = np.stack(np.meshgrid(np.linspace(-1, 1, gw), np.linspace(-1, 1, gh)),
                    axis=-1)[None, None]
    return (base + rng.uniform(-0.08, 0.08, (t, 1, gh, gw, 2))).astype(np.float32)


def jnorm(x):
    """Key frames normalised on the host, as the JAX builders' callers do;
    the port's builders take the raw uint8 frames and normalise on the
    device."""
    return ((x.astype(np.float32) - np.asarray(JAX_MEAN, np.float32))
            / np.asarray(JAX_STD, np.float32))


def builder_windows(n: int = 5, out_size=(72, 80), frame_size: int = 65):
    """Two windows of a synthetic clip of 64 px frames, its key frames
    resized to ``frame_size`` px uint8 (1, s, s, 3): frames[0], frames[1]
    are window 0's, frames[3] window 1's next key. 4x4 block grids."""
    clip = synthetic_clip(2 * n + 1, size=(64, 64), frame_ids=(0, n, 2 * n), seed=3)
    wins = predict_windows(clip, n)
    frames = [resize_frames(w[k], (frame_size, frame_size)).numpy()
              for w in wins for k in ("frame_prev", "frame_next")]
    assert frames[0].dtype == np.uint8 and frames[0].shape == (1, frame_size, frame_size, 3)
    return dict(n=n, out_size=out_size, wins=wins, frames=frames, dg=default_grid(64, 64))


def run_port_builders(model, variables, ref, **kw):
    """The port's cached builders (window 0 full, window 1 cached) and its
    single-window builder over ``builder_windows`` ``ref``, built on
    ``model`` and called with ``variables``: ((maps0, maps1), (enc0, enc1),
    single-window maps0)."""
    n, out_size, dg, wins, frames = (ref[k] for k in ("n", "out_size", "dg", "wins",
                                                      "frames"))
    full, cached = make_cached_flow_predict_fn(model, n=n, out_size=out_size,
                                               default_grid=dg, device="cpu", **kw)
    p0, penc0 = full(variables, frames[0], frames[1], wins[0]["mvs_left"],
                     wins[0]["mvs_right"])
    p1, penc1 = cached(variables, penc0, frames[3], wins[1]["mvs_left"],
                       wins[1]["mvs_right"])
    single = make_flow_predict_fn(model, n=n, out_size=out_size, default_grid=dg,
                                  device="cpu", **kw)(
        variables, frames[0], frames[1], wins[0]["mvs_left"], wins[0]["mvs_right"])
    return (p0, p1), (penc0, penc1), single


def flax_keep_masks(model, variables, key, x, method=None):
    """{flax module path "a/b/Dropout_0": keep mask} of every flax Dropout
    in one training ``apply`` of ``model`` (``method``) with dropout key
    ``key`` on an input shaped like ``x``: each Dropout's input is replaced
    by ones inside the call, so its output is nonzero where it keeps. A
    mask depends on the key, the module path and the shape only, so it is
    the one the JAX step draws in the call it makes with that key."""
    masks = {}

    def interceptor(next_fun, args, kwargs, context):
        if isinstance(context.module, fnn.Dropout) and context.method_name == "__call__":
            out = next_fun(jnp.ones_like(args[0]), *args[1:], **kwargs)
            masks["/".join(context.module.path)] = np.asarray(out != 0)
            return out
        return next_fun(*args, **kwargs)

    with fnn.intercept_methods(interceptor):
        model.apply(variables, jnp.zeros(np.shape(x), jnp.asarray(x).dtype), train=True,
                    method=method, rngs={"dropout": key}, mutable=["batch_stats"])
    return masks


def flax_keep_masks_fn(model, x, method=None):
    """A jitted ``(variables, key) -> flax_keep_masks(model, variables, key,
    x, method)``: one compile for the calls of one shape, where recording
    each call's masks eagerly would compile every op of the apply again.
    The masks are the ones the eager recording gives (a key's draws do not
    depend on jit)."""
    shape, dtype = np.shape(x), jnp.asarray(x).dtype

    def masks_of(variables, key):
        masks = {}

        def interceptor(next_fun, args, kwargs, context):
            if isinstance(context.module, fnn.Dropout) and context.method_name == "__call__":
                out = next_fun(jnp.ones_like(args[0]), *args[1:], **kwargs)
                masks["/".join(context.module.path)] = out != 0
                return out
            return next_fun(*args, **kwargs)

        with fnn.intercept_methods(interceptor):
            model.apply(variables, jnp.zeros(shape, dtype), train=True, method=method,
                        rngs={"dropout": key}, mutable=["batch_stats"])
        return masks

    jitted = jax.jit(masks_of)
    return lambda variables, key: {k: np.asarray(v) for k, v in jitted(variables, key).items()}


def inject_keep_masks(port, masks, names, nchw=()):
    """Set each port Dropout's ``keep`` from flax's masks: ``names`` maps a
    flax module path to the port module's name; the masks of the paths in
    ``nchw`` are NHWC maps, transposed to the port's NCHW. A port Dropout
    that runs in training mode without a mask raises (no generator), so a
    call the masks do not cover fails."""
    assert set(masks) <= set(names), sorted(set(masks) - set(names))
    for path, mask in masks.items():
        m = mask.transpose(0, 3, 1, 2) if path in nchw else mask
        port.get_submodule(names[path]).keep = torch.from_numpy(np.array(m))


def clear_keep_masks(port):
    from floodseg_tpu_torch.models.layers import Dropout
    for mod in port.modules():
        if isinstance(mod, Dropout):
            mod.keep = None


@contextlib.contextmanager
def masks_per_call(port, calls, names, nchw=()):
    """Inside the block, each call of ``port.encode`` / ``port.decode``
    first injects the next masks of ``calls[method]`` (a list of flax mask
    dicts in call order): the JAX flow step draws each call's masks from
    its own key. Every listed call must happen."""
    queues = {k: list(v) for k, v in calls.items()}
    orig = {k: getattr(port, k) for k in calls}

    def wrap(method):
        def call(*args, **kwargs):
            clear_keep_masks(port)
            inject_keep_masks(port, queues[method].pop(0), names, nchw)
            return orig[method](*args, **kwargs)
        return call

    for k in calls:
        setattr(port, k, wrap(k))
    try:
        yield
    finally:
        for k in calls:
            delattr(port, k)
        clear_keep_masks(port)
    assert all(not q for q in queues.values()), {k: len(q) for k, q in queues.items()}


def vit_mask_names(n_layers, dec_layers):
    """flax module path -> port module name of every ViT Dropout."""
    sites = {"attn/Dropout_0": "attn.attn_drop", "attn/Dropout_1": "attn.proj_drop",
             "mlp/Dropout_0": "mlp.drop1", "mlp/Dropout_1": "mlp.drop2"}
    names = {"encoder/Dropout_0": "encoder.pos_drop"}
    for part, n in (("encoder", n_layers), ("decoder", dec_layers)):
        for i in range(n):
            for site, port_site in sites.items():
                names[f"{part}/block{i}/{site}"] = f"{part}.blocks.{i}.{port_site}"
    return names


def jax_head_mask_through_bridge(variables):
    """JAX's head_mask of a variable tree carried through the weight bridge:
    state_dict key -> bool, for the keys that are parameters."""
    mask = jax_head_mask(variables["params"])
    as_arrays = {
        "params": jax.tree.map(lambda m, v: np.full(v.shape, float(m), np.float32),
                               mask, variables["params"]),
        "batch_stats": jax.tree.map(lambda v: np.zeros(v.shape, np.float32),
                                    variables.get("batch_stats", {})),
    }
    return {k: bool(v.reshape(-1)[0]) if np.size(v) else None
            for k, v in convert.from_jax_variables(as_arrays).items()}


def round_grids(sample, rng=None):
    """A transform that puts a sample's grids on multiples of 2**-10, where
    float32 tap arithmetic is exact whether or not XLA fuses it."""
    for k in ("mvs_left", "mvs_right"):
        if sample.get(k) is not None:
            sample[k] = [(np.round(g * 1024) / 1024).astype(np.float32) for g in sample[k]]
    return sample


def jax_fit_data(tree, cfg, method, crop, extra=None, normalize_on_device=False):
    """``Runner.fit``'s data for ``method`` ("supervised" or
    "flow_supervised") at the ``crop`` size: ``Runner._transforms``'
    transforms (``extra`` appended to the train and val ones; the train
    one without normalising under ``normalize_on_device``), the datasets,
    the infinite shuffled train loader and the val loader. Returns (train
    loader, val loader, steps an epoch). ``cfg`` is the port's
    FitConfig."""
    from floodseg_tpu.data import transforms as jax_tf
    from floodseg_tpu.data.dataset import FlowDataset as JaxFlowDataset
    from floodseg_tpu.data.dataset import SemDataset as JaxSemDataset
    from floodseg_tpu.data.loader import DataLoader as JaxLoader

    resize = (cfg.resize_h, cfg.resize_w)
    ignore = list(cfg.classes_ignore)
    lists = f"{tree}/list/{cfg.data_variant}"
    if method == "flow_supervised":
        train = jax_tf.build_train_transform(crop, crop, ignore, cfg.scale_min, cfg.scale_max,
                                             resize, with_rotate=False, crop_padding=None,
                                             normalize=not normalize_on_device)
        val = jax_tf.build_val_transform(crop, crop, ignore, resize, crop=True,
                                         crop_padding=None)
        ds = JaxFlowDataset("train", tree, f"{lists}/train.txt", type="l", transform=train,
                            frame_delta=cfg.frame_delta)
        vds = JaxFlowDataset("val", tree, f"{lists}/val.txt", type="l", transform=val,
                             frame_delta=cfg.frame_delta)
    else:
        train = jax_tf.build_train_transform(crop, crop, ignore, cfg.scale_min, cfg.scale_max,
                                             resize, normalize=not normalize_on_device)
        val = jax_tf.build_val_transform(crop, crop, ignore, resize)
        ds = JaxSemDataset("train", tree, f"{lists}/train.txt", train)
        vds = JaxSemDataset("val", tree, f"{lists}/val.txt", val)
    if extra is not None:
        train.transforms.append(extra)
        val.transforms.append(extra)
    loader = JaxLoader(ds, batch_size=cfg.batch_size, shuffle=True, num_workers=cfg.workers,
                       seed=cfg.seed, infinite=True, drop_last=True)
    vloader = JaxLoader(vds, batch_size=cfg.batch_size_val, num_workers=cfg.workers,
                        seed=cfg.seed)
    return loader, vloader, min(len(ds) // cfg.batch_size, cfg.limit_train_batches)


def jax_fit_state(variables, cfg, steps):
    """``Runner.fit``'s initial TrainState: ``variables`` under the SGD
    optimizer and poly schedule of ``steps`` an epoch."""
    from floodseg_tpu.train.optim import make_optimizer as jax_make_optimizer
    from floodseg_tpu.train.state import TrainState as JaxTrainState

    tx = jax_make_optimizer(cfg.lr, steps * cfg.max_epochs, "sgd", cfg.momentum,
                            cfg.weight_decay, power=cfg.power)
    params = jax.tree.map(jnp.asarray, variables["params"])
    return JaxTrainState(step=jnp.zeros((), jnp.int32), params=params,
                         batch_stats=jax.tree.map(jnp.asarray,
                                                  variables.get("batch_stats", {})),
                         opt_state=tx.init(params), tx=tx)


def jax_fit(tree, jm, variables, cfg, method, crop, extra=None, normalize_on_device=False):
    """The JAX package's ``Runner.fit`` loop on one device for ``method``
    ("supervised" or "flow_supervised"), without logger or checkpoints:
    ``jax_fit_data``'s loaders, the optimizer, the steps with
    ``fold_in(rng, step)`` keys, one epoch of ``cfg.limit_train_batches``
    steps, then validation through the eval step. Returns (the mean train
    loss, the validation MetricMeter, the steps taken). ``cfg`` is the
    port's FitConfig. ``normalize_on_device``: the Runner's wiring of
    ``data.normalize_on_device``, its own ``_device_batch`` (float16
    frames) on the train batches and ``_norm_wrap`` around the jitted
    step."""
    from floodseg_tpu.cli.runner import Runner
    from floodseg_tpu.ops.metrics import MetricMeter as JaxMeter
    from floodseg_tpu.train import flow as jflow
    from floodseg_tpu.train import supervised as jax_sup

    loader, vloader, steps = jax_fit_data(tree, cfg, method, crop, extra, normalize_on_device)
    if method == "flow_supervised":
        loss_fn = jax_sup.make_loss_fn(cfg.loss, 0.0, 255, cfg.ohem_thresh, cfg.ohem_min_kept)
        step, _ = jflow.make_flow_train_step(jm, loss_fn, cfg.classes, 255)
        ev = jflow.make_flow_eval_step(jm, cfg.classes, 255)
    else:
        loss_fn = jax_sup.make_loss_fn(cfg.loss, cfg.aux_weight, 255, cfg.ohem_thresh,
                                       cfg.ohem_min_kept)
        step = jax_sup.make_train_step(jm, loss_fn, cfg.classes, 255)
        ev = jax_sup.make_eval_step(jm, cfg.classes, 255)
    state = jax_fit_state(variables, cfg, steps)
    runner = object.__new__(Runner)
    runner.mesh = None
    runner.cfg = SimpleNamespace(data=SimpleNamespace(normalize_on_device=normalize_on_device))
    step, ev = jax.jit(Runner._norm_wrap(runner, step)), jax.jit(ev)

    rng = jax.random.PRNGKey(cfg.seed)
    it = iter(loader)
    losses = []
    for i in range(steps):
        batch = Runner._device_batch(runner, next(it))
        state, m = step(state, batch, jax.random.fold_in(rng, i))
        losses.append(float(m["loss"]))
    meter = JaxMeter(cfg.classes)
    for vb in vloader:
        m = ev(state, {k: jnp.asarray(v) for k, v in vb.items()})
        meter.update(m["intersection"], m["union"], m["target"])
    return float(np.mean(losses)), meter, steps


def jax_runner(tree, method, cfg, arch="vit"):
    """A JAX ``Runner`` for ``method`` and ``arch`` on ``tree`` with the
    settings of ``cfg`` (the port's FitConfig), made without its
    constructor: one device, no mesh, no model, logger or checkpoints; its
    transforms, datasets and loaders are the Runner's own."""
    from floodseg_tpu.cli.runner import FLOW_METHODS, Runner
    from floodseg_tpu.core.config import load_config

    jcfg = load_config([], {
        "method": method, "model.arch": arch, "data.data_root": tree,
        "data.data_variant": cfg.data_variant, "data.train_h": cfg.train_h,
        "data.train_w": cfg.train_w, "data.resize_h": cfg.resize_h,
        "data.resize_w": cfg.resize_w, "data.frame_delta": cfg.frame_delta,
        "data.data_classes_ignore": list(cfg.classes_ignore),
        "data.batch_size": cfg.batch_size, "data.batch_size_val": cfg.batch_size_val,
        "data.workers": cfg.workers, "data.data_ratio": cfg.data_ratio,
        "trainer.seed": cfg.seed, "trainer.max_epochs": cfg.max_epochs,
        "trainer.limit_train_batches": cfg.limit_train_batches,
        "model.optim.lr": cfg.lr, "model.optim.lr_D": cfg.lr_D,
        "model.threshold_st": cfg.threshold_st})
    r = object.__new__(Runner)
    r.cfg, r.is_flow, r.num_devices, r.mesh = jcfg, method in FLOW_METHODS, 1, None
    return r


def write_ade_tree(root, n_train=4, n_val=2, hw=(48, 64), val_hw=(40, 56), seed=0):
    """An ADE20K-layout tree: images/{training,validation} JPEGs and
    annotations/... L PNGs of blocky labels 0..150."""
    rng = np.random.default_rng(seed)
    for split, n, (h, w) in (("training", n_train, hw), ("validation", n_val, val_hw)):
        os.makedirs(os.path.join(root, "images", split), exist_ok=True)
        os.makedirs(os.path.join(root, "annotations", split), exist_ok=True)
        for i in range(n):
            write_jpeg(os.path.join(root, "images", split, f"ade_{i:04d}.jpg"),
                       rng.integers(0, 256, (h, w, 3), np.uint8))
            lab = np.kron(rng.integers(0, 151, (4, 4)), np.ones((h // 4 + 1, w // 4 + 1)))
            write_png(os.path.join(root, "annotations", split, f"ade_{i:04d}.png"),
                      lab[:h, :w].astype(np.uint8))
    return root
