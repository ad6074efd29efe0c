"""Shared set-up for the port's parity tests (tests/test_torch_*.py).

A JAX PSPNet-50 or DeepLabV3-50 initialised from PRNGKey(``key``), with
every BatchNorm's scale, bias, running mean and running variance replaced
by values from a seeded numpy generator so that no BN is the identity, or
a JAX SegmenterViT whose LayerNorms, biases and cls token are replaced the
same way (flax initialises them to the identity and zeros), carried into
the port through the weight bridge (floodseg_tpu_torch/models/convert.py);
and the flow tests' inputs: block grids, two windows of a synthetic clip,
and the port's predict builders driven over them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from floodseg_tpu.data.transforms import MEAN as JAX_MEAN, STD as JAX_STD
from floodseg_tpu.models import build_model as jax_build_model
from floodseg_tpu.models.vit import SegmenterViT as JaxSegmenterViT
from floodseg_tpu_torch.data import predict_windows, resize_frames, synthetic_clip
from floodseg_tpu_torch.models import SegmenterViT, build_model, convert, load_jax_variables
from floodseg_tpu_torch.train import make_cached_flow_predict_fn, make_flow_predict_fn
from floodseg_tpu_torch.video import default_grid


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


def _pair(arch: str, size: int, seed: int, classes: int, key: int):
    jm = jax_build_model(arch, classes=classes, layers=50, with_aux=False)
    x0 = jnp.zeros((1, size, size, 3), jnp.float32)
    variables = _to_dict(jax.device_get(jax.jit(
        lambda: jm.init({"params": jax.random.PRNGKey(key)}, x0, train=False))()))
    _perturb_bn(variables["params"], variables["batch_stats"],
                np.random.default_rng(seed))
    port = load_jax_variables(
        build_model(arch, classes=classes, layers=50, with_aux=False), variables)
    return jm, variables, port


def pspnet50_pair(size: int = 65, seed: int = 0, classes: int = 5, key: int = 0):
    """(jax_model, variables as numpy dicts, port PSPNet-50 with the same
    weights), both float32 and without the aux head."""
    return _pair("pspnet", size, seed, classes, key)


def deeplabv3_pair(size: int = 65, seed: int = 0, classes: int = 5, key: int = 0):
    """(jax_model, variables as numpy dicts, port DeepLabV3-50 with the same
    weights), both float32 and without the aux head."""
    return _pair("deeplabv3", size, seed, classes, key)


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
