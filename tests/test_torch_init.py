"""The port's default initial weights (floodseg_tpu_torch/models/layers.py::
``init_flax_defaults_``) against the JAX package's ``model.init``, which
every JAX entry point that makes weights calls with flax's defaults and the
ViT's own initializers (floodseg_tpu/train/state.py, models/vit.py).

For PSPNet-50 and DeepLabV3-50, each with its aux and U2PL rep heads (65 px
inputs, a training-mode init as the rep head needs), a narrow Segmenter
ViT/32 (d = 64, one layer each side) with the MaskTransformer and its rep
head and with the linear decoder, a narrow ``ViTClassifier`` (patch 16,
32 px) and the s4GAN discriminator: one JAX init at ``PRNGKey(0)`` an
architecture, shared by the cases of this file and carried to the port's
names by the weight bridge, beside ``init_flax_defaults_`` at seed 0.

Tolerances, each on both sides (JAX's draw and the port's):

- the keys are the same;
- every leaf JAX makes constant (biases, BN scale, bias, running mean and
  variance, LN scale and bias, ``cls_token``, ``num_batches_tracked``) is
  equal exactly;
- every random leaf of n values: |mean| <= 5 s / sqrt(n) and |std - s| <=
  5 s / sqrt(2 (n - 1)), with s flax's analytic standard deviation
  (sqrt(1 / fan_in) for ``lecun_normal``, 0.02 * 0.8796 for
  ``truncated_normal(0.02)``, d**-0.5 for ``normal``); the second bound is
  a normal's standard error of a standard deviation, which is larger than
  a truncated normal's;
- max |x| of a truncated leaf <= 2 sigma (sigma = s / 0.8796 for
  ``lecun_normal``, 0.02 for ``truncated_normal(0.02)``); of the untruncated
  ``proj_patch`` and ``proj_classes`` in (2 s, 6 s]: the tail a truncated
  draw would lack is there;
- the draw is bit-equal at the same seed, and every random leaf differs at
  another.

The product paths that draw it are pinned too: ``segm/train.py::
init_model``, ``method_state``'s default s4GAN discriminator,
``create_u2pl_state``'s default teacher and ``cli/segm_inference.py``
without a checkpoint (``Runner._build_model`` in tests/test_torch_cli.py).
"""

import copy
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from floodseg_tpu.models import build_model as jax_build_model
from floodseg_tpu.models.discriminator import S4GANDiscriminator as JaxDiscriminator
from floodseg_tpu.models.vit import SegmenterViT as JaxSegmenterViT
from floodseg_tpu.models.vit import ViTClassifier as JaxViTClassifier

import floodseg_tpu_torch.models.layers as layers
from floodseg_tpu_torch.cli import segm_inference
from floodseg_tpu_torch.core.config import fit_config, load_config
from floodseg_tpu_torch.data.image import write_jpeg
from floodseg_tpu_torch.models import (
    S4GANDiscriminator,
    SegmenterViT,
    ViTClassifier,
    build_model,
    from_jax_variables,
    init_flax_defaults_,
    with_rep,
)
from floodseg_tpu_torch.segm import train as segm_train
from floodseg_tpu_torch.train import create_u2pl_state, make_optimizer, method_state

from torch_port_fixtures import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

TRUNC = 0.87962566103423978  # std of a unit normal truncated to [-2, 2]
SE = 5.0
VIT = dict(image_size=64, patch_size=32, d_model=64, n_layers=1, dec_layers=1, n_heads=2)
CLF = dict(n_cls=10, image_size=32, patch_size=16, d_model=64, n_layers=1, n_heads=2)
CNN = dict(classes=5, layers=50, with_aux=True, semisupervised=True)

# arch -> (JAX model, its init input, training-mode init, the port's model)
ARCHS = {
    "pspnet50_aux_rep": (lambda: jax_build_model("pspnet", **CNN), (1, 65, 65, 3), True,
                         lambda: build_model("pspnet", **CNN)),
    "deeplabv3_50_aux_rep": (lambda: jax_build_model("deeplabv3", **CNN), (1, 65, 65, 3), True,
                             lambda: build_model("deeplabv3", **CNN)),
    "vit_mask_rep": (lambda: JaxSegmenterViT(classes=5, with_rep=True, **VIT), (1, 64, 64, 3),
                     True, lambda: with_rep(SegmenterViT(classes=5, **VIT))),
    "vit_linear": (lambda: JaxSegmenterViT(classes=5, decoder_type="linear", **VIT),
                   (1, 64, 64, 3), False,
                   lambda: SegmenterViT(classes=5, decoder_type="linear", **VIT)),
    "vit_classifier": (lambda: JaxViTClassifier(**CLF), (1, 32, 32, 3), False,
                       lambda: ViTClassifier(**CLF)),
    "s4gan_discriminator": (lambda: JaxDiscriminator(num_classes=5), (1, 64, 64, 8), False,
                            lambda: S4GANDiscriminator(5)),
}


def _port_draw(model, seed):
    init_flax_defaults_(model, torch.Generator().manual_seed(seed))
    return {k: v.numpy().copy() for k, v in model.state_dict().items()}


@pytest.fixture(scope="module")
def drawn():
    """arch -> (the JAX init's leaves, the port's at seed 0, the port's
    model): every JAX init in one jitted call at PRNGKey(0) (one compile),
    the port's drawn on first use."""
    key = jax.random.PRNGKey(0)
    models = {a: make() for a, (make, _, _, _) in ARCHS.items()}
    variables = jax.device_get(jax.jit(lambda: {
        a: models[a].init({"params": key, "dropout": key}, jnp.zeros(shape), train=train)
        for a, (_, shape, train, _) in ARCHS.items()})())
    ref = {a: {k: np.asarray(x) for k, x in from_jax_variables(
        {"batch_stats": {}, **v}).items()} for a, v in variables.items()}
    cache = {}

    def get(arch):
        if arch not in cache:
            model = ARCHS[arch][3]()
            cache[arch] = (ref[arch], _port_draw(model, 0), model)
        return cache[arch]

    yield get
    cache.clear()


def flax_law(key, shape):
    """(s, bound) of flax's initializer of the port's leaf ``key``: s the
    analytic standard deviation, bound the truncation (None: an untruncated
    normal); None for a leaf JAX makes constant."""
    name = key.rsplit(".", 1)[-1]
    if name in ("pos_embed", "cls_emb"):
        return 0.02 * TRUNC, 0.04
    if name in ("proj_patch", "proj_classes"):
        return shape[0] ** -0.5, None
    if name == "weight" and len(shape) >= 2:  # conv (O, I, kh, kw) or Linear (O, I)
        s = math.sqrt(1.0 / math.prod(shape[1:]))
        return s, 2.0 * s / TRUNC
    return None


def _within_law(key, x, s, bound):
    n = x.size
    mean, std, top = abs(x.mean(dtype=np.float64)), x.std(dtype=np.float64), np.abs(x).max()
    assert mean <= SE * s / math.sqrt(n), (key, mean, s, n)
    assert abs(std - s) <= SE * s / math.sqrt(2 * (n - 1)), (key, std, s, n)
    if bound is None:
        assert 2.0 * s < top <= 6.0 * s, (key, top, s)
    else:
        assert top <= bound * (1.0 + 1e-6), (key, top, bound)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_keys_match_the_jax_init(drawn, arch):
    ref, ours, _ = drawn(arch)
    assert sorted(ours) == sorted(ref)
    for k in ref:
        assert ours[k].shape == ref[k].shape, k


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_constant_leaves_equal_the_jax_init(drawn, arch):
    ref, ours, _ = drawn(arch)
    constant = [k for k in ref if flax_law(k, ref[k].shape) is None]
    assert constant
    for k in constant:
        assert np.all(ref[k] == ref[k].ravel()[0]), f"{k} is not constant in the JAX init"
        np.testing.assert_array_equal(ours[k], ref[k], err_msg=k)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_random_leaves_follow_flax_distributions(drawn, arch):
    ref, ours, _ = drawn(arch)
    random = [k for k in ref if flax_law(k, ref[k].shape) is not None]
    assert random
    for k in random:
        s, bound = flax_law(k, ref[k].shape)
        _within_law(f"JAX {k}", ref[k], s, bound)
        _within_law(f"port {k}", ours[k], s, bound)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_draw_is_reproducible_from_the_seed(drawn, arch):
    _, ours, model = drawn(arch)
    for seed in (0, 1):
        init_flax_defaults_(model, torch.Generator().manual_seed(seed))
        for k, v in model.state_dict().items():
            same = np.array_equal(v.numpy(), ours[k])
            assert same if seed == 0 or flax_law(k, v.shape) is None else not same, (seed, k)


@pytest.mark.parametrize("arch", ["pspnet", "deeplabv3"])
def test_every_parameter_of_the_101_layer_models_is_drawn(arch):
    """Every parameter and BN buffer of the 101-layer models with their aux
    and rep heads is written: none is left at its NaN fill."""
    model = build_model(arch, classes=5, layers=101, with_aux=True, semisupervised=True)
    with torch.no_grad():
        for v in model.state_dict().values():
            if v.is_floating_point():
                v.fill_(float("nan"))
    init_flax_defaults_(model, torch.Generator().manual_seed(0))
    for k, v in model.state_dict().items():
        assert not v.isnan().any(), k


def test_an_unknown_parameter_raises():
    model = torch.nn.Sequential(layers.Linear(4, 4))
    model.register_parameter("scale_extra", torch.nn.Parameter(torch.ones(4)))
    with pytest.raises(ValueError, match="scale_extra"):
        init_flax_defaults_(model, torch.Generator().manual_seed(0))


# ------------------------------------------------ the paths that draw it

def _states_equal(a, b):
    a, b = a.state_dict(), b.state_dict()
    assert sorted(a) == sorted(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k


def _narrow_vit(rep=False):
    m = SegmenterViT(classes=5, **VIT)
    return (with_rep(m) if rep else m).eval()


def test_segm_init_model_draws_flax_defaults():
    ours = segm_train.init_model(_narrow_vit(), 42)
    _states_equal(ours, init_flax_defaults_(_narrow_vit(), torch.Generator().manual_seed(42)))


def _fit_cfg():
    return fit_config(load_config([], {"model.arch": "vit", "data.train_w": "64",
                                       "trainer.seed": "7",
                                       "model.contrastive.bank_capacity": "64",
                                       "model.contrastive.bank_class0_capacity": "96",
                                       "model.contrastive.max_enqueue": "16"}))


def test_default_discriminator_draws_flax_defaults():
    cfg = _fit_cfg()
    _, state_d = method_state(_narrow_vit(), cfg, "flow_gan", 2, device="cpu")
    ref = init_flax_defaults_(S4GANDiscriminator(cfg.classes),
                              torch.Generator().manual_seed(cfg.seed))
    _states_equal(state_d.model, ref)


def test_default_teacher_draws_flax_defaults():
    model = _narrow_vit(rep=True)
    ref = init_flax_defaults_(copy.deepcopy(model), torch.Generator().manual_seed(4))
    opt, sched = make_optimizer(model, 1e-3, 4)
    state = create_u2pl_state(model, opt, sched, bank_capacity=64, bank_class0_capacity=64,
                              max_enqueue=32, seed=4)
    _states_equal(state.teacher, ref)


def test_segm_inference_without_a_checkpoint_draws_flax_defaults(tmp_path, monkeypatch):
    """cli/segm_inference.py with ``--ckpt -`` draws ``init_flax_defaults_``
    at seed 0, as scripts/segm_inference.py inits at PRNGKey(0); with a
    checkpoint it loads that and draws nothing."""
    calls = []

    def spy(model, generator):
        out = init_flax_defaults_(model, generator)
        calls.append((generator.initial_seed(), copy.deepcopy(out)))
        return out

    monkeypatch.setattr(layers, "init_flax_defaults_", spy)
    (tmp_path / "in").mkdir()
    write_jpeg(str(tmp_path / "in" / "a.jpg"),
               np.random.default_rng(0).integers(0, 256, (40, 48, 3), dtype=np.uint8))
    cfg = dict(classes=5, image_size=32, patch_size=32, d_model=64, n_layers=1, dec_layers=1)
    argv = ["-i", str(tmp_path / "in"), "--n-cls", "5", "--image-size", "32",
            "--d-model", "64", "--n-layers", "1", "--dec-layers", "1", "--device", "cpu"]
    assert segm_inference.main(argv + ["--ckpt", "-", "-o", str(tmp_path / "a")]) == 0
    assert len(calls) == 1 and calls[0][0] == 0
    _states_equal(calls[0][1], init_flax_defaults_(SegmenterViT(**cfg),
                                                   torch.Generator().manual_seed(0)))
    path = str(tmp_path / "w.pt")
    torch.save(calls[0][1].state_dict(), path)
    assert segm_inference.main(argv + ["--ckpt", path, "-o", str(tmp_path / "b")]) == 0
    assert len(calls) == 1
