"""The port's PSPNet-50 and weight bridge against the JAX package, on the CPU.

Weights: JAX ``init(PRNGKey(0))`` with every BN's scale, bias, mean and var
replaced by seeded numpy values (tests/torch_port_fixtures.py), carried
across by ``from_jax_variables``. encode/decode parity is float32 at
rtol = atol = 1e-4: fifty-odd convolutions summed in different orders.
"""

import jax
import numpy as np
import pytest
import torch

from floodseg_tpu.models.lightning_export import export_pspnet_variables
from floodseg_tpu_torch.models import build_model, from_jax_variables, init_from_generator_
from floodseg_tpu_torch.models.layers import dropout_generator

from torch_port_fixtures import pspnet50_pair

TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def pair():
    return pspnet50_pair(size=65)


def test_from_jax_variables_equals_lightning_export(pair):
    _, variables, port = pair
    ours = from_jax_variables(variables)
    ref = export_pspnet_variables(variables, flow=False)
    assert sorted(ours) == sorted(ref)
    for k, v in ref.items():
        np.testing.assert_array_equal(ours[k], np.asarray(v), err_msg=k)
        assert ours[k].dtype == np.asarray(v).dtype, k
    # the port's own module tree carries exactly the reference's names
    assert sorted(port.state_dict()) == sorted(ref)


def test_aux_head_keys_match_lightning_export():
    """with_aux=True adds the reference's aux.{0,1,4} Sequential."""
    from floodseg_tpu.models import build_model as jax_build_model
    import jax.numpy as jnp
    jm = jax_build_model("pspnet", classes=3, layers=50, with_aux=True)
    # the aux head only gets variables from a train-mode init
    key = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(lambda: jm.init(
        {"params": key, "dropout": key}, jnp.zeros((1, 33, 33, 3)), train=True))
    variables = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    port = build_model("pspnet", classes=3, layers=50, with_aux=True)
    ref = export_pspnet_variables(variables, flow=False)
    assert sorted(from_jax_variables(variables)) == sorted(ref)
    assert sorted(port.state_dict()) == sorted(ref)


def test_encode_matches_jax(pair):
    jm, variables, port = pair
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 65, 65, 3)).astype(np.float32)
    ref, ref_feats = jax.jit(lambda v, x: jm.apply(v, x, train=False, method="encode"))(
        variables, x)
    with torch.no_grad():
        ours, feats = port.encode(torch.from_numpy(x))
    assert ours.shape == (2, 9, 9, 4096) and ours.is_contiguous()
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), **TOL)
    for k in ("c2", "c3", "c4"):
        np.testing.assert_allclose(feats[k].numpy(), np.asarray(ref_feats[k]),
                                   err_msg=k, **TOL)


def test_decode_matches_jax(pair):
    jm, variables, port = pair
    rng = np.random.default_rng(2)
    f = rng.standard_normal((3, 9, 9, 4096)).astype(np.float32)
    ref = jax.jit(lambda v, f: jm.apply(v, f, train=False, method="decode"))(variables, f)
    with torch.no_grad():
        ours = port.decode(torch.from_numpy(f))
    assert ours.shape == (3, 9, 9, 5)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), **TOL)


def test_forward_matches_jax(pair):
    """The full network: encode, decode, upsample back to the 8k+1 input."""
    jm, variables, port = pair
    rng = np.random.default_rng(3)
    x = rng.standard_normal((1, 65, 65, 3)).astype(np.float32)
    ref = jax.jit(lambda v, x: jm.apply(v, x, train=False))(variables, x)["pred"]
    with torch.no_grad():
        ours = port(torch.from_numpy(x))["pred"]
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), **TOL)


def test_bf16_compute_keeps_f32_parameters(pair):
    """dtype=bf16 behaves like flax dtype=bf16, param_dtype=f32: parameters
    stay f32, activations come out bf16 and track the f32 network."""
    _, variables, port = pair
    half = build_model("pspnet", layers=50, with_aux=False, dtype=torch.bfloat16)
    half.load_state_dict(port.state_dict(), strict=True)
    assert all(p.dtype == torch.float32 for p in half.parameters())
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (1, 33, 33, 3)).astype(np.float32))
    with torch.no_grad():
        f32 = port.encode(x)[0]
        b16 = half.encode(x)[0]
    assert b16.dtype == torch.bfloat16
    rel = (b16.float() - f32).norm() / f32.norm()
    assert rel < 0.05, rel  # bf16 through ~50 layers: a few percent


def test_init_from_generator_is_reproducible():
    a = init_from_generator_(build_model("pspnet", with_aux=False),
                             torch.Generator().manual_seed(3))
    b = init_from_generator_(build_model("pspnet", with_aux=False),
                             torch.Generator().manual_seed(3))
    for (k, va), vb in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(va, vb), k
    bn = a.layer1[0].bn1
    assert not torch.equal(bn.running_var, torch.ones_like(bn.running_var))


def test_training_mode_raises():
    """Training mode raises only where a dropout has neither a generator nor
    an injected keep mask: all three architectures train (PSPNet since the
    first training slice; DeepLabV3's ASPP and FCNHead dropout and the
    ViT's dropout since the second, held to the JAX package in
    tests/test_torch_train_models.py). Each one's encode runs in training
    mode; DeepLabV3's moves the BN running statistics, and its forward
    returns the aux head's logits."""
    vit = build_model("vit", image_size=64).train()
    with pytest.raises(RuntimeError, match="generator"):
        vit.encode(torch.zeros(1, 64, 64, 3))
    with dropout_generator(vit, torch.Generator().manual_seed(0)):
        f, _ = vit.encode(torch.zeros(1, 64, 64, 3))
    assert f.shape == (1, 2, 2, 768)
    dl = build_model("deeplabv3", layers=50, with_aux=True).train()
    before = dl.backbone.layer1[0].bn1.running_mean.clone()
    x = torch.randn(2, 33, 33, 3, generator=torch.Generator().manual_seed(0))
    dl.encode(x)
    assert not torch.equal(before, dl.backbone.layer1[0].bn1.running_mean)
    with pytest.raises(RuntimeError, match="generator"):
        dl.decode(torch.zeros(1, 5, 5, 2048))
    with dropout_generator(dl, torch.Generator().manual_seed(0)):
        out = dl(x)
    assert set(out) == {"pred", "aux"} and out["aux"].shape == (2, 33, 33, 5)
    m = build_model("pspnet", layers=50, with_aux=False).train()
    before = m.layer1[0].bn1.running_mean.clone()
    m.encode(torch.randn(2, 33, 33, 3, generator=torch.Generator().manual_seed(0)))
    assert not torch.equal(before, m.layer1[0].bn1.running_mean)
