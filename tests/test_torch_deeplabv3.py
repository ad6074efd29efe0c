"""The port's DeepLabV3-50, its weight bridge and its int8 DeepLabHead
against the JAX package, on the CPU.

Weights: JAX ``init(PRNGKey(0))`` with every BN's scale, bias, mean and var
replaced by seeded numpy values (tests/torch_port_fixtures.py), carried
across by ``from_jax_variables``. 65 px inputs give 9x9x2048 encodings.
float32 parity is rtol = atol = 1e-4, the PSPNet tests' bound
(tests/test_torch_models.py): fifty-odd convolutions summed in different
orders (up to 4.2e-5 measured on c4, whose values reach 24).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from floodseg_tpu.models import build_model as jax_build_model
from floodseg_tpu.models.lightning_export import export_deeplabv3_variables
from floodseg_tpu.models.resnet import ResNetFeatures as JaxResNetFeatures
from floodseg_tpu.ops import pool as jpool
from floodseg_tpu.ops import quant as jq

from floodseg_tpu_torch.models import build_model, from_jax_variables, load_jax_variables
from floodseg_tpu_torch.models.resnet import ResNetFeatures
from floodseg_tpu_torch.ops import global_avg_pool, int8_deeplab_decode
from floodseg_tpu_torch.ops import quant as port_quant
from floodseg_tpu_torch.ops.quant import quantize_with_scale, scale_from_absmax

from test_torch_layouts import deeplabv3_inventory
from torch_port_fixtures import deeplabv3_pair

TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def pair():
    return deeplabv3_pair(size=65)


def _t(a):
    return torch.from_numpy(np.array(a))


def test_from_jax_variables_equals_lightning_export(pair):
    _, variables, port = pair
    ours = from_jax_variables(variables)
    ref = export_deeplabv3_variables(variables)
    assert sorted(ours) == sorted(ref)
    for k, v in ref.items():
        np.testing.assert_array_equal(ours[k], np.asarray(v), err_msg=k)
        assert ours[k].dtype == np.asarray(v).dtype, k
    assert sorted(port.state_dict()) == sorted(ref)


def test_with_aux_matches_export_and_torchvision_inventory():
    """with_aux=True: the bridge equals lightning_export key for key and
    value for value, the port's keys and shapes are torchvision's
    deeplabv3_resnet50 inventory, and the bridge's output strict-loads."""
    jm = jax_build_model("deeplabv3", classes=5, layers=50, with_aux=True)
    key = jax.random.PRNGKey(0)
    # the aux head only gets variables from a train-mode init
    shapes = jax.eval_shape(lambda: jm.init(
        {"params": key, "dropout": key}, jnp.zeros((1, 33, 33, 3)), train=True))
    rng = np.random.default_rng(0)
    variables = jax.tree_util.tree_map(
        lambda s: rng.standard_normal(s.shape).astype(s.dtype), shapes)
    ours = from_jax_variables(variables)
    ref = export_deeplabv3_variables(variables)
    assert sorted(ours) == sorted(ref)
    for k, v in ref.items():
        np.testing.assert_array_equal(ours[k], np.asarray(v), err_msg=k)
    port = build_model("deeplabv3", classes=5, layers=50, with_aux=True)
    inventory = deeplabv3_inventory(50, classes=5)
    assert {k: tuple(v.shape) for k, v in port.state_dict().items()} == inventory
    load_jax_variables(port, variables)
    np.testing.assert_array_equal(port.state_dict()["aux_classifier.4.bias"].numpy(),
                                  ours["aux_classifier.4.bias"])


@pytest.mark.parametrize("jdtype", [jnp.float32, jnp.bfloat16], ids=["f32", "bf16"])
def test_global_avg_pool_matches_jax(jdtype):
    """float32 within 1e-6 (sums in other orders); bf16 to the bit: both
    sum in float32 and round the mean once."""
    x = (np.random.default_rng(5).standard_normal((2, 9, 7, 64)) * 3).astype(np.float32)
    xj = jnp.asarray(x, jdtype)
    ref = np.asarray(jpool.global_avg_pool(xj).astype(jnp.float32))
    xt = _t(np.asarray(xj.astype(jnp.float32)))
    if jdtype == jnp.bfloat16:
        xt = xt.to(torch.bfloat16)
    ours = global_avg_pool(xt)
    assert ours.dtype == xt.dtype and ours.shape == (2, 1, 1, 64)
    if jdtype == jnp.bfloat16:
        np.testing.assert_array_equal(ours.float().numpy(), ref)
    else:
        np.testing.assert_allclose(ours.numpy(), ref, rtol=1e-6, atol=1e-6)


def test_trunk_matches_resnet_features(pair):
    """The torchvision-style trunk: 7x7/2 stem, layer3 at dilations
    [1, 2, 2, 2, 2, 2] and layer4 at [2, 4, 4], both at stride 1."""
    _, variables, port = pair
    trunk = port.backbone
    assert isinstance(trunk, ResNetFeatures) and not hasattr(trunk, "layer0")
    assert [b.conv2.dilation[0] for b in trunk.layer3] == [1, 2, 2, 2, 2, 2]
    assert [b.conv2.dilation[0] for b in trunk.layer4] == [2, 4, 4]
    jt = JaxResNetFeatures(depth=50, deep_base=False, semseg_dilation=False)
    x = np.random.default_rng(6).standard_normal((1, 65, 65, 3)).astype(np.float32)
    ref = jax.jit(lambda v, x: jt.apply(v, x, train=False))(
        {"params": variables["params"]["backbone"],
         "batch_stats": variables["batch_stats"]["backbone"]}, x)
    with torch.no_grad():
        ours = trunk.features(_t(x).permute(0, 3, 1, 2))
    for k, hw in (("c2", 9), ("c3", 9), ("c4", 9)):
        got = ours[k].permute(0, 2, 3, 1).numpy()
        assert got.shape[1:3] == (hw, hw)
        np.testing.assert_allclose(got, np.asarray(ref[k]), err_msg=k, **TOL)


def test_encode_matches_jax(pair):
    jm, variables, port = pair
    x = np.random.default_rng(1).standard_normal((2, 65, 65, 3)).astype(np.float32)
    ref, ref_feats = jax.jit(lambda v, x: jm.apply(v, x, train=False, method="encode"))(
        variables, x)
    with torch.no_grad():
        ours, feats = port.encode(_t(x))
    assert ours.shape == (2, 9, 9, 2048) and ours.is_contiguous()
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), **TOL)
    for k in ("c2", "c3", "c4"):
        np.testing.assert_allclose(feats[k].numpy(), np.asarray(ref_feats[k]),
                                   err_msg=k, **TOL)


def test_decode_matches_jax(pair):
    jm, variables, port = pair
    f = np.random.default_rng(2).standard_normal((3, 9, 9, 2048)).astype(np.float32)
    ref = jax.jit(lambda v, f: jm.apply(v, f, train=False, method="decode"))(variables, f)
    with torch.no_grad():
        ours = port.decode(_t(f))
    assert ours.shape == (3, 9, 9, 5)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), **TOL)


def test_decode_bf16_matches_jax(pair):
    """bf16 compute, float32 parameters, on both sides: ASPP, projection and
    head each round to bf16 after every conv and BN, in different summation
    orders. Held within 2**-6 of the logits' largest magnitude (four bf16
    ulps in its binade); 0.34% measured, about one ulp."""
    _, variables, port = pair
    jm = jax_build_model("deeplabv3", classes=5, layers=50, with_aux=False,
                         dtype=jnp.bfloat16)
    half = build_model("deeplabv3", layers=50, with_aux=False, dtype=torch.bfloat16)
    half.load_state_dict(port.state_dict(), strict=True)
    f = np.random.default_rng(7).standard_normal((2, 9, 9, 2048)).astype(np.float32)
    ref = jax.jit(lambda v, f: jm.apply(v, f, train=False, method="decode"))(
        variables, jnp.asarray(f, jnp.bfloat16))
    ref = np.asarray(ref.astype(jnp.float32))
    with torch.no_grad():
        ours = half.decode(_t(f).to(torch.bfloat16))
    assert ours.dtype == torch.bfloat16
    np.testing.assert_allclose(ours.float().numpy(), ref, rtol=0,
                               atol=2 ** -6 * np.abs(ref).max())


def test_forward_matches_jax(pair):
    """The full network, upsampled with align_corners=False."""
    jm, variables, port = pair
    x = np.random.default_rng(3).standard_normal((1, 65, 65, 3)).astype(np.float32)
    ref = jax.jit(lambda v, x: jm.apply(v, x, train=False))(variables, x)["pred"]
    with torch.no_grad():
        ours = port(_t(x))["pred"]
    assert ours.shape == (1, 65, 65, 5)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), **TOL)


# ------------------------------------------------------ int8 DeepLabHead

# the int8 maps of the concat and of the projection output may differ from
# JAX's by one step on at most this share of their lanes: the port folds
# its own weights (a one-ulp rsqrt difference), and float32 epilogues
# rounded in other orders can put a value on the other side of a rounding
# boundary (none measured on this test's inputs)
LANE_SHARE = 1e-4


def _record(monkeypatch, module, to_np):
    """Records (x_q, w_q, padding, dilation, acc) of every conv_int8 call
    that ``module``'s decoder makes."""
    seen = []
    conv = module.conv_int8

    def recording(x_q, w_q, padding, dilation=(1, 1), strides=(1, 1)):
        acc = conv(x_q, w_q, padding, dilation, strides)
        seen.append(tuple(to_np(a) for a in (x_q, w_q, acc)) + (padding, dilation))
        return acc

    monkeypatch.setattr(module, "conv_int8", recording)
    return seen


def assert_int8_maps_close(ours, ref, share=LANE_SHARE):
    """int8 maps: equal shapes, at most one step apart, on at most ``share``
    of the lanes."""
    assert len(ours) == len(ref)
    for a, b in zip(ours, ref):
        assert a.dtype == b.dtype == np.int8 and a.shape == b.shape
        d = np.abs(a.astype(np.int32) - b.astype(np.int32))
        assert d.max() <= 1 and (d != 0).mean() <= share, ((d != 0).mean(), d.max())


@pytest.mark.parametrize("pre_quantized", [False, True], ids=["float_input", "int8_input"])
def test_int8_deeplab_decode_matches_jax(pair, monkeypatch, pre_quantized):
    """float32 compute dtype. The input's int8 map is equal to JAX's (one
    scale, the same quantizer); the concat's and the projection's within
    LANE_SHARE; at every int8 conv, JAX's own int8 input and weights give
    JAX's int32 accumulator through the port's conv_int8, the dilated
    branches at rates 12, 24 and 36 included. Logits within 1e-3 of their
    largest magnitude, what a lane one step off moves them by (about
    sc * |w_f|); 5e-7 measured, no lane off."""
    _, variables, port = pair
    p, s = variables["params"]["classifier"], variables["batch_stats"]["classifier"]
    head = port.classifier.state_dict()
    f = np.random.default_rng(4).standard_normal((2, 9, 9, 2048)).astype(np.float32)
    bound = np.float32(np.abs(f).max() * 1.25)
    ja = jnp.asarray(bound) if pre_quantized else None
    ta = _t(bound) if pre_quantized else None
    jf, tf = jnp.asarray(f), _t(f)
    if pre_quantized:
        jf = jq.quantize_with_scale(jf, jq.scale_from_absmax(ja))
        tf = quantize_with_scale(tf, scale_from_absmax(ta))
        np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))

    jax_seen = _record(monkeypatch, jq, np.asarray)
    ref = np.asarray(jq.int8_deeplab_decode(p, s, jf, dtype=jnp.float32, act_absmax=ja))
    port_seen = _record(monkeypatch, port_quant, lambda a: a.numpy().copy())
    ours = int8_deeplab_decode(head, tf, dtype=torch.float32, act_absmax=ta)
    assert ours.shape == ref.shape == (2, 9, 9, 5) and ours.dtype == torch.float32

    # six int8 convs: four ASPP branches, the projection, the trailing 3x3
    assert len(port_seen) == len(jax_seen) == 6
    assert [c[4] for c in port_seen] == [c[4] for c in jax_seen] == [
        (1, 1), (12, 12), (24, 24), (36, 36), (1, 1), (1, 1)]
    monkeypatch.undo()
    for x_q, w_q, acc, padding, dilation in jax_seen:
        got = port_quant.conv_int8(_t(x_q), _t(w_q.transpose(3, 2, 0, 1)),
                                   padding, dilation)
        np.testing.assert_array_equal(got.numpy(), acc)
    # the int8 maps at the three quantizations: the input (the 4 branches
    # share it), the concat, the projection's output
    for c in port_seen[:4]:
        np.testing.assert_array_equal(c[0], jax_seen[0][0])
    assert_int8_maps_close([c[0] for c in port_seen[4:]], [c[0] for c in jax_seen[4:]])
    np.testing.assert_allclose(ours.numpy(), ref, rtol=0, atol=1e-3 * np.abs(ref).max())


def test_int8_deeplab_decode_raises_on_other_heads(pair):
    head = {k: v for k, v in pair[2].classifier.state_dict().items()
            if not k.startswith("0.project")}
    with pytest.raises(ValueError, match="DeepLabHead-shaped decoder"):
        int8_deeplab_decode(head, torch.zeros((1, 3, 3, 2048)))
