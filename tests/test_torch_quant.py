"""The port's int8 decoder and K3's plain version against the JAX package, on the CPU.

floodseg_tpu_torch/ops/quant.py against floodseg_tpu/ops/quant.py, and
floodseg_tpu_torch/ops/resize_kernels.py::resize_quantize_int8_plain
against floodseg_tpu/ops/pallas_resize.py::resize_quantize_int8 in
interpret mode. Inputs come from numpy with a fixed seed. The quantizers
and the int8 convolution are held to the bit; where a tolerance is used,
its reason is stated beside it. The JAX package's weights are HWIO, the
port's OIHW.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from floodseg_tpu.ops import quant as jq
from floodseg_tpu.ops.pallas_resize import resize_quantize_int8

from floodseg_tpu_torch.ops import (
    conv_int8,
    fold_bn,
    int8_seghead_decode,
    launch_counts,
    quantize_activation_dynamic,
    quantize_weight_per_channel,
    quantize_with_scale,
    reset_launch_counts,
    resize_quantize_int8_cuda,
    resize_quantize_int8_plain,
    scale_from_absmax,
    seghead_decode_folded_f32,
)

from torch_port_fixtures import pspnet50_pair

PAD1 = ((1, 1), (1, 1))


def _t(a):
    return torch.from_numpy(np.array(a))


def _oihw(w_hwio):
    return np.ascontiguousarray(np.asarray(w_hwio).transpose(3, 2, 0, 1))


@pytest.fixture(scope="module")
def head():
    """The PSPNet-50 fixture's cls head: the JAX (params, stats) subtrees
    and the port's head state (keys 0/1/4)."""
    _, variables, port = pspnet50_pair(size=65)
    return (variables["params"]["cls"], variables["batch_stats"]["cls"],
            port.cls.state_dict())


@pytest.fixture(scope="module")
def folded(head):
    """The head's BN-folded 3x3 weights in both packages."""
    p, s, h = head
    jw, jb = jq.fold_bn(jnp.asarray(p["conv1"]["kernel"]), p["bn"]["scale"],
                        p["bn"]["bias"], s["bn"]["mean"], s["bn"]["var"])
    tw, tb = fold_bn(h["0.weight"], h["1.weight"], h["1.bias"],
                     h["1.running_mean"], h["1.running_var"])
    return np.asarray(jw), np.asarray(jb), tw, tb


def test_fold_bn_matches_jax(folded):
    """float32 within 3 ulp (3 * 2^-23 relative): torch.rsqrt and XLA's
    rsqrt may differ by one ulp, and w * s rounds once more."""
    jw, jb, tw, tb = folded
    ulp3 = 3 * 2.0 ** -23
    np.testing.assert_allclose(tw.numpy(), _oihw(jw), rtol=ulp3, atol=0)
    # beta - mean * s: the same ulps, at the magnitude of the operands (~1)
    np.testing.assert_allclose(tb.numpy(), jb, rtol=ulp3, atol=ulp3)


def test_quantize_weight_per_channel_bit_exact(folded):
    """Fed JAX's folded weights (a one-ulp fold difference could flip a
    rounding at .5), the port's quantizer gives the same int8 and scales."""
    jw, _, _, _ = folded
    jwq, jsw = jq.quantize_weight_per_channel(jnp.asarray(jw))
    twq, tsw = quantize_weight_per_channel(_t(_oihw(jw)))
    assert twq.dtype == torch.int8
    np.testing.assert_array_equal(twq.numpy(), _oihw(jwq))
    np.testing.assert_array_equal(tsw.numpy(), np.asarray(jsw))
    # an all-zero channel takes the float32 tiny scale, not 0
    z = np.zeros((2, 3, 3, 3), np.float32)
    _, jz = jq.quantize_weight_per_channel(jnp.asarray(z.transpose(2, 3, 1, 0)))
    np.testing.assert_array_equal(quantize_weight_per_channel(_t(z))[1].numpy(),
                                  np.asarray(jz))


def test_scale_and_quantize_with_scale_bit_exact():
    """Exact .5 ties round half to even on both sides; values past the
    range clip to +-127."""
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((3, 5, 7, 16)) * 4).astype(np.float32)
    ties = np.array([0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5, -126.5, 300.0, -300.0],
                    np.float32)
    x[0, 0, 0, :10] = ties * 0.25
    for absmax in (np.float32(np.abs(x).max()), np.float32(0.0), np.float32(31.75)):
        js = jq.scale_from_absmax(jnp.asarray(absmax))
        ts = scale_from_absmax(_t(absmax))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
        np.testing.assert_array_equal(quantize_with_scale(_t(x), ts).numpy(),
                                      np.asarray(jq.quantize_with_scale(jnp.asarray(x), js)))
    q = quantize_with_scale(_t(ties), torch.tensor(1.0)).numpy()
    np.testing.assert_array_equal(q, [0, 2, 2, 0, -2, -2, 126, -126, 127, -127])
    # bf16 input computes in float32, as the JAX package's astype does
    xb = jnp.asarray(x, jnp.bfloat16)
    np.testing.assert_array_equal(
        quantize_with_scale(_t(np.asarray(xb.astype(jnp.float32))).to(torch.bfloat16),
                            torch.tensor(0.03125)).numpy(),
        np.asarray(jq.quantize_with_scale(xb, jnp.float32(0.03125))))


def test_quantize_activation_dynamic_bit_exact():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 4, 4, 32)).astype(np.float32)
    jx, jsx = jq.quantize_activation_dynamic(jnp.asarray(x))
    tx, tsx = quantize_activation_dynamic(_t(x))
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(tsx.numpy(), np.asarray(jsx))
    # with a precomputed bound larger than max|x|
    bound = np.float32(np.abs(x).max() * 1.5)
    jx, jsx = jq.quantize_activation_dynamic(jnp.asarray(x), absmax=jnp.asarray(bound))
    tx, tsx = quantize_activation_dynamic(_t(x), absmax=_t(bound))
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(tsx.numpy(), np.asarray(jsx))
    # an int8 input passes through untouched, with its bound's scale
    same, s = quantize_activation_dynamic(tx, absmax=_t(bound))
    assert same is tx
    np.testing.assert_array_equal(s.numpy(), np.asarray(jsx))
    with pytest.raises(ValueError, match="needs its absmax"):
        quantize_activation_dynamic(tx)


@pytest.fixture(scope="module")
def decode_conv():
    """One int8 3x3 conv at the decoder's widths, (2, 9, 9, 4096) x
    (3, 3, 4096, 512), through JAX once (its CPU int8 conv is slow)."""
    rng = np.random.default_rng(2)
    x = rng.integers(-127, 128, (2, 9, 9, 4096), dtype=np.int8)
    w = rng.integers(-127, 128, (3, 3, 4096, 512), dtype=np.int8)
    acc = np.asarray(jq.conv_int8(jnp.asarray(x), jnp.asarray(w), padding=PAD1))
    return x, w, acc


def test_conv_int8_matches_jax_at_decoder_widths(decode_conv):
    """K = 9 * 4096, N = 512: the int32 accumulator equals JAX's bit for bit
    (|acc| <= 36864 * 127^2 < 2^31, so the integer sum is exact)."""
    x, w, acc = decode_conv
    ours = conv_int8(_t(x), _t(_oihw(w)), padding=PAD1)
    assert ours.dtype == torch.int32 and ours.shape == acc.shape == (2, 9, 9, 512)
    np.testing.assert_array_equal(ours.numpy(), acc)


@pytest.mark.parametrize("kwargs,ksize", [
    (dict(padding=PAD1), 3),
    (dict(padding=((2, 2), (2, 2)), dilation=(2, 2)), 3),
    (dict(padding=((1, 0), (0, 1)), strides=(2, 2)), 3),
    (dict(padding=((0, 0), (0, 0))), 1),
], ids=["pad1", "dilated", "strided", "1x1"])
def test_conv_int8_matches_jax_options(kwargs, ksize):
    rng = np.random.default_rng(3)
    x = rng.integers(-127, 128, (2, 9, 10, 16), dtype=np.int8)
    w = rng.integers(-127, 128, (ksize, ksize, 16, 24), dtype=np.int8)
    ref = np.asarray(jq.conv_int8(jnp.asarray(x), jnp.asarray(w), **kwargs))
    ours = conv_int8(_t(x), _t(_oihw(w)), **kwargs)
    np.testing.assert_array_equal(ours.numpy(), ref)


@pytest.mark.parametrize("x_shape,w_shape", [
    ((1, 4, 4, 8), (3, 3, 8, 8)),      # M = 16
    ((1, 1, 1, 16), (3, 3, 16, 24)),   # M = 1, a one-pixel map
    ((1, 5, 5, 3), (3, 3, 3, 8)),      # K = 27
    ((1, 5, 5, 8), (3, 3, 8, 5)),      # N = 5
    ((2, 2, 3, 5), (3, 3, 5, 13)),     # M = 12, K = 45, N = 13
], ids=["M16", "M1", "K27", "N5", "all_three"])
def test_conv_int8_off_gemm_size_rules_matches_jax(x_shape, w_shape):
    """Shapes outside torch._int_mm's rules on the card (M > 16, K and N
    multiples of 8) are padded with zeros and sliced on every device: the
    int32 accumulator equals JAX's, which has no such rules."""
    rng = np.random.default_rng(sum(x_shape) + sum(w_shape))
    x = rng.integers(-127, 128, x_shape, dtype=np.int8)
    w = rng.integers(-127, 128, w_shape, dtype=np.int8)
    ref = np.asarray(jq.conv_int8(jnp.asarray(x), jnp.asarray(w), padding=PAD1))
    ours = conv_int8(_t(x), _t(_oihw(w)), padding=PAD1)
    assert ours.dtype == torch.int32 and ours.shape == ref.shape
    np.testing.assert_array_equal(ours.numpy(), ref)


def test_conv_int8_raises_on_non_int8_operands():
    x = torch.zeros((1, 4, 4, 8), dtype=torch.int8)
    w = torch.zeros((8, 8, 3, 3), dtype=torch.int8)
    with pytest.raises(TypeError, match="int8 operands"):
        conv_int8(x.float(), w, padding=PAD1)
    with pytest.raises(ValueError, match="channels"):
        conv_int8(x[..., :4].contiguous(), w, padding=PAD1)


def test_int8_seghead_decode_matches_jax(head):
    """The PSPNet-50 fixture's head, float32 compute dtype. The port folds
    and quantizes its own weights: a one-ulp rsqrt difference flips a few
    int8 weights by one step (6 of 18.9M here), which moves the logits by
    a few 1e-5 of their scale of ~3, hence rtol = atol = 1e-4 (the
    network's own parity bound)."""
    p, s, h = head
    rng = np.random.default_rng(4)
    f = rng.standard_normal((2, 9, 9, 4096)).astype(np.float32)
    bound = np.float32(np.abs(f).max() * 1.25)
    for absmax in (None, bound):
        ja = None if absmax is None else jnp.asarray(absmax)
        ta = None if absmax is None else _t(absmax)
        ref = np.asarray(jq.int8_seghead_decode(p, s, jnp.asarray(f), dtype=jnp.float32,
                                                act_absmax=ja))
        ours = int8_seghead_decode(h, _t(f), dtype=torch.float32, act_absmax=ta)
        assert ours.shape == ref.shape == (2, 9, 9, 5) and ours.dtype == torch.float32
        np.testing.assert_allclose(ours.numpy(), ref, rtol=1e-4, atol=1e-4)
    # a pre-quantized input decodes as the float input at the same bound
    fq = quantize_with_scale(_t(f), scale_from_absmax(_t(bound)))
    np.testing.assert_array_equal(
        int8_seghead_decode(h, fq, dtype=torch.float32, act_absmax=_t(bound)).numpy(),
        ours.numpy())


def test_int8_seghead_decode_bf16_rounds_where_jax_does(head, folded):
    """bf16 compute dtype, the same int8 weights on both sides (JAX's
    folded weights through the port's quantizer): the epilogue rounds to
    bf16 after the ReLU and after the 1x1 conv, as JAX's does. Within one
    bf16 ulp at the logits' scale: the 1x1 conv's float32 sums run in other
    orders before their bf16 rounding."""
    p, s, h = head
    jw, jb, _, _ = folded
    rng = np.random.default_rng(5)
    f = rng.standard_normal((1, 9, 9, 4096)).astype(np.float32)
    ref = np.asarray(jq.int8_seghead_decode(p, s, jnp.asarray(f, jnp.bfloat16),
                                            dtype=jnp.bfloat16).astype(jnp.float32))
    xb = _t(f).to(torch.bfloat16)
    x_q, sx = quantize_activation_dynamic(xb)
    w_q, sw = quantize_weight_per_channel(_t(_oihw(jw)))
    acc = conv_int8(x_q, w_q, padding=PAD1)
    y = torch.relu(acc.float() * (sx * sw) + _t(jb)).to(torch.bfloat16)
    out = torch.nn.functional.conv2d(y.permute(0, 3, 1, 2), h["4.weight"].to(torch.bfloat16))
    ours = (out.permute(0, 2, 3, 1) + h["4.bias"].to(torch.bfloat16)).float().numpy()
    scale = np.abs(ref).max()
    np.testing.assert_allclose(ours, ref, rtol=0, atol=scale * 2 ** -7)
    # and the port's own decode (its own fold) stays within 2 such ulps
    np.testing.assert_allclose(
        int8_seghead_decode(h, xb, dtype=torch.bfloat16).float().numpy(), ref,
        rtol=0, atol=scale * 2 ** -6)


def test_seghead_decode_folded_f32_matches_jax_and_the_head(head):
    """The folding algebra: the folded float32 head equals JAX's folded head
    and the port's unfolded head within 1e-5 of the logits' scale."""
    p, s, h = head
    rng = np.random.default_rng(6)
    f = rng.standard_normal((1, 9, 9, 4096)).astype(np.float32)
    ref = np.asarray(jq.seghead_decode_folded_f32(p, s, jnp.asarray(f)))
    ours = seghead_decode_folded_f32(h, _t(f)).numpy()
    tol = 1e-5 * np.abs(ref).max()
    np.testing.assert_allclose(ours, ref, rtol=0, atol=tol)
    # the unfolded head: conv3x3 -> BN -> ReLU -> conv1x1, in float32
    from floodseg_tpu_torch.models.pspnet import seg_head
    unfolded = seg_head(4096, 512, 5).eval()
    unfolded.load_state_dict(h)
    with torch.no_grad():
        plain = unfolded(_t(f).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(ours, plain, rtol=0, atol=tol)


def test_int8_seghead_decode_raises_on_other_heads(head):
    _, _, h = head
    partial_head = {k: v for k, v in h.items() if not k.startswith("1.")}
    with pytest.raises(ValueError, match="SegHead-shaped decoder"):
        int8_seghead_decode(partial_head, torch.zeros((1, 3, 3, 4096)))


# ------------------------------------------------------- K3's plain version

def _k3_case(shape, out_hw, jdtype, align, seed=0, x=None, scale=None):
    """(port plain, JAX interpret) int8 outputs on the same bf16/f32 input."""
    rng = np.random.default_rng(seed)
    if x is None:
        x = (rng.standard_normal(shape) * 3.0).astype(np.float32)
    xj = jnp.asarray(x, jdtype)
    if scale is None:
        scale = jq.scale_from_absmax(jnp.max(jnp.abs(xj.astype(jnp.float32))))
    scale = jnp.asarray(scale, jnp.float32)
    ref = np.asarray(resize_quantize_int8(xj, scale, out_hw, align, interpret=True))
    tdtype = torch.bfloat16 if jdtype == jnp.bfloat16 else torch.float32
    xt = _t(np.asarray(xj.astype(jnp.float32))).to(tdtype)
    ours = resize_quantize_int8_plain(xt, _t(np.asarray(scale)), out_hw, align)
    assert ours.dtype == torch.int8
    return ours.numpy(), ref


@pytest.mark.parametrize("jdtype", [jnp.bfloat16, jnp.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("align", [True, False])
def test_k3_plain_bit_equal_to_pallas_interpret(jdtype, align):
    """The flow-predict shape scaled down: grid resolution up to feature
    resolution. Equal to the bit in bf16 and in float32."""
    ours, ref = _k3_case((3, 16, 16, 128), (33, 33), jdtype, align)
    np.testing.assert_array_equal(ours, ref)


@pytest.mark.parametrize("shape,out_hw,align", [
    ((2, 7, 9, 128), (13, 11), True),     # odd in and out sizes
    ((1, 16, 16, 128), (5, 31), False),   # downsample one axis
    ((2, 5, 5, 256), (17, 17), True),     # two channel blocks in the TPU kernel
    ((2, 6, 5, 40), (11, 9), False),      # C not a multiple of 16
    ((1, 1, 4, 24), (3, 7), True),        # a one-pixel axis
])
@pytest.mark.parametrize("jdtype", [jnp.bfloat16, jnp.float32], ids=["bf16", "f32"])
def test_k3_plain_bit_equal_odd_shapes(shape, out_hw, align, jdtype):
    ours, ref = _k3_case(shape, out_hw, jdtype, align, seed=shape[1])
    np.testing.assert_array_equal(ours, ref)


def test_k3_plain_saturation_and_ties():
    """Values far past the clip range, tiny values, and exact .5 ties: an
    8 -> 15 upsample with align_corners=True puts every even output on a
    source pixel, so x = (k + 0.5) * scale lands on ties."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal((1, 8, 8, 128)).astype(np.float32)
    x[0, 0, 0, :4] = [1e4, -1e4, 0.0, 1e-8]
    x[0, 2, 2, :6] = [0.5, 1.5, 2.5, -0.5, -1.5, -2.5]
    ours, ref = _k3_case(None, (15, 15), jnp.bfloat16, True, x=x, scale=0.01)
    assert ref.min() == -127 and ref.max() == 127
    np.testing.assert_array_equal(ours, ref)
    ours, ref = _k3_case(None, (15, 15), jnp.bfloat16, True, x=x, scale=1.0)
    np.testing.assert_array_equal(ours[0, 4, 4, :6], [0, 2, 2, 0, -2, -2])
    np.testing.assert_array_equal(ours, ref)


def test_k3_wrapper_on_cpu_is_the_plain_version_and_counts_nothing():
    reset_launch_counts()
    rng = np.random.default_rng(8)
    x = _t(rng.standard_normal((2, 5, 6, 32)).astype(np.float32)).to(torch.bfloat16)
    s = torch.tensor(0.02)
    np.testing.assert_array_equal(resize_quantize_int8_cuda(x, s, (9, 11)).numpy(),
                                  resize_quantize_int8_plain(x, s, (9, 11)).numpy())
    assert launch_counts()["resize_quantize_int8_cuda"] == 0
