"""The port's Segmenter ViT and its weight bridge against the JAX package,
on the CPU.

Weights: JAX ``init(PRNGKey(0))`` with every LayerNorm's scale and bias,
every Dense bias and the cls token replaced by seeded numpy values
(tests/torch_port_fixtures.py::vit_pair), carried across by
``from_jax_variables``. A narrow ViT/32 (d = 128, 2 heads, 2 encoder and 2
decoder layers) at 64 px, in float32 and in bf16 (float32 parameters, both
packages computing in bf16); one case at the full width of ViT-B/32.

Tolerances, each a share of the reference's largest magnitude. float32:
F32_SHARE (1e-5) for a module, 1e-4 for a whole network, the logits'
bound of the flow tests: the same products summed in other orders. bf16:
each test states its bound in bf16 ulps at that magnitude (2**-8 of it a
ulp), beside what it measured. The packages round the same operations in
the same order (a Linear's product, then its bias add; q.k^T, then the
scale), but their float32 accumulations inside a rounding differ, so a
value near a bf16 rounding boundary lands one ulp apart, and the next
layers carry that on. The mask logits go through a LayerNorm over the 5
classes, whose spread is small, so the decoder's gaps grow most.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import flax.linen as fnn
from floodseg_tpu.models import build_model as jax_build_model
from floodseg_tpu.models import vit as jvit
from floodseg_tpu.models.lightning_export import export_mask_transformer, export_vit_encoder

from floodseg_tpu_torch.models import (
    SegmenterViT,
    build_model,
    from_jax_variables,
    init_from_generator_,
    load_jax_variables,
)
from floodseg_tpu_torch.models import vit
from floodseg_tpu_torch.models.layers import LayerNorm, Linear, dropout_generator
from floodseg_tpu_torch.train.flow import decode_split_ok

from torch_port_fixtures import vit_pair
from torch_port_fixtures import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

F32_SHARE = 1e-5
NET_SHARE = 1e-4
BF16_ULP = 2.0 ** -8  # of the largest magnitude's binade, at most
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(scope="module", params=list(DTYPES))
def pair(request):
    """(dtype tag, jax model, variables, port model) for each dtype."""
    jdt, _ = DTYPES[request.param]
    return (request.param,) + vit_pair(size=64, dtype=jdt)


def _inputs(rng, shape, tag):
    """The same values for both packages, rounded to bf16 for bf16."""
    x = rng.standard_normal(shape).astype(np.float32)
    jdt, tdt = DTYPES[tag]
    return jnp.asarray(x, jdt), torch.from_numpy(x).to(tdt)


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def assert_close(ours, ref, tag, bf16_ulps, f32_share=F32_SHARE):
    """Within f32_share (float32) or bf16_ulps bf16 ulps (bf16) of the
    reference's largest magnitude; returns the gap in that unit."""
    ours, ref = _np(ours), _np(ref)
    assert ours.shape == ref.shape
    scale = float(np.abs(ref).max())
    unit = f32_share if tag == "f32" else BF16_ULP
    limit = f32_share if tag == "f32" else bf16_ulps * BF16_ULP
    gap = float(np.abs(ours - ref).max()) / scale
    assert gap <= limit, (gap / unit, limit / unit)
    return gap / unit


def _apply(module, params, *args, **kw):
    return module.apply({"params": params}, *args, **kw)


# ------------------------------------------------------------ the layers

def test_linear_matches_flax_dense(pair):
    """bf16: the product rounded, then the bias add rounded, on both sides:
    within 1 ulp (0.27 measured)."""
    tag, _, v, port = pair
    jdt, _ = DTYPES[tag]
    xj, xt = _inputs(np.random.default_rng(0), (2, 5, 128), tag)
    p = v["params"]["encoder"]["block0"]["attn"]["qkv"]
    ref = _apply(fnn.Dense(384, dtype=jdt, param_dtype=jnp.float32, precision="highest"),
                 p, xj)
    with torch.no_grad():
        ours = port.encoder.blocks[0].attn.qkv(xt)
    assert ours.dtype == DTYPES[tag][1]
    assert_close(ours, ref, tag, bf16_ulps=1)


def test_linear_rounds_product_then_bias_in_bf16():
    """On integer inputs every float32 sum of the product is exact in any
    order, so the bf16 rounding order alone decides the result: the port
    and flax's Dense both equal round(round(x @ W) + b), replayed in numpy,
    on lanes where that differs from the fused round(x @ W + b)."""
    rng = np.random.default_rng(3)
    x = rng.integers(-16, 17, (8, 32)).astype(np.float32)
    w = rng.integers(-16, 17, (32, 128)).astype(np.float32)
    b = (rng.integers(-32, 33, 128) / 4).astype(np.float32)
    p = x @ w  # |p| < 2**14: exact
    bf = jnp.bfloat16
    twice = (p.astype(bf).astype(np.float32) + b).astype(bf).astype(np.float32)
    once = (p + b).astype(bf).astype(np.float32)
    assert (twice != once).sum() >= 8
    lin = Linear(32, 128, dtype=torch.bfloat16)
    lin.weight.data, lin.bias.data = torch.from_numpy(w.T.copy()), torch.from_numpy(b)
    with torch.no_grad():
        ours = lin(torch.from_numpy(x).to(torch.bfloat16))
    ref = _apply(fnn.Dense(128, dtype=bf, param_dtype=jnp.float32, precision="highest"),
                 {"kernel": w, "bias": b}, jnp.asarray(x, bf))
    np.testing.assert_array_equal(_np(ours), twice)
    np.testing.assert_array_equal(_np(ref), twice)


def test_layer_norm_matches_flax(pair):
    """bf16 output of float32 statistics: within 1 ulp (0 measured)."""
    tag, _, v, port = pair
    jdt, tdt = DTYPES[tag]
    xj, xt = _inputs(np.random.default_rng(1), (2, 5, 128), tag)
    ln = fnn.LayerNorm(epsilon=1e-5, dtype=jdt, param_dtype=jnp.float32)
    ref = _apply(ln, v["params"]["encoder"]["block0"]["norm1"], xj)
    with torch.no_grad():
        ours = port.encoder.blocks[0].norm1(xt)
    assert ours.dtype == tdt
    assert_close(ours, ref, tag, bf16_ulps=1)


def test_layer_norm_takes_flax_fast_variance():
    """float32 pins the formula: on values k/4 + 50 every sum is exact in
    any order, so mean and E[x^2] are the same everywhere, and flax's
    max(0, E[x^2] - E[x]^2), rsqrt(var + eps) * scale, (x - mean) * mul +
    bias, replayed step by step in numpy float32, is what both packages
    give (within 2 float32 ulps: rsqrt may round either way). The two-pass
    variance of ``F.layer_norm`` is further off than that."""
    rng = np.random.default_rng(2)
    x = (50 + rng.integers(-8, 9, (4, 128)) / 4).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, 128).astype(np.float32)
    bias = rng.normal(0, 0.1, 128).astype(np.float32)
    mean = x.mean(-1, keepdims=True)
    var = np.maximum(np.float32(0), (x * x).mean(-1, keepdims=True) - mean * mean)
    mul = (np.float32(1) / np.sqrt(var + np.float32(1e-5))) * scale
    want = (x - mean) * mul + bias
    ref = np.asarray(_apply(fnn.LayerNorm(epsilon=1e-5), {"scale": scale, "bias": bias}, x))
    ln = LayerNorm(128)
    ln.weight.data, ln.bias.data = torch.from_numpy(scale), torch.from_numpy(bias)
    with torch.no_grad():
        ours = ln(torch.from_numpy(x)).numpy()
        two_pass = F.layer_norm(torch.from_numpy(x), (128,), ln.weight, ln.bias, 1e-5).numpy()
    ulp = np.spacing(np.abs(want).max())
    np.testing.assert_allclose(ours, want, rtol=0, atol=2 * ulp)
    np.testing.assert_allclose(ref, want, rtol=0, atol=2 * ulp)
    assert np.abs(two_pass - want).max() > 8 * ulp


def test_patchify_and_patch_embedding_match_jax(pair):
    """patchify's (py, px, c) feature order, and the reference's conv
    weight (D, C, P, P) applied as the JAX package's (P*P*C, D) kernel:
    equal to flax's Dense over JAX's patchify (bf16 within 1 ulp, 0
    measured), and in float32 to the stride-P convolution it stands for."""
    tag, _, v, port = pair
    jdt, _ = DTYPES[tag]
    x = np.random.default_rng(3).standard_normal((2, 64, 96, 3)).astype(np.float32)
    tokens = vit.patchify(torch.from_numpy(x), 32)
    np.testing.assert_array_equal(tokens.numpy(), np.asarray(jvit.patchify(jnp.asarray(x), 32)))
    dense = fnn.Dense(128, dtype=jdt, param_dtype=jnp.float32, precision="highest")
    ref = _apply(dense, v["params"]["encoder"]["patch_proj"], jvit.patchify(jnp.asarray(x), 32))
    embed = port.encoder.patch_embed
    with torch.no_grad():
        ours = embed(torch.from_numpy(x))
        conv = F.conv2d(torch.from_numpy(x).permute(0, 3, 1, 2), embed.proj.weight,
                        embed.proj.bias, stride=32)
    assert ours.shape == (2, 6, 128)
    assert_close(ours, ref, tag, bf16_ulps=1)
    if tag == "f32":
        assert_close(ours, conv.flatten(2).transpose(1, 2), tag, 0)


def test_attention_matches_jax(pair):
    """bf16 within 2 ulps (0 measured; a one-ulp qkv lane would move the
    scores, the probabilities and the product with v)."""
    tag, _, v, port = pair
    jdt, _ = DTYPES[tag]
    xj, xt = _inputs(np.random.default_rng(4), (2, 7, 128), tag)
    ref = _apply(jvit.Attention(2, 0.0, jdt), v["params"]["encoder"]["block0"]["attn"],
                 xj, train=False)
    with torch.no_grad():
        ours = port.encoder.blocks[0].attn(xt)
    assert_close(ours, ref, tag, bf16_ulps=2)


def test_attention_scale_is_rounded_to_dtype():
    """hd**-0.5 as the JAX package's weakly typed scalar meets bf16 scores:
    rounded to bf16 (hd = 96: 0.10206... -> 0.10205078125); exact in
    float32 up to float32's rounding."""
    assert vit.Attention(192, 2, torch.bfloat16).scale == 0.10205078125
    assert vit.Attention(192, 2).scale == float(np.float32(96 ** -0.5))
    assert vit.Attention(768, 12, torch.bfloat16).scale == 0.125


def test_feed_forward_matches_jax(pair):
    """Exact (erf) GELU between the two Linears; bf16 within 2 ulps (0.77
    measured)."""
    tag, _, v, port = pair
    jdt, _ = DTYPES[tag]
    xj, xt = _inputs(np.random.default_rng(5), (2, 7, 128), tag)
    ref = _apply(jvit.FeedForward(512, 0.0, jdt), v["params"]["encoder"]["block0"]["mlp"],
                 xj, train=False)
    with torch.no_grad():
        ours = port.encoder.blocks[0].mlp(xt)
    assert_close(ours, ref, tag, bf16_ulps=2)


def test_block_matches_jax(pair):
    """Pre-norm residual block; bf16 within 2 ulps (0.71 measured)."""
    tag, _, v, port = pair
    jdt, _ = DTYPES[tag]
    xj, xt = _inputs(np.random.default_rng(6), (2, 7, 128), tag)
    ref = _apply(jvit.Block(2, 512, 0.0, 0.0, jdt), v["params"]["decoder"]["block1"],
                 xj, train=False)
    with torch.no_grad():
        ours = port.decoder.blocks[1](xt)
    assert_close(ours, ref, tag, bf16_ulps=2)


def test_resize_pos_embed_matches_jax():
    """The float32 position grid 5x5 -> 3x4 (align_corners=False), the cls
    entry kept in front."""
    pos = np.random.default_rng(7).standard_normal((1, 26, 16)).astype(np.float32)
    ref = np.asarray(jvit.resize_pos_embed(jnp.asarray(pos), (5, 5), (3, 4)))
    ours = vit.resize_pos_embed(torch.from_numpy(pos), (5, 5), (3, 4)).numpy()
    assert ours.shape == (1, 13, 16)
    np.testing.assert_array_equal(ours[:, 0], pos[:, 0])
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-6)


@pytest.mark.parametrize("hw", [(64, 64), (96, 64)], ids=["at_image_size", "resized_pos"])
def test_vision_transformer_matches_jax(pair, hw):
    """The encoder's (B, 1 + h*w, D) features; at 96x64 the token count
    differs from image_size's (2x2) and the position grid is resized to
    3x2. bf16 within 4 ulps (1.93 measured) through two blocks and the
    norm."""
    tag, _, v, port = pair
    jdt, _ = DTYPES[tag]
    x = np.random.default_rng(8).standard_normal((2,) + hw + (3,)).astype(np.float32)
    enc = jvit.VisionTransformer(image_size=64, patch_size=32, n_layers=2, d_model=128,
                                 n_heads=2, dropout=0.0, dtype=jdt)
    ref = _apply(enc, v["params"]["encoder"], jnp.asarray(x), train=False)
    with torch.no_grad():
        ours = port.encoder(torch.from_numpy(x))
    assert ours.shape == (2, 1 + hw[0] * hw[1] // 1024, 128)
    assert_close(ours, ref, tag, bf16_ulps=4)


def test_mask_transformer_matches_jax(pair):
    """(B, N, D) tokens -> (B, gh, gw, classes) mask logits: proj_dec, the
    class embeddings after the patches, two blocks, the L2-normalised
    projections, the masks product and mask_norm. bf16 within 12 ulps (4.99
    measured): mask_norm normalises 5 values of a small spread."""
    tag, _, v, port = pair
    jdt, _ = DTYPES[tag]
    xj, xt = _inputs(np.random.default_rng(9), (2, 6, 128), tag)
    dec = jvit.MaskTransformer(n_cls=5, patch_size=32, d_model=128, n_layers=2, n_heads=2,
                               dropout=0.0, dtype=jdt)
    ref = _apply(dec, v["params"]["decoder"], xj, (64, 96), train=False)
    with torch.no_grad():
        ours = port.decoder(xt, (64, 96))
    assert ours.shape == (2, 2, 3, 5)
    assert_close(ours, ref, tag, bf16_ulps=12)


def test_decoder_linear_matches_jax():
    """decoder_type="linear": one Linear over the tokens, reshaped to the
    patch grid; through the whole network at 64x96 (float32), its weights
    across the bridge as ``decoder.head``."""
    jm, v, port = vit_pair(size=64, decoder_type="linear")
    assert isinstance(port.decoder, vit.DecoderLinear)
    assert "decoder.head.weight" in port.state_dict()
    x = np.random.default_rng(10).standard_normal((2, 64, 96, 3)).astype(np.float32)
    ref = jm.apply(v, jnp.asarray(x), train=False)["pred"]
    f, _ = jm.apply(v, jnp.asarray(x), train=False, method="encode")
    ref_dec = jm.apply(v, f, train=False, method="decode")
    with torch.no_grad():
        ours = port(torch.from_numpy(x))["pred"]
        ours_dec = port.decode(port.encode(torch.from_numpy(x))[0])
    assert ours_dec.shape == (2, 2, 3, 5)
    assert_close(ours_dec, ref_dec, "f32", 0, NET_SHARE)
    assert_close(ours, ref, "f32", 0, NET_SHARE)


# ------------------------------------------------------------- the model

def test_forward_with_padding_matches_jax(pair):
    """A 70x50 frame is zero-padded to 96x64, the mask logits upsampled to
    that with align_corners=False and cropped back to 70x50. bf16 within 24
    ulps (9.08 measured), what mask_norm makes of the encoder's gaps."""
    tag, jm, v, port = pair
    jdt, _ = DTYPES[tag]
    x = np.random.default_rng(11).standard_normal((2, 70, 50, 3)).astype(np.float32)
    ref = jm.apply(v, jnp.asarray(x), train=False)["pred"]
    with torch.no_grad():
        ours = port(torch.from_numpy(x))["pred"]
    assert ours.shape == (2, 70, 50, 5) and ours.dtype == DTYPES[tag][1]
    assert_close(ours, ref, tag, bf16_ulps=24, f32_share=NET_SHARE)


def test_encode_decode_match_jax(pair):
    """encode -> the (B, H/P, W/P, D) token map, row-major as the JAX
    package reshapes it; decode -> (B, gh, gw, classes). bf16 within 4 ulps
    (encode, 1.44 measured) and 24 (decode of JAX's map, 11.0 measured)."""
    tag, jm, v, port = pair
    xj, xt = _inputs(np.random.default_rng(12), (2, 64, 96, 3), "f32")
    ref, aux = jm.apply(v, xj, train=False, method="encode")
    ref_dec = jm.apply(v, ref, train=False, method="decode")
    with torch.no_grad():
        ours, none = port.encode(xt)
        ours_dec = port.decode(torch.from_numpy(_np(ref).copy()).to(DTYPES[tag][1]))
    assert aux is None and none is None
    assert ours.shape == (2, 2, 3, 128) and ours.is_contiguous()
    assert_close(ours, ref, tag, bf16_ulps=4)
    assert ours_dec.shape == (2, 2, 3, 5)
    assert_close(ours_dec, ref_dec, tag, bf16_ulps=24, f32_share=NET_SHARE)


def test_token_grid_order_composes_to_forward():
    """decode(encode(x)) upsampled is forward's pred to float32 rounding,
    and the token map is the encoder's patch tokens in row-major (gh, gw)
    order: token 1 + r * gw + c sits at [r, c]."""
    _, _, port = vit_pair(size=96)
    x = torch.from_numpy(np.random.default_rng(13).standard_normal((2, 96, 64, 3)).astype(
        np.float32))
    with torch.no_grad():
        want = port(x)["pred"]
        f, _ = port.encode(x)
        feats = port.encoder(x)
        got = vit.resize_bilinear(port.decode(f), (96, 64), align_corners=False)
    assert f.shape == (2, 3, 2, 128)
    for r in range(3):
        for c in range(2):
            assert torch.equal(f[:, r, c], feats[:, 1 + r * 2 + c])
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6, atol=1e-6)


def test_encode_raises_on_frames_off_the_patch_grid():
    port = SegmenterViT(image_size=64, d_model=64, n_layers=1, dec_layers=1, n_heads=1).eval()
    with pytest.raises(ValueError, match="multiple of 32"):
        port.encode(torch.zeros((1, 65, 64, 3)))


def test_modules_raise_in_training_mode():
    """In training mode the ViT's dropout needs a generator or an injected
    keep mask and raises without one: the port never draws from torch's
    global generator. With a generator the model and each module run."""
    port = init_from_generator_(
        SegmenterViT(image_size=64, d_model=64, n_layers=1, dec_layers=1, n_heads=1),
        torch.Generator().manual_seed(0))
    x = torch.zeros((1, 64, 64, 3))
    for module, arg in ((port.train(), x), (port.encoder.blocks[0].mlp, torch.zeros(1, 2, 64))):
        with pytest.raises(RuntimeError, match="generator"):
            module(arg)
        with dropout_generator(module, torch.Generator().manual_seed(0)):
            assert torch.isfinite(module(arg)["pred"] if module is port else module(arg)).all()


def test_bridge_equals_lightning_export_and_strict_loads(pair):
    """Key for key and value for value ``export_vit_encoder(p["encoder"],
    "encoder.")`` with ``export_mask_transformer(p["decoder"],
    "decoder.")``; an init tree has no batch_stats and a train state's is
    empty, and both load strictly."""
    _, _, v, port = pair
    p = v["params"]
    ref = {**export_vit_encoder(p["encoder"], "encoder."),
           **export_mask_transformer(p["decoder"], "decoder.")}
    ours = from_jax_variables(v)
    assert "batch_stats" not in v
    assert sorted(ours) == sorted(ref) == sorted(port.state_dict())
    for k, val in ref.items():
        np.testing.assert_array_equal(ours[k], val, err_msg=k)
        assert ours[k].dtype == np.asarray(val).dtype == np.float32, k
    fresh = load_jax_variables(SegmenterViT(image_size=64, d_model=128, n_layers=2,
                                            dec_layers=2, n_heads=2),
                               {"params": p, "batch_stats": {}})
    for k, t in fresh.state_dict().items():
        np.testing.assert_array_equal(t.numpy(), ref[k], err_msg=k)


def test_build_model_vit_is_vit_b32_and_strict_loads_jax():
    """build_model("vit", classes=5, image_size=512, dtype=bf16), bench.py's
    model: ViT-B/32 (d = 768, 12 layers of 12 heads and MLP 3072) and a
    2-layer MaskTransformer, its keys and shapes those of the JAX factory's
    model through the bridge, which it strict-loads; no ``cls`` submodule,
    so a window decodes as one call."""
    port = build_model("vit", classes=5, image_size=512, dtype=torch.bfloat16)
    jm = jax_build_model("vit", classes=5, image_size=512, dtype=jnp.bfloat16)
    shapes = jax.eval_shape(lambda: jm.init({"params": jax.random.PRNGKey(0)},
                                            jnp.zeros((1, 512, 512, 3)), train=False))
    variables = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    sd = port.state_dict()
    assert {k: v.shape for k, v in from_jax_variables(variables).items()} == {
        k: tuple(t.shape) for k, t in sd.items()}
    load_jax_variables(port, variables)
    assert sd["encoder.pos_embed"].shape == (1, 257, 768)
    assert sd["encoder.patch_embed.proj.weight"].shape == (768, 3, 32, 32)
    assert sd["encoder.blocks.11.mlp.fc1.weight"].shape == (3072, 768)
    assert len(port.encoder.blocks) == 12 and len(port.decoder.blocks) == 2
    assert port.encoder.blocks[0].attn.heads == 12
    assert port.encoder.blocks[0].attn.qkv.compute_dtype == torch.bfloat16
    assert not port.training and not hasattr(port, "cls") and not decode_split_ok(port)


def test_full_width_vit_b32_matches_jax():
    """ViT-B/32 at full width (d = 768, 12 layers, 12 heads, 2 decoder
    layers) through build_model at 64 px, float32: forward and encode
    within 1e-4 of their largest magnitude."""
    jm, v, _ = vit_pair(size=64, d_model=768, n_layers=12, dec_layers=2, n_heads=12)
    port = load_jax_variables(build_model("vit", classes=5, image_size=64), v)
    x = np.random.default_rng(14).standard_normal((2, 64, 64, 3)).astype(np.float32)
    ref = jm.apply(v, jnp.asarray(x), train=False)["pred"]
    ref_enc, _ = jm.apply(v, jnp.asarray(x), train=False, method="encode")
    with torch.no_grad():
        ours = port(torch.from_numpy(x))["pred"]
        ours_enc, _ = port.encode(torch.from_numpy(x))
    assert ours.shape == (2, 64, 64, 5) and ours_enc.shape == (2, 2, 2, 768)
    assert_close(ours_enc, ref_enc, "f32", 0, NET_SHARE)
    assert_close(ours, ref, "f32", 0, NET_SHARE)


def test_full_width_vit_b32_bf16_matches_jax():
    """The same in bf16, the bounds that chip_smoke.py holds the card to
    against the CPU: encode within 8 ulps (4.11 measured; twelve blocks
    carry more one-ulp lanes on than the narrow model's two, held to 4),
    forward within 24 (9.92 measured)."""
    jm, v, _ = vit_pair(size=64, dtype=jnp.bfloat16, d_model=768, n_layers=12,
                        dec_layers=2, n_heads=12)
    port = load_jax_variables(build_model("vit", classes=5, image_size=64,
                                          dtype=torch.bfloat16), v)
    x = np.random.default_rng(14).standard_normal((2, 64, 64, 3)).astype(np.float32)
    ref = jm.apply(v, jnp.asarray(x), train=False)["pred"]
    ref_enc, _ = jm.apply(v, jnp.asarray(x), train=False, method="encode")
    with torch.no_grad():
        ours = port(torch.from_numpy(x))["pred"]
        ours_enc, _ = port.encode(torch.from_numpy(x))
    assert ours.dtype == ours_enc.dtype == torch.bfloat16
    assert_close(ours_enc, ref_enc, "bf16", bf16_ulps=8)
    assert_close(ours, ref, "bf16", bf16_ulps=24)


def test_init_from_generator_draws_the_vit():
    """Reproducible from one seed; no LayerNorm is the identity; every
    embedding and projection is drawn (none left at its zeros)."""
    def draw(seed):
        m = SegmenterViT(image_size=64, d_model=64, n_layers=1, dec_layers=1, n_heads=1)
        return init_from_generator_(m, torch.Generator().manual_seed(seed)).state_dict()

    a, b, c = draw(0), draw(0), draw(1)
    for k in a:
        assert torch.equal(a[k], b[k]) and not torch.equal(a[k], c[k]), k
        assert bool(a[k].abs().max() > 0), k
    for k in [k for k in a if "norm" in k and k.endswith("weight")]:
        assert 0 < float((a[k] - 1).abs().mean()) < 0.2, k
    assert abs(float(a["decoder.proj_patch"].std()) - 64 ** -0.5) < 0.01
