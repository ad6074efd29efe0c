"""The port's Segmenter ViT flow predict against the JAX package, on the
CPU.

64 px key frames, 4x4 block grids, n = 5, float32 weights
(tests/torch_port_fixtures.py::vit_pair, d = 128, 2 heads, 2 + 2 layers).
Two patch sizes: 32, whose 2x2 token map K1 up-samples to the 4x4 grid as
the main path's 16x16 map goes to 32x32, and 8, whose 8x8 map it
down-samples. The MaskTransformer decodes a window's key map and
interpolated maps as one call, as the JAX package does (its
``_decode_split_ok`` splits only for the PSPNet SegHead); it has no int8
form, and ``int8_decode=True`` raises in both packages.

Tolerances: logits within 1e-4 of their largest magnitude (the network's
bound, tests/test_torch_vit.py); the builders' int32 maps equal wherever
the top-2 logit gap exceeds that, and the next-key token maps within
1e-4 of theirs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from floodseg_tpu.train.flow import make_cached_flow_predict_fn as jax_cached_fns
from floodseg_tpu.video import FlowInterpolator as JaxInterpolator

from floodseg_tpu_torch.models import SegmenterViT, init_from_generator_
from floodseg_tpu_torch.ops import launch_counts, reset_launch_counts
from floodseg_tpu_torch.train import make_cached_flow_predict_fn, make_flow_predict_fn
from floodseg_tpu_torch.train.flow import _predict_decode, decode_split_ok
from floodseg_tpu_torch.video import FlowInterpolator, default_grid

from torch_port_fixtures import builder_windows, jnorm, run_port_builders, smooth_grids, vit_pair
from torch_port_fixtures import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

SHARE = 1e-4
NO_LAUNCHES = {"grid_sample_cuda": 0, "grid_sample_backward_cuda": 0,
               "warp_chain_cuda": 0, "resize_quantize_int8_cuda": 0}
N, SIZE, OUT_SIZE = 5, 64, (72, 80)
PATCHES = [32, 8]


@pytest.fixture(scope="module", params=PATCHES, ids=[f"patch{p}" for p in PATCHES])
def pair(request):
    return vit_pair(size=SIZE, patch_size=request.param)


def _jax_interp(jm, variables):
    return JaxInterpolator(
        encode=lambda x: jm.apply(variables, x, train=False, method="encode")[0],
        decode=lambda f: jm.apply(variables, f, train=False, method="decode"))


def _assert_logits_close(ours, ref):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(ours), ref, rtol=0, atol=SHARE * np.abs(ref).max())


@pytest.mark.parametrize("tail", [False, True], ids=["window", "tail_window"])
def test_predict_clip_vit_matches_jax(pair, tail):
    jm, variables, port = pair
    rng = np.random.default_rng(0)
    fp = rng.standard_normal((1, SIZE, SIZE, 3)).astype(np.float32)
    fn = None if tail else rng.standard_normal((1, SIZE, SIZE, 3)).astype(np.float32)
    ml, mr = smooth_grids(rng, N - 1, 4, 4), smooth_grids(rng, N - 1, 4, 4)
    dg = default_grid(SIZE, SIZE)

    ref = _jax_interp(jm, variables).predict_clip(
        jnp.asarray(fp), None if tail else jnp.asarray(fn), jnp.asarray(ml),
        jnp.asarray(mr), N, default_grid=jnp.asarray(dg))
    reset_launch_counts()
    interp = FlowInterpolator(encode=lambda x: port.encode(x)[0],
                              decode=_predict_decode(port, False),
                              decode_split=decode_split_ok(port))
    with torch.no_grad():
        ours = interp.predict_clip(
            torch.from_numpy(fp), None if tail else torch.from_numpy(fn),
            torch.from_numpy(ml), torch.from_numpy(mr), N,
            default_grid=torch.from_numpy(dg)).numpy()
    # CPU tensors take the plain versions: no kernel launch is counted
    assert launch_counts() == NO_LAUNCHES
    # mask logits at token resolution, upsampled to the frame
    assert ours.shape == ref.shape == ((1 if tail else N), SIZE, SIZE, 5)
    _assert_logits_close(ours, ref)


@pytest.fixture(scope="module")
def jax_windows(pair):
    """Window 0 through JAX's full program and window 1 through its cached
    one, and JAX's logits of both windows (its interpolator, eagerly). The
    JAX builders get the frames normalised on the host; the port's take the
    raw uint8 frames."""
    jm, variables, _ = pair
    out = builder_windows(N, OUT_SIZE, frame_size=SIZE)
    wins, frames, dg = out["wins"], out["frames"], out["dg"]
    j_full, j_cached = jax_cached_fns(jm, n=N, out_size=OUT_SIZE, default_grid=dg)
    j0, jenc0 = j_full(variables, jnorm(frames[0]), jnorm(frames[1]),
                       wins[0]["mvs_left"], wins[0]["mvs_right"])
    j1, jenc1 = j_cached(variables, jenc0, jnorm(frames[3]),
                         wins[1]["mvs_left"], wins[1]["mvs_right"])
    interp = _jax_interp(jm, variables)
    logits = [interp.predict_clip(
        jnorm(frames[0]) if i == 0 else None, jnorm(frames[2 * i + 1]),
        wins[i]["mvs_left"], wins[i]["mvs_right"], N, default_grid=jnp.asarray(dg),
        out_size=OUT_SIZE, f_prev_enc=None if i == 0 else jenc0) for i in (0, 1)]
    return dict(out, maps=(j0, j1), encs=(jenc0, jenc1), logits=logits)


def _assert_builders_match_jax(maps, encs, single, ref):
    np.testing.assert_array_equal(single.numpy(), maps[0].numpy())
    for ours, theirs in zip(encs, ref["encs"]):
        _assert_logits_close(ours.numpy(), theirs)
    for ours, theirs, lg in zip(maps, ref["maps"], ref["logits"]):
        assert ours.dtype == torch.int32 and ours.shape == (N,) + OUT_SIZE
        lg = np.asarray(lg)
        top2 = np.sort(lg, axis=-1)[..., -2:]
        clear = (top2[..., 1] - top2[..., 0]) > SHARE * np.abs(lg).max()
        assert clear.mean() > 0.9
        np.testing.assert_array_equal(ours.numpy()[clear], np.asarray(theirs)[clear])


def test_predict_builders_vit_match_jax(pair, jax_windows):
    """Window 0 through the full programs, then window 1 through the cached
    one that reuses window 0's next-key token map, in both packages; the
    port's single-window builder gives the full program's maps."""
    _, _, port = pair
    reset_launch_counts()
    maps, encs, single = run_port_builders(port, port.state_dict(), jax_windows)
    assert launch_counts() == NO_LAUNCHES
    assert encs[0].shape == (1, SIZE // port.patch_size, SIZE // port.patch_size, 128)
    _assert_builders_match_jax(maps, encs, single, jax_windows)


def test_predict_builders_vit_bind_variables_not_module_weights(pair, jax_windows):
    """fn(variables, ...) depends on ``variables`` alone: built on a model
    whose own weights come from another seed and called with the fixture's
    variables, the builders give JAX's maps on those variables, and exactly
    what they give on the fixture's own model."""
    _, _, port = pair
    other = init_from_generator_(
        SegmenterViT(image_size=SIZE, patch_size=port.patch_size, d_model=128, n_layers=2,
                     dec_layers=2, n_heads=2).eval(),
        torch.Generator().manual_seed(11))
    maps, encs, single = run_port_builders(other, port.state_dict(), jax_windows)
    _assert_builders_match_jax(maps, encs, single, jax_windows)
    ref_maps, ref_encs, _ = run_port_builders(port, port.state_dict(), jax_windows)
    for a, b in zip(maps + encs, ref_maps + ref_encs):
        assert torch.equal(a, b)


def test_vit_decodes_a_window_as_one_call(pair, jax_windows, monkeypatch):
    """The builders decode the key map and the n - 1 interpolated maps as
    one batch for the MaskTransformer (no split, as for the DeepLabHead)."""
    _, _, port = pair
    assert not decode_split_ok(port)
    batches = []
    decode = port.decode
    monkeypatch.setattr(port, "decode", lambda f: batches.append(f.shape[0]) or decode(f))
    wins, frames = jax_windows["wins"], jax_windows["frames"]
    fn = make_flow_predict_fn(port, n=N, out_size=OUT_SIZE, default_grid=jax_windows["dg"],
                              device="cpu")
    fn(port.state_dict(), frames[0], frames[1], wins[0]["mvs_left"], wins[0]["mvs_right"])
    assert batches == [N]


def test_vit_has_no_int8_decoder_or_encoder(pair):
    """int8_decode raises ValueError, as the JAX package's _predict_decode
    does for the MaskTransformer; int8_encode raises ValueError, as the JAX
    package's _predict_encode does: the ViT has no ResNet trunk."""
    _, _, port = pair
    with pytest.raises(ValueError, match="use bf16 decode for other archs"):
        make_flow_predict_fn(port, n=N, int8_decode=True, device="cpu")
    with pytest.raises(ValueError, match="use bf16 decode for other archs"):
        make_cached_flow_predict_fn(port, n=N, int8_decode=True, device="cpu")
    with pytest.raises(ValueError, match="int8_encode supports the pspnet/deeplabv3"):
        make_flow_predict_fn(port, n=N, int8_encode=True, device="cpu")
