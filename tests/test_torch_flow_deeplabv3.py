"""The port's DeepLabV3-50 flow predict against the JAX package, on the CPU,
with either decoder.

65 px key frames (9x9x2048 encodings), 4x4 block grids, n = 5, float32
weights (tests/torch_port_fixtures.py::deeplabv3_pair). The DeepLabHead
decodes a window's key map and interpolated maps as one call, as the JAX
package does (its ``_decode_split_ok`` splits only for the PSPNet SegHead).

Tolerances. Full-precision decoder: logits at rtol = atol = 1e-4 (the
network's own parity bound, tests/test_torch_deeplabv3.py); the builders'
int32 maps equal wherever the top-2 logit gap exceeds 1e-4. int8 decoder:
the int8 maps at each of the three quantizations (the input, the ASPP
concat, the projection's output) at most one step from JAX's, on at most
LANE_SHARES of their lanes. Fed equal inputs the decoders agree to the
lane (tests/test_torch_deeplabv3.py); here the float32 encoders agree to
1e-4, which puts a few input values on the other side of a rounding
boundary, and each one-step lane moves many values of the next map:
measured 1.3e-5 of the input's lanes, 1.1e-4 of the concat's and 1.6e-3
of the projection's (window and tail window alike). Logits within
LOGIT_ATOL (0.0166 measured, at logits up to 2.44), and maps equal
wherever the top-2 gap exceeds twice that. A split decode would quantize
the concat and the projection at other scales and fail the int8 map check.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from floodseg_tpu.ops import quant as jq
from floodseg_tpu.train.flow import make_cached_flow_predict_fn as jax_cached_fns
from floodseg_tpu.video import FlowInterpolator as JaxInterpolator

from floodseg_tpu_torch.models import build_model, init_from_generator_
from floodseg_tpu_torch.ops import launch_counts, reset_launch_counts
from floodseg_tpu_torch.ops import quant as port_quant
from floodseg_tpu_torch.train import make_flow_predict_fn
from floodseg_tpu_torch.train.flow import _predict_decode, decode_split_ok
from floodseg_tpu_torch.video import FlowInterpolator, default_grid

from test_torch_deeplabv3 import assert_int8_maps_close
from torch_port_fixtures import (
    builder_windows,
    deeplabv3_pair,
    jnorm,
    run_port_builders,
    smooth_grids,
)

TOL = dict(rtol=1e-4, atol=1e-4)
LOGIT_ATOL = 0.05
LANE_SHARES = (1e-4, 1e-3, 1e-2)  # the input, the concat, the projection
NO_LAUNCHES = {"grid_sample_cuda": 0, "grid_sample_backward_cuda": 0,
               "warp_chain_cuda": 0, "resize_quantize_int8_cuda": 0}
N, OUT_SIZE = 5, (72, 80)


@pytest.fixture(scope="module")
def pair():
    return deeplabv3_pair(size=65)


def _jax_interp(jm, variables, int8):
    """JAX's interpolator with the builders' decoder (float32 compute)."""
    if int8:
        p, s = variables["params"]["classifier"], variables["batch_stats"]["classifier"]

        def decode(f, act_absmax=None):
            return jq.int8_deeplab_decode(p, s, f, dtype=jnp.float32, act_absmax=act_absmax)
    else:
        def decode(f):
            return jm.apply(variables, f, train=False, method="decode")
    return JaxInterpolator(
        encode=lambda x: jm.apply(variables, x, train=False, method="encode")[0],
        decode=decode, decode_wants_absmax=int8)


@pytest.fixture
def int8_maps(monkeypatch):
    """Records the int8 input of every int8 conv that the port's and JAX's
    DeepLabHead decoders run (JAX's when run eagerly)."""
    seen = {"port": [], "jax": []}
    port_conv, jax_conv = port_quant.conv_int8, jq.conv_int8

    def port_recording(x_q, *a, **k):
        seen["port"].append(x_q.numpy().copy())
        return port_conv(x_q, *a, **k)

    def jax_recording(x_q, *a, **k):
        seen["jax"].append(np.asarray(x_q))
        return jax_conv(x_q, *a, **k)

    monkeypatch.setattr(port_quant, "conv_int8", port_recording)
    monkeypatch.setattr(jq, "conv_int8", jax_recording)
    return seen


def _quantizations(maps):
    """The int8 maps of each decode call by quantization: the inputs (each
    shared by the four ASPP convs), the concats, the projections."""
    assert len(maps) % 6 == 0
    for i in range(0, len(maps), 6):
        for m in maps[i + 1:i + 4]:
            np.testing.assert_array_equal(m, maps[i])
    return maps[0::6], maps[4::6], maps[5::6]


@pytest.mark.parametrize("int8", [False, True], ids=["f32_decoder", "int8_decoder"])
@pytest.mark.parametrize("tail", [False, True], ids=["window", "tail_window"])
def test_predict_clip_deeplabv3_matches_jax(pair, int8_maps, int8, tail):
    jm, variables, port = pair
    rng = np.random.default_rng(0)
    fp = rng.standard_normal((1, 65, 65, 3)).astype(np.float32)
    fn = None if tail else rng.standard_normal((1, 65, 65, 3)).astype(np.float32)
    ml, mr = smooth_grids(rng, N - 1, 4, 4), smooth_grids(rng, N - 1, 4, 4)
    dg = default_grid(64, 64)

    ref = np.asarray(_jax_interp(jm, variables, int8).predict_clip(
        jnp.asarray(fp), None if tail else jnp.asarray(fn), jnp.asarray(ml),
        jnp.asarray(mr), N, default_grid=jnp.asarray(dg)))
    reset_launch_counts()
    interp = FlowInterpolator(encode=lambda x: port.encode(x)[0],
                              decode=_predict_decode(port, int8),
                              decode_wants_absmax=int8, decode_split=decode_split_ok(port))
    with torch.no_grad():
        ours = interp.predict_clip(
            torch.from_numpy(fp), None if tail else torch.from_numpy(fn),
            torch.from_numpy(ml), torch.from_numpy(mr), N,
            default_grid=torch.from_numpy(dg)).numpy()
    # CPU tensors take the plain versions: no kernel launch is counted
    assert launch_counts() == NO_LAUNCHES
    assert ours.shape == ref.shape == ((1 if tail else N), 65, 65, 5)
    if not int8:
        np.testing.assert_allclose(ours, ref, **TOL)
        return
    # one decode call over the whole window, 9x9 maps of 2048 channels in
    assert [m.shape for m in int8_maps["port"][::6]] == [((1 if tail else N), 9, 9, 2048)]
    for mine, theirs, share in zip(_quantizations(int8_maps["port"]),
                                   _quantizations(int8_maps["jax"]), LANE_SHARES):
        assert_int8_maps_close(mine, theirs, share)
    np.testing.assert_allclose(ours, ref, rtol=0, atol=LOGIT_ATOL)


@pytest.fixture(scope="module")
def jax_windows(pair):
    """Per decoder: window 0 through JAX's full program and window 1 through
    its cached one, and JAX's logits of both windows (its interpolator,
    eagerly). The JAX builders get the frames normalised on the host; the
    port's take the raw uint8 frames."""
    jm, variables, _ = pair
    out = builder_windows(N, OUT_SIZE)
    wins, frames, dg = out["wins"], out["frames"], out["dg"]
    for int8 in (False, True):
        j_full, j_cached = jax_cached_fns(jm, n=N, out_size=OUT_SIZE, default_grid=dg,
                                          int8_decode=int8)
        j0, jenc0 = j_full(variables, jnorm(frames[0]), jnorm(frames[1]),
                           wins[0]["mvs_left"], wins[0]["mvs_right"])
        j1, jenc1 = j_cached(variables, jenc0, jnorm(frames[3]),
                             wins[1]["mvs_left"], wins[1]["mvs_right"])
        interp = _jax_interp(jm, variables, int8)
        logits = [interp.predict_clip(
            jnorm(frames[0]) if i == 0 else None, jnorm(frames[2 * i + 1]),
            wins[i]["mvs_left"], wins[i]["mvs_right"], N, default_grid=jnp.asarray(dg),
            out_size=OUT_SIZE, f_prev_enc=None if i == 0 else jenc0) for i in (0, 1)]
        out[int8] = dict(maps=(j0, j1), encs=(jenc0, jenc1), logits=logits)
    return out


def _assert_builders_match_jax(maps, encs, single, ref, int8):
    np.testing.assert_array_equal(single.numpy(), maps[0].numpy())
    for ours, theirs in zip(encs, ref["encs"]):
        np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), **TOL)
    # the int8 gap leaves about 84% of these windows' pixels clear
    gap, share = (2 * LOGIT_ATOL, 0.8) if int8 else (1e-4, 0.9)
    for ours, theirs, lg in zip(maps, ref["maps"], ref["logits"]):
        assert ours.dtype == torch.int32 and ours.shape == (N,) + OUT_SIZE
        top2 = np.sort(np.asarray(lg), axis=-1)[..., -2:]
        clear = (top2[..., 1] - top2[..., 0]) > gap
        assert clear.mean() > share
        np.testing.assert_array_equal(ours.numpy()[clear], np.asarray(theirs)[clear])


@pytest.mark.parametrize("int8", [False, True], ids=["f32_decoder", "int8_decoder"])
def test_predict_builders_deeplabv3_match_jax(pair, jax_windows, int8):
    """Window 0 through the full programs, then window 1 through the cached
    one that reuses window 0's next-key encoding, in both packages; the
    port's single-window builder gives the full program's maps."""
    _, _, port = pair
    reset_launch_counts()
    maps, encs, single = run_port_builders(port, port.state_dict(), jax_windows,
                                           int8_decode=int8)
    assert launch_counts() == NO_LAUNCHES
    _assert_builders_match_jax(maps, encs, single, jax_windows[int8], int8)


@pytest.mark.parametrize("int8", [False, True], ids=["f32_decoder", "int8_decoder"])
def test_predict_builders_deeplabv3_bind_variables_not_module_weights(
        pair, jax_windows, int8):
    """fn(variables, ...) depends on ``variables`` alone: built on a model
    whose own weights come from another seed and called with the fixture's
    variables, the builders give JAX's maps on those variables, and exactly
    what they give on the fixture's own model."""
    _, _, port = pair
    other = init_from_generator_(build_model("deeplabv3", layers=50, with_aux=False),
                                 torch.Generator().manual_seed(11))
    maps, encs, single = run_port_builders(other, port.state_dict(), jax_windows,
                                           int8_decode=int8)
    _assert_builders_match_jax(maps, encs, single, jax_windows[int8], int8)
    ref_maps, ref_encs, _ = run_port_builders(port, port.state_dict(), jax_windows,
                                           int8_decode=int8)
    for a, b in zip(maps + encs, ref_maps + ref_encs):
        assert torch.equal(a, b)


def test_deeplabv3_decodes_a_window_as_one_call(pair, jax_windows, monkeypatch):
    """The builders decode the key map and the n - 1 interpolated maps as one
    batch for the DeepLabHead (no split), where PSPNet's SegHead takes two
    (tests/test_torch_flow.py)."""
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
