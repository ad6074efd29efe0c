"""The port's int8-decode flow predict against the JAX package, on the CPU.

PSPNet-50 at 65 px key frames (9x9x4096 encodings), 4x4 block grids,
n = 5, float32 weights. The JAX side runs eagerly, so the int8 maps its
decoder receives can be read; its CPU int8 convolution is slow, so each
window is decoded once.

Tolerances: the int8 maps the decoder receives may differ from JAX's by 1
on at most 1e-4 of their lanes (the float32 encoders agree to 1e-4, which
moves a few values across a rounding boundary; up to 1.2e-5 measured).
A lane one step off moves the logits of its 3x3 neighbourhood by about
sx * |w_f| (1.5e-3 measured on logits of scale ~3), so logits are held to
atol = 5e-3, and class maps must be equal wherever the top-2 logit gap
exceeds twice that.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from floodseg_tpu.ops import quant as jq
from floodseg_tpu.train.flow import make_cached_flow_predict_fn as jax_cached_fns
from floodseg_tpu.train.flow import make_flow_predict_fn as jax_predict_fn
from floodseg_tpu.video import FlowInterpolator as JaxInterpolator

from floodseg_tpu_torch.models import build_model, init_from_generator_
from floodseg_tpu_torch.ops import launch_counts, reset_launch_counts
from floodseg_tpu_torch.ops import quant as port_quant
from floodseg_tpu_torch.train import make_cached_flow_predict_fn, make_flow_predict_fn
from floodseg_tpu_torch.train.flow import _predict_decode
from floodseg_tpu_torch.video import FlowInterpolator, default_grid

from torch_port_fixtures import (
    builder_windows,
    jnorm,
    pspnet50_pair,
    run_port_builders,
    smooth_grids,
)

LOGIT_ATOL = 5e-3
LANE_SHARE = 1e-4
NO_LAUNCHES = {"grid_sample_cuda": 0, "grid_sample_backward_cuda": 0,
               "warp_chain_cuda": 0, "resize_quantize_int8_cuda": 0}


@pytest.fixture(scope="module")
def pair():
    return pspnet50_pair(size=65)


def _jax_int8_interp(jm, variables, seen):
    """JAX's interpolator with its int8 SegHead decoder (the JAX builders'
    closure, float32 compute dtype); ``seen`` collects the int8 maps."""
    p, s = variables["params"]["cls"], variables["batch_stats"]["cls"]

    def decode(f, act_absmax=None):
        seen.append(np.asarray(f))
        return jq.int8_seghead_decode(p, s, f, dtype=jnp.float32,
                                      act_absmax=act_absmax)

    return JaxInterpolator(
        encode=lambda x: jm.apply(variables, x, train=False, method="encode")[0],
        decode=decode, decode_wants_absmax=True, decode_split=True)


@pytest.fixture
def port_int8_maps(monkeypatch):
    """Records the int8 maps the port's decoder convolves."""
    seen = []
    conv = port_quant.conv_int8

    def recording(x_q, *a, **k):
        seen.append(x_q.numpy().copy())
        return conv(x_q, *a, **k)

    monkeypatch.setattr(port_quant, "conv_int8", recording)
    return seen


def _assert_int8_maps_close(ours, ref):
    assert len(ours) == len(ref)
    for a, b in zip(ours, ref):
        assert a.dtype == b.dtype == np.int8 and a.shape == b.shape
        d = np.abs(a.astype(np.int32) - b.astype(np.int32))
        assert d.max() <= 1
        assert (d != 0).mean() <= LANE_SHARE


@pytest.mark.parametrize("tail", [False, True], ids=["window", "tail_window"])
def test_predict_clip_int8_matches_jax(pair, port_int8_maps, tail):
    jm, variables, port = pair
    rng = np.random.default_rng(0)
    n = 5
    fp = rng.standard_normal((1, 65, 65, 3)).astype(np.float32)
    fn = None if tail else rng.standard_normal((1, 65, 65, 3)).astype(np.float32)
    ml, mr = smooth_grids(rng, n - 1, 4, 4), smooth_grids(rng, n - 1, 4, 4)
    dg = default_grid(64, 64)

    jax_maps = []
    ref = np.asarray(_jax_int8_interp(jm, variables, jax_maps).predict_clip(
        jnp.asarray(fp), None if tail else jnp.asarray(fn), jnp.asarray(ml),
        jnp.asarray(mr), n, default_grid=jnp.asarray(dg)))
    reset_launch_counts()
    interp = FlowInterpolator(encode=lambda x: port.encode(x)[0],
                              decode=_predict_decode(port, True),
                              decode_wants_absmax=True, decode_split=True)
    with torch.no_grad():
        ours = interp.predict_clip(
            torch.from_numpy(fp), None if tail else torch.from_numpy(fn),
            torch.from_numpy(ml), torch.from_numpy(mr), n,
            default_grid=torch.from_numpy(dg))
    # CPU tensors take the plain versions: no kernel launch is counted
    assert launch_counts() == NO_LAUNCHES
    assert ours.shape == ref.shape == ((1 if tail else n), 65, 65, 5)
    # the key map, then (full window) the 4 interpolated maps, at 9x9x4096
    assert [m.shape for m in port_int8_maps] == (
        [(1, 9, 9, 4096)] + ([] if tail else [(n - 1, 9, 9, 4096)]))
    _assert_int8_maps_close(port_int8_maps, jax_maps)
    np.testing.assert_allclose(ours.numpy(), ref, rtol=0, atol=LOGIT_ATOL)


@pytest.fixture(scope="module")
def jax_int8_windows(pair):
    """Window 0 through JAX's full program and window 1 through its cached
    one (int8_decode=True), and JAX's logits and int8 maps of the same two
    windows, eagerly."""
    jm, variables, _ = pair
    ref = builder_windows()
    n, out_size, wins, frames, dg = (ref[k] for k in ("n", "out_size", "wins",
                                                      "frames", "dg"))
    j_full, j_cached = jax_cached_fns(jm, n=n, out_size=out_size, default_grid=dg,
                                      int8_decode=True)
    j0, jenc0 = j_full(variables, jnorm(frames[0]), jnorm(frames[1]),
                       wins[0]["mvs_left"], wins[0]["mvs_right"])
    j1, _ = j_cached(variables, jenc0, jnorm(frames[3]),
                     wins[1]["mvs_left"], wins[1]["mvs_right"])
    j0_single = jax_predict_fn(jm, n=n, out_size=out_size, default_grid=dg,
                               int8_decode=True)(
        variables, jnorm(frames[0]), jnorm(frames[1]), wins[0]["mvs_left"],
        wins[0]["mvs_right"])
    np.testing.assert_array_equal(np.asarray(j0_single), np.asarray(j0))
    jax_maps = []
    interp = _jax_int8_interp(jm, variables, jax_maps)
    logits = [interp.predict_clip(
        jnorm(frames[0]) if i == 0 else None, jnorm(frames[2 * i + 1]),
        wins[i]["mvs_left"], wins[i]["mvs_right"], n, default_grid=jnp.asarray(dg),
        out_size=out_size, f_prev_enc=None if i == 0 else jenc0) for i in (0, 1)]
    return dict(ref, maps=(j0, j1), enc0=jenc0, logits=logits, int8_maps=jax_maps)


def _assert_int8_builders_match_jax(maps, encs, single, ours_maps, ref):
    n, out_size = ref["n"], ref["out_size"]
    np.testing.assert_array_equal(single.numpy(), maps[0].numpy())
    np.testing.assert_allclose(encs[0].numpy(), np.asarray(ref["enc0"]), rtol=1e-4,
                               atol=1e-4)
    _assert_int8_maps_close(ours_maps, ref["int8_maps"])
    for ours, theirs, lg in zip(maps, ref["maps"], ref["logits"]):
        assert ours.dtype == torch.int32 and ours.shape == (n,) + out_size
        top2 = np.sort(np.asarray(lg), axis=-1)[..., -2:]
        clear = (top2[..., 1] - top2[..., 0]) > 2 * LOGIT_ATOL
        assert clear.mean() > 0.9
        np.testing.assert_array_equal(ours.numpy()[clear], np.asarray(theirs)[clear])


def test_predict_builders_int8_match_jax(pair, port_int8_maps, jax_int8_windows):
    """Window 0 through the full programs, then window 1 through the cached
    one that reuses window 0's next-key encoding, in both packages; the
    port's single-window builder gives the full program's maps."""
    _, _, port = pair
    reset_launch_counts()
    maps, encs, single = run_port_builders(port, port.state_dict(), jax_int8_windows,
                                           int8_decode=True)
    assert launch_counts() == NO_LAUNCHES
    # the SegHead decodes the key map and the stack as two calls
    assert [m.shape[0] for m in port_int8_maps] == [1, 4, 1, 4, 1, 4]
    _assert_int8_builders_match_jax(maps, encs, single, port_int8_maps[:4],
                                    jax_int8_windows)


def test_predict_builders_int8_bind_variables_not_module_weights(pair, port_int8_maps,
                                                                 jax_int8_windows):
    """The int8 head folds and quantizes the variables bound for the call,
    not the module's own weights: built on a model from another seed and
    called with the fixture's variables, the builders give JAX's maps on
    those variables, and exactly the maps of the fixture's own model."""
    _, _, port = pair
    other = init_from_generator_(build_model("pspnet", layers=50, with_aux=False),
                                 torch.Generator().manual_seed(11))
    maps, encs, single = run_port_builders(other, port.state_dict(), jax_int8_windows,
                                           int8_decode=True)
    _assert_int8_builders_match_jax(maps, encs, single, port_int8_maps[:4],
                                    jax_int8_windows)
    ref_maps, ref_encs, _ = run_port_builders(port, port.state_dict(), jax_int8_windows,
                                              int8_decode=True)
    for a, b in zip(maps + encs, ref_maps + ref_encs):
        assert torch.equal(a, b)


def test_int8_decode_raises_on_other_heads():
    """The int8 decoder is the PSPNet SegHead's; a model without a ``cls``
    head raises with the JAX package's message."""
    with pytest.raises(ValueError, match="supports the pspnet SegHead"):
        make_flow_predict_fn(torch.nn.Module(), n=5, int8_decode=True, device="cpu")
    with pytest.raises(ValueError, match="supports the pspnet SegHead"):
        make_cached_flow_predict_fn(torch.nn.Module(), n=5, int8_decode=True,
                                    device="cpu")
