"""The port's per-phase predict functions and profiler, the unfused argmax
epilogue and the one-hot warp against the JAX package, on the CPU.

The narrow ViT/32 (tests/torch_port_fixtures.py::vit_pair) at 64 px key
frames (2x2 tokens), 4x4 block grids, n = 5, float32: each phase's output
within rtol = atol = 1e-4 (tests/test_torch_flow.py's TOL); class maps
equal wherever the top-2 logit gap exceeds 1e-4. ``grid_sample_matmul``:
float32 within 1e-6 of JAX's and of the port's ``grid_sample``; bf16
within one bf16 ulp (2**-8 relative) of JAX's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from floodseg_tpu.ops.grid_sample import grid_sample_matmul as jax_grid_sample_matmul
from floodseg_tpu.ops.resize import resize_bilinear as jax_resize_bilinear
from floodseg_tpu.train.flow import make_flow_phase_fns as jax_phase_fns

from floodseg_tpu_torch.ops import (
    grid_sample,
    grid_sample_matmul,
    launch_counts,
    reset_launch_counts,
)
from floodseg_tpu_torch.train import (
    make_cached_flow_predict_fn,
    make_flow_phase_fns,
    make_flow_predict_fn,
    profile_predict_phases,
)
from floodseg_tpu_torch.video import FlowInterpolator

from torch_port_fixtures import builder_windows, jnorm, vit_pair

TOL = dict(rtol=1e-4, atol=1e-4)
GAP = 1e-4
FRAME = 64


@pytest.fixture(scope="module")
def vit():
    return vit_pair(size=FRAME)


@pytest.fixture(scope="module")
def windows():
    return builder_windows(n=5, out_size=(72, 80), frame_size=FRAME)


def _clear(logits):
    top2 = np.sort(np.asarray(logits), axis=-1)[..., -2:]
    return (top2[..., 1] - top2[..., 0]) > GAP


def _port_logits(port, ref):
    """The port interpolator's logits of the first window at out_size."""
    w = ref["wins"][0]
    interp = FlowInterpolator(encode=lambda x: port.encode(x)[0], decode=port.decode)
    with torch.inference_mode():
        return interp.predict_clip(
            torch.from_numpy(jnorm(ref["frames"][0])), torch.from_numpy(jnorm(ref["frames"][1])),
            torch.as_tensor(w["mvs_left"]), torch.as_tensor(w["mvs_right"]), ref["n"],
            default_grid=torch.as_tensor(ref["dg"]), out_size=ref["out_size"])


def test_phase_fns_match_jax(vit, windows):
    """encode, warp_chain, fuse and decode, each on the same inputs as
    JAX's make_flow_phase_fns: within TOL, the decode's maps equal away
    from near-ties; no kernel launch on the CPU."""
    jm, variables, port = vit
    n, out_size, dg = windows["n"], windows["out_size"], windows["dg"]
    fp, fn = windows["frames"][:2]
    ml, mr = windows["wins"][0]["mvs_left"], windows["wins"][0]["mvs_right"]
    ref = jax_phase_fns(jm, n, out_size=out_size, default_grid=dg)
    reset_launch_counts()
    ours = make_flow_phase_fns(port, n, out_size=out_size, default_grid=dg, device="cpu")
    sd = port.state_dict()

    f_ref, f2_ref = (np.array(ref["encode"](variables, jnorm(x))) for x in (fp, fn))
    f, f2 = ours["encode"](sd, fp), ours["encode"](sd, fn)
    assert f.shape == f_ref.shape == (1, 2, 2, 128)
    np.testing.assert_allclose(f.numpy(), f_ref, **TOL)
    np.testing.assert_allclose(f2.numpy(), f2_ref, **TOL)

    f, f2 = torch.from_numpy(f_ref), torch.from_numpy(f2_ref)
    fwd_ref, bwd_ref = (np.array(ref["warp_chain"](x, g))
                        for x, g in ((f_ref, ml), (f2_ref, mr)))
    fwd, bwd = ours["warp_chain"](f, ml), ours["warp_chain"](f2, mr)
    assert fwd.shape == fwd_ref.shape == (n - 1, 2, 2, 128)
    np.testing.assert_allclose(fwd.numpy(), fwd_ref, **TOL)
    np.testing.assert_allclose(bwd.numpy(), bwd_ref, **TOL)

    maps_ref = np.array(ref["fuse"](f_ref, f2_ref, fwd_ref, bwd_ref))
    maps = ours["fuse"](f, f2, torch.from_numpy(fwd_ref), torch.from_numpy(bwd_ref))
    assert maps.shape == maps_ref.shape == (n, 2, 2, 128)
    np.testing.assert_allclose(maps.numpy(), maps_ref, **TOL)

    cls_ref = np.asarray(ref["decode"](variables, maps_ref))
    cls = ours["decode"](sd, torch.from_numpy(maps_ref))
    logits = jax_resize_bilinear(jm.apply(variables, jnp.asarray(maps_ref), train=False,
                                          method="decode"), out_size, align_corners=True)
    clear = _clear(logits)
    assert cls.dtype == torch.int32 and cls.shape == cls_ref.shape == (n,) + out_size
    assert clear.mean() > 0.99
    np.testing.assert_array_equal(cls.numpy()[clear], cls_ref[clear])
    assert set(launch_counts().values()) == {0}


def test_composed_phases_match_predict_fn(vit, windows):
    """encode, the two chains, fuse and decode composed give
    make_flow_predict_fn's maps away from near-ties (the phases resize
    each chain to the feature size before the blend; the one-call path
    blends, then resizes)."""
    _, _, port = vit
    n, out_size, dg = windows["n"], windows["out_size"], windows["dg"]
    fp, fn = windows["frames"][:2]
    ml, mr = windows["wins"][0]["mvs_left"], windows["wins"][0]["mvs_right"]
    sd = port.state_dict()
    fns = make_flow_phase_fns(port, n, out_size=out_size, default_grid=dg, device="cpu")
    f, f2 = fns["encode"](sd, fp), fns["encode"](sd, fn)
    maps = fns["fuse"](f, f2, fns["warp_chain"](f, ml), fns["warp_chain"](f2, mr))
    composed = fns["decode"](sd, maps)
    ref = make_flow_predict_fn(port, n, out_size=out_size, default_grid=dg, device="cpu")(
        sd, fp, fn, ml, mr)
    clear = _clear(_port_logits(port, windows))
    assert composed.shape == ref.shape == (n,) + out_size and clear.mean() > 0.99
    np.testing.assert_array_equal(composed.numpy()[clear], ref.numpy()[clear])


def test_profile_predict_phases_regions(vit, windows):
    """The reference's four region names, each a positive mean."""
    _, _, port = vit
    w = windows["wins"][0]
    batch = {"frame_prev": windows["frames"][0], "frame_next": windows["frames"][1],
             "mvs_left": w["mvs_left"], "mvs_right": w["mvs_right"]}
    times = profile_predict_phases(port, port.state_dict(), batch, windows["n"],
                                   out_size=windows["out_size"], default_grid=windows["dg"],
                                   repeats=2, device="cpu")
    assert sorted(times) == ["predict_decoder", "predict_encoder", "predict_fusion",
                             "predict_warp"]
    assert all(t > 0 for t in times.values()), times


def test_unfused_argmax_matches_fused(vit, windows):
    """make_cached_flow_predict_fn(fused_argmax=False) (resize, then
    argmax) gives the fused epilogue's maps away from near-ties, and the
    same next-key encoding."""
    _, _, port = vit
    n, out_size, dg = windows["n"], windows["out_size"], windows["dg"]
    fp, fn = windows["frames"][:2]
    w = windows["wins"][0]
    sd = port.state_dict()
    out = {}
    for fused in (True, False):
        full, _ = make_cached_flow_predict_fn(port, n, out_size=out_size, default_grid=dg,
                                              fused_argmax=fused, device="cpu")
        out[fused] = full(sd, fp, fn, w["mvs_left"], w["mvs_right"])
    clear = _clear(_port_logits(port, windows))
    assert out[False][0].dtype == torch.int32 and out[False][0].shape == (n,) + out_size
    assert clear.mean() > 0.99
    np.testing.assert_array_equal(out[False][0].numpy()[clear], out[True][0].numpy()[clear])
    assert torch.equal(out[False][1], out[True][1])


@pytest.mark.parametrize("align", [False, True], ids=["border", "align_corners"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_grid_sample_matmul_matches_jax(dtype, align):
    """The one-hot warp (ops/grid_sample.py::grid_sample_matmul) on a grid
    that reaches past the border."""
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 9, 11, 6)).astype(np.float32)
    g = rng.uniform(-1.2, 1.2, (2, 5, 7, 2)).astype(np.float32)
    tdt = getattr(torch, dtype)
    xt = torch.from_numpy(x).to(tdt)
    ours = grid_sample_matmul(xt, torch.from_numpy(g), align)
    ref = np.asarray(jax_grid_sample_matmul(jnp.asarray(x, getattr(jnp, dtype)), jnp.asarray(g),
                                            align).astype(jnp.float32))
    assert ours.dtype == tdt and ours.shape == (2, 5, 7, 6)
    tol = dict(rtol=2.0 ** -8, atol=1e-6) if dtype == "bfloat16" else dict(rtol=0, atol=1e-6)
    np.testing.assert_allclose(ours.float().numpy(), ref, **tol)
    if dtype == "float32":
        np.testing.assert_allclose(ours.numpy(), grid_sample(xt, torch.from_numpy(g),
                                                             align).numpy(), rtol=0, atol=1e-6)
