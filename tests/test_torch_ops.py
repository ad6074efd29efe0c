"""The port's ops against the JAX package's, on the CPU.

Inputs come from numpy with a fixed seed and go through the JAX function
and its counterpart in floodseg_tpu_torch. Tolerances are stated in each
assert: float32 parity is 1e-5 (the two sides sum in different orders).
The warp kernels' wrappers and their on-card tests are in
tests/test_torch_kernels.py, which needs no JAX.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from floodseg_tpu.ops.grid_sample import grid_sample as jax_grid_sample
from floodseg_tpu.ops.pallas_warp import grid_sample_pallas, warp_chain_pallas
from floodseg_tpu.ops.pool import adaptive_avg_pool as jax_adaptive_avg_pool
from floodseg_tpu.ops.pool import max_pool as jax_max_pool
from floodseg_tpu.ops.resize import resize_argmax as jax_resize_argmax
from floodseg_tpu.ops.resize import resize_bilinear as jax_resize_bilinear

from floodseg_tpu_torch.ops import (
    adaptive_avg_pool,
    grid_sample,
    max_pool,
    resize_argmax,
    resize_bilinear,
    warp_chain_cuda,
    warp_chain_plain,
)

TOL = dict(rtol=1e-5, atol=1e-5)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _bf16_np(a):
    """numpy float32 copy of a bf16 tensor."""
    return a.to(torch.float32).numpy()


@pytest.mark.parametrize("align", [True, False])
@pytest.mark.parametrize("size", [(13, 21), (4, 3)])
def test_resize_bilinear_matches_jax(align, size):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 7, 9, 6)).astype(np.float32)
    ref = np.asarray(jax_resize_bilinear(jnp.asarray(x), size, align_corners=align))
    ours = resize_bilinear(_t(x), size, align_corners=align).numpy()
    np.testing.assert_allclose(ours, ref, **TOL)


def test_resize_bilinear_matches_torch_interpolate():
    """Independent oracle: F.interpolate on the NCHW transpose."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((1, 5, 8, 3)).astype(np.float32)
    for align in (True, False):
        ref = F.interpolate(_t(x).permute(0, 3, 1, 2), (11, 17), mode="bilinear",
                            align_corners=align).permute(0, 2, 3, 1).numpy()
        ours = resize_bilinear(_t(x), (11, 17), align_corners=align).numpy()
        np.testing.assert_allclose(ours, ref, **TOL)


def test_resize_bilinear_bf16_computes_in_f32():
    """bf16 in, f32 compute, one rounding back to bf16 (ops/resize.py:66-76)."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((1, 6, 6, 4)).astype(np.float32)
    xb = _t(x).to(torch.bfloat16)
    ours = resize_bilinear(xb, (11, 11), align_corners=True)
    assert ours.dtype == torch.bfloat16
    ref = jax_resize_bilinear(jnp.asarray(_bf16_np(xb), jnp.bfloat16), (11, 11))
    # both round the same f32 result once: equal up to one bf16 ulp
    np.testing.assert_allclose(_bf16_np(ours), np.asarray(ref, np.float32),
                               rtol=2 ** -8, atol=0)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("align", [True, False])
@pytest.mark.parametrize("size", [(13, 21), (4, 3)])
def test_resize_bilinear_fast_lowp_matches_jax(dtype, align, size):
    """fast_lowp rounds the matrices and the between-axes value to the input
    dtype: equal to the bit in bf16 (the two-tap products are exact) and,
    on these inputs, in float32."""
    rng = np.random.default_rng(5)
    x = jnp.asarray(rng.standard_normal((2, 7, 9, 6)) * 3, dtype)
    ref = np.asarray(jax_resize_bilinear(x, size, align_corners=align,
                                         fast_lowp=True).astype(jnp.float32))
    xt = _t(np.asarray(x.astype(jnp.float32))).to(getattr(torch, dtype))
    ours = resize_bilinear(xt, size, align_corners=align, fast_lowp=True)
    assert ours.dtype == xt.dtype and ours.shape == (2,) + size + (6,)
    np.testing.assert_array_equal(ours.float().numpy(), ref)


@pytest.mark.parametrize("align", [True, False])
def test_resize_argmax_matches_jax(align):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((3, 9, 9, 5)).astype(np.float32)
    ref = np.asarray(jax_resize_argmax(jnp.asarray(x), (33, 41), align_corners=align))
    ours = resize_argmax(_t(x), (33, 41), align_corners=align)
    assert ours.dtype == torch.int32 and ours.shape == (3, 33, 41)
    # resized logits agree to 1e-5; the argmax may differ only at near-ties
    logits = np.asarray(jax_resize_bilinear(jnp.asarray(x), (33, 41), align_corners=align))
    top2 = np.sort(logits, axis=-1)[..., -2:]
    clear = (top2[..., 1] - top2[..., 0]) > 1e-5
    np.testing.assert_array_equal(ours.numpy()[clear], ref[clear])


@pytest.mark.parametrize("bins", [1, 2, 3, 6])
def test_adaptive_avg_pool_matches_jax(bins):
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 9, 11, 8)).astype(np.float32)
    ref = np.asarray(jax_adaptive_avg_pool(jnp.asarray(x), bins))
    ours = adaptive_avg_pool(_t(x), bins).numpy()
    np.testing.assert_allclose(ours, ref, **TOL)
    torch_ref = F.adaptive_avg_pool2d(_t(x).permute(0, 3, 1, 2), bins)
    np.testing.assert_allclose(ours, torch_ref.permute(0, 2, 3, 1).numpy(), **TOL)


def test_max_pool_matches_jax():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 33, 17, 4)).astype(np.float32) - 3.0
    ref = np.asarray(jax_max_pool(jnp.asarray(x), 3, 2, 1))
    ours = max_pool(_t(x), 3, 2, 1).numpy()
    np.testing.assert_allclose(ours, ref, **TOL)


@pytest.mark.parametrize("align", [False, True])
def test_grid_sample_matches_jax_and_pallas(align):
    """The plain warp against JAX grid_sample and the interpret-mode Pallas
    kernel it ports (tests/test_pallas_warp.py:13-21)."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 8, 16, 256)).astype(np.float32)
    grid = rng.uniform(-1.2, 1.2, size=(2, 4, 8, 2)).astype(np.float32)
    ours = grid_sample(_t(x), _t(grid), align_corners=align).numpy()
    ref = np.asarray(jax_grid_sample(jnp.asarray(x), jnp.asarray(grid),
                                     align_corners=align))
    pallas = np.asarray(grid_sample_pallas(jnp.asarray(x), jnp.asarray(grid),
                                           align_corners=align, interpret=True))
    np.testing.assert_allclose(ours, ref, **TOL)
    np.testing.assert_allclose(ours, pallas, **TOL)


@pytest.mark.parametrize("align", [False, True])
def test_grid_sample_matches_torch_grid_sample(align):
    """Independent oracle: F.grid_sample(bilinear, border) on NCHW."""
    rng = np.random.default_rng(6)
    x = rng.standard_normal((1, 9, 7, 5)).astype(np.float32)
    grid = rng.uniform(-1.3, 1.3, size=(1, 6, 4, 2)).astype(np.float32)
    ref = F.grid_sample(_t(x).permute(0, 3, 1, 2), _t(grid), mode="bilinear",
                        padding_mode="border", align_corners=align)
    ours = grid_sample(_t(x), _t(grid), align_corners=align)
    np.testing.assert_allclose(ours.numpy(), ref.permute(0, 2, 3, 1).numpy(), **TOL)


def _chain_inputs(t, dtype=torch.float32):
    rng = np.random.default_rng(2)
    gh, gw, c = 8, 16, 128
    y0 = rng.standard_normal((1, gh, gw, c)).astype(np.float32)
    grids = rng.uniform(-1.1, 1.1, (t, 1, gh, gw, 2)).astype(np.float32)
    return _t(y0).to(dtype), _t(grids)


def test_warp_chain_matches_pallas_f32():
    """The plain chain against the interpret-mode Pallas chain kernel at
    T=4, 8x16, C=128 (tests/test_pallas_warp.py:35-52), and against T
    chained plain warps."""
    y0, grids = _chain_inputs(4)
    ours = warp_chain_plain(y0, grids)
    assert ours.shape == (5, 8, 16, 128)
    ref = np.asarray(warp_chain_pallas(jnp.asarray(y0.numpy()),
                                       jnp.asarray(grids.numpy()), interpret=True))
    np.testing.assert_allclose(ours.numpy(), ref, **TOL)
    state = y0
    for i in range(4):
        state = grid_sample(state, grids[i], align_corners=False)
        np.testing.assert_allclose(ours[i + 1].numpy(), state[0].numpy(), **TOL)


def test_warp_chain_matches_pallas_bf16():
    """bf16: both round the merged one-hot weights and the carry to bf16
    every step and accumulate in f32, so they differ only where an f32 sum
    order flips a bf16 rounding. Bound: 2 bf16 ulps of the largest |y0|
    (2 * 2**-8 * max|y0|) after 4 steps."""
    y0, grids = _chain_inputs(4, torch.bfloat16)
    ours = warp_chain_plain(y0, grids)
    assert ours.dtype == torch.bfloat16
    ref = np.asarray(warp_chain_pallas(jnp.asarray(_bf16_np(y0), jnp.bfloat16),
                                       jnp.asarray(grids.numpy()), interpret=True),
                     np.float32)
    bound = 2 * 2.0 ** -8 * float(np.abs(_bf16_np(y0)).max())
    np.testing.assert_allclose(_bf16_np(ours), ref, rtol=0, atol=bound)


def test_warp_chain_t0_returns_y0():
    y0, grids = _chain_inputs(0)
    ours = warp_chain_cuda(y0, grids)
    ref = np.asarray(warp_chain_pallas(jnp.asarray(y0.numpy()),
                                       jnp.asarray(grids.numpy()), interpret=True))
    assert ours.shape == ref.shape == (1, 8, 16, 128)
    np.testing.assert_array_equal(ours.numpy(), ref)
