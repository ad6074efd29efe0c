"""The port's flow-predict slice against the JAX package, on the CPU.

PSPNet-50 at 65 px key frames, 4x4 block grids, n = 5, float32: the
interpolator's logits at rtol = atol = 1e-4 (the network's own parity
bound, tests/test_torch_models.py); the predict builders' int32 maps equal
wherever the top-2 logit gap exceeds 1e-4. The cheaper branches
(segmentation mode, no_warp) use a tiny conv encoder/decoder pair.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from floodseg_tpu.data.dataset import FlowDataset
from floodseg_tpu.data.synthetic import generate_synthetic_dataset
from floodseg_tpu.data.transforms import MEAN as JAX_MEAN, STD as JAX_STD
from floodseg_tpu.train.flow import make_cached_flow_predict_fn as jax_cached_fns
from floodseg_tpu.video import FlowInterpolator as JaxInterpolator
from floodseg_tpu.video.grid import default_grid as jax_default_grid

from floodseg_tpu_torch.core import full_precision_f32, resolve_device
from floodseg_tpu_torch.data import MEAN, STD, Resize, predict_windows, synthetic_clip
from floodseg_tpu_torch.ops import launch_counts, reset_launch_counts
from floodseg_tpu_torch.train import make_cached_flow_predict_fn, make_flow_predict_fn
from floodseg_tpu_torch.video import FlowInterpolator, default_grid

from torch_port_fixtures import pspnet50_pair

TOL = dict(rtol=1e-4, atol=1e-4)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def pair():
    return pspnet50_pair(size=65)


def _grids(rng, t, gh, gw):
    """Smooth near-identity grids (T, 1, gh, gw, 2); the jitter pushes the
    edge points past [-1, 1], so the border clamp is exercised."""
    base = np.stack(np.meshgrid(np.linspace(-1, 1, gw), np.linspace(-1, 1, gh)),
                    axis=-1)[None, None]
    return (base + rng.uniform(-0.08, 0.08, (t, 1, gh, gw, 2))).astype(np.float32)


def _jax_interp(jm, variables, **kw):
    return JaxInterpolator(
        encode=lambda x: jm.apply(variables, x, train=False, method="encode")[0],
        decode=lambda f: jm.apply(variables, f, train=False, method="decode"),
        **kw)


def _port_interp(port, **kw):
    return FlowInterpolator(encode=lambda x: port.encode(x)[0],
                            decode=port.decode, **kw)


@pytest.mark.parametrize("tail", [False, True], ids=["window", "tail_window"])
def test_predict_clip_pspnet50_matches_jax(pair, tail):
    jm, variables, port = pair
    rng = np.random.default_rng(0)
    n = 5
    fp = rng.standard_normal((1, 65, 65, 3)).astype(np.float32)
    fn = None if tail else rng.standard_normal((1, 65, 65, 3)).astype(np.float32)
    ml, mr = _grids(rng, n - 1, 4, 4), _grids(rng, n - 1, 4, 4)
    dg = jax_default_grid(64, 64)
    np.testing.assert_array_equal(default_grid(64, 64), dg)

    ref = jax.jit(lambda fp, fn, ml, mr: _jax_interp(jm, variables).predict_clip(
        fp, fn, ml, mr, n, default_grid=jnp.asarray(dg)))(fp, fn, ml, mr)
    reset_launch_counts()
    with torch.no_grad():
        ours = _port_interp(port).predict_clip(
            torch.from_numpy(fp), None if tail else torch.from_numpy(fn),
            torch.from_numpy(ml), torch.from_numpy(mr), n,
            default_grid=torch.from_numpy(dg))
    assert ours.shape == ref.shape == ((1 if tail else n), 65, 65, 5)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), **TOL)
    # CPU tensors take the plain versions: no kernel launch is counted
    assert launch_counts() == {"grid_sample_cuda": 0, "warp_chain_cuda": 0,
                               "resize_quantize_int8_cuda": 0}


def _tiny_pair(seed=1):
    """A 4x4/stride-4 conv encoder (3 -> 8) and a 1x1 conv decoder (8 -> 5),
    in JAX and in torch, with the same numpy weights."""
    rng = np.random.default_rng(seed)
    ew = rng.standard_normal((8, 3, 4, 4)).astype(np.float32) * 0.3
    eb = rng.standard_normal(8).astype(np.float32) * 0.1
    dw = rng.standard_normal((5, 8, 1, 1)).astype(np.float32) * 0.3
    db = rng.standard_normal(5).astype(np.float32) * 0.1

    def jconv(x, w, b, s):
        y = jax.lax.conv_general_dilated(
            x, jnp.asarray(w.transpose(2, 3, 1, 0)), (s, s), "VALID",
            dimension_numbers=("NHWC", "HWIO", "NHWC"), precision="highest")
        return y + jnp.asarray(b)

    def tconv(x, w, b, s):
        y = F.conv2d(x.permute(0, 3, 1, 2), torch.from_numpy(w),
                     torch.from_numpy(b), stride=s)
        return y.permute(0, 2, 3, 1).contiguous()

    jax_fns = (lambda x: jconv(x, ew, eb, 4), lambda f: jconv(f, dw, db, 1))
    torch_fns = (lambda x: tconv(x, ew, eb, 4), lambda f: tconv(f, dw, db, 1))
    return jax_fns, torch_fns


@pytest.mark.parametrize("feature_based,no_warp", [(False, False), (True, True),
                                                   (False, True)])
def test_predict_clip_branches_match_jax(feature_based, no_warp):
    """Segmentation mode (warping full-resolution logits, C = 5) and the
    no_warp linear blend, with the tiny conv pair."""
    (je, jd), (te, td) = _tiny_pair()
    rng = np.random.default_rng(2)
    n = 5
    fp = rng.standard_normal((1, 64, 64, 3)).astype(np.float32)
    fn = rng.standard_normal((1, 64, 64, 3)).astype(np.float32)
    ml, mr = _grids(rng, n - 1, 4, 4), _grids(rng, n - 1, 4, 4)
    dg = default_grid(64, 64)
    kw = dict(feature_based=feature_based, no_warp=no_warp)
    ref = JaxInterpolator(je, jd, **kw).predict_clip(
        jnp.asarray(fp), jnp.asarray(fn), jnp.asarray(ml), jnp.asarray(mr), n,
        default_grid=jnp.asarray(dg))
    with torch.no_grad():
        ours = FlowInterpolator(te, td, **kw).predict_clip(
            *(torch.from_numpy(a) for a in (fp, fn, ml, mr)), n,
            default_grid=torch.from_numpy(dg))
    assert ours.shape == ref.shape == (n, 64, 64, 5)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), **TOL)


def test_cached_predict_builders_match_jax(pair):
    """Full window, then the cached window that reuses its next-key
    encoding, through both packages' builders. The port's builders take the
    raw uint8 frames and normalise on the device; the JAX builders get the
    frames normalised on the host."""
    jm, variables, port = pair
    n, out_size = 5, (72, 80)
    clip = synthetic_clip(2 * n + 1, size=(64, 64), frame_ids=(0, n, 2 * n), seed=3)
    wins = predict_windows(clip, n)
    resize = Resize((65, 65))
    frames = [resize(w[k]).numpy() for w in wins for k in ("frame_prev", "frame_next")]
    assert frames[0].dtype == np.uint8 and frames[0].shape == (1, 65, 65, 3)
    dg = default_grid(64, 64)

    def jnorm(x):
        return ((x.astype(np.float32) - np.asarray(JAX_MEAN, np.float32))
                / np.asarray(JAX_STD, np.float32))

    j_full, j_cached = jax_cached_fns(jm, n=n, out_size=out_size, default_grid=dg)
    j0, jenc0 = j_full(variables, jnorm(frames[0]), jnorm(frames[1]),
                       wins[0]["mvs_left"], wins[0]["mvs_right"])
    j1, jenc1 = j_cached(variables, jenc0, jnorm(frames[3]),
                         wins[1]["mvs_left"], wins[1]["mvs_right"])

    full, cached = make_cached_flow_predict_fn(port, n=n, out_size=out_size,
                                               default_grid=dg, device="cpu")
    state = port.state_dict()
    p0, penc0 = full(state, frames[0], frames[1], wins[0]["mvs_left"],
                     wins[0]["mvs_right"])
    p1, penc1 = cached(state, penc0, frames[3], wins[1]["mvs_left"],
                       wins[1]["mvs_right"])
    single = make_flow_predict_fn(port, n=n, out_size=out_size, default_grid=dg,
                                  device="cpu")(state, frames[0], frames[1],
                                                wins[0]["mvs_left"], wins[0]["mvs_right"])

    # the raw next-key encodings agree like the encoder does
    np.testing.assert_allclose(penc0.numpy(), np.asarray(jenc0), **TOL)
    np.testing.assert_allclose(penc1.numpy(), np.asarray(jenc1), **TOL)
    np.testing.assert_array_equal(single.numpy(), p0.numpy())
    for i, (ours, ref) in enumerate(((p0, j0), (p1, j1))):
        assert ours.dtype == torch.int32 and ours.shape == (n,) + out_size
        w = wins[i]
        fpi = jnorm(frames[2 * i]) if i == 0 else None
        logits = _jax_interp(jm, variables).predict_clip(
            fpi, jnorm(frames[2 * i + 1]), w["mvs_left"], w["mvs_right"], n,
            default_grid=jnp.asarray(dg), out_size=out_size,
            f_prev_enc=None if i == 0 else jenc0)
        top2 = np.sort(np.asarray(logits), axis=-1)[..., -2:]
        clear = (top2[..., 1] - top2[..., 0]) > 1e-4
        assert clear.mean() > 0.9
        np.testing.assert_array_equal(ours.numpy()[clear], np.asarray(ref)[clear])


def test_predict_builders_raise_on_int8():
    """The int8 encoder trunk is not ported: asking for it raises. (The int8
    decoder is, tests/test_torch_flow_int8.py.)"""
    m = torch.nn.Module()
    with pytest.raises(NotImplementedError, match="int8 encoder trunk"):
        make_flow_predict_fn(m, n=5, int8_encode=True, device="cpu")
    with pytest.raises(NotImplementedError, match="int8 encoder trunk"):
        make_cached_flow_predict_fn(m, n=5, int8_encode=True, device="cpu")


def test_cached_builder_raises_on_unfused_argmax():
    """The unfused epilogue gives the same maps as resize_argmax and is not
    ported: asking for it raises instead of taking another path."""
    with pytest.raises(NotImplementedError, match="fused_argmax=True"):
        make_cached_flow_predict_fn(torch.nn.Module(), n=5, fused_argmax=False,
                                    device="cpu")


def test_full_precision_f32_is_scoped():
    """TF32 is off inside the block and the caller's flags come back after,
    also when the block raises."""
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    prev = cudnn.allow_tf32, matmul.allow_tf32
    try:
        cudnn.allow_tf32, matmul.allow_tf32 = True, True
        with pytest.raises(ValueError):
            with full_precision_f32():
                assert (cudnn.allow_tf32, matmul.allow_tf32) == (False, False)
                raise ValueError
        assert (cudnn.allow_tf32, matmul.allow_tf32) == (True, True)
    finally:
        cudnn.allow_tf32, matmul.allow_tf32 = prev


def test_entry_points_default_to_cuda():
    """device=None means cuda; without a card that raises, never falls back."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default resolves to it")
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_flow_predict_fn(torch.nn.Module(), n=5)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_cached_flow_predict_fn(torch.nn.Module(), n=5)
    assert resolve_device("cpu") == torch.device("cpu")


def test_synthetic_windows_match_jax_dataset(tmp_path):
    """The in-memory clip's grids and predict windows equal the JAX
    package's synthetic dataset read through its predict FlowDataset."""
    n, num_frames = 5, 16
    generate_synthetic_dataset(str(tmp_path), num_frames=num_frames,
                               size=(64, 96), frame_delta=n, num_labeled=2)
    ds = FlowDataset("predict", str(tmp_path), type="u", frame_delta=n,
                     predict_v_id="synth")
    clip = synthetic_clip(num_frames, size=(64, 96),
                          frame_ids=range(0, num_frames, n))
    wins = predict_windows(clip, n)
    assert len(wins) == len(ds) == 3
    for i, w in enumerate(wins):
        s = ds.get(i, np.random.default_rng(0))
        assert (w["prev_frame_id"], w["next_frame_id"]) == (
            s["prev_frame_id"], s["next_frame_id"])
        np.testing.assert_array_equal(w["mvs_left"], np.stack(s["mvs_left"])[:, None])
        np.testing.assert_array_equal(w["mvs_right"], np.stack(s["mvs_right"])[:, None])
        assert w["frame_prev"].shape == (1, 64, 96, 3)
        assert w["frame_prev"].dtype == np.uint8


def test_resize_frames_matches_cv2():
    """The port's frame resize (half-pixel bilinear, no cv2 on the card's
    machine) against cv2.INTER_LINEAR on uint8: cv2 rounds 11-bit fixed-point
    weights, so the two agree within 1 grey level."""
    cv2 = pytest.importorskip("cv2")
    img = np.random.default_rng(4).integers(0, 256, (64, 48, 3), dtype=np.uint8)
    ours = Resize((65, 65))(img).numpy()
    ref = cv2.resize(img, (65, 65), interpolation=cv2.INTER_LINEAR)
    assert ours.dtype == np.uint8 and ours.shape == ref.shape
    assert np.abs(ours.astype(int) - ref.astype(int)).max() <= 1
    assert MEAN == list(JAX_MEAN) and STD == list(JAX_STD)


def test_port_imports_no_jax():
    """No module of floodseg_tpu_torch, and not chip_smoke.py, imports jax or
    floodseg_tpu; checked in a fresh interpreter's sys.modules."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import floodseg_tpu_torch as pkg\n"
        "for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "             or m == 'floodseg_tpu' or m.startswith('floodseg_tpu.'))\n"
        "print('BAD', bad)\n"
        "assert not bad, bad\n"
        "for m in ('ops.warp_kernels', 'ops.quant', 'ops.resize_kernels'):\n"
        "    assert 'floodseg_tpu_torch.' + m in sys.modules, m\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "BAD []" in res.stdout
