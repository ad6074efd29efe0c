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
from floodseg_tpu_torch.data import (MEAN, STD, Resize, predict_windows, resize_frames,
                                     synthetic_clip)
from floodseg_tpu_torch.ops import launch_counts, reset_launch_counts
from floodseg_tpu_torch.models import build_model, init_from_generator_
from floodseg_tpu_torch.train import make_cached_flow_predict_fn, make_flow_predict_fn
from floodseg_tpu_torch.train.flow import decode_split_ok
from floodseg_tpu_torch.video import FlowInterpolator, default_grid

from torch_port_fixtures import (
    builder_windows,
    jnorm,
    pspnet50_pair,
    run_port_builders,
    smooth_grids,
)

TOL = dict(rtol=1e-4, atol=1e-4)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def pair():
    return pspnet50_pair(size=65)


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
    ml, mr = smooth_grids(rng, n - 1, 4, 4), smooth_grids(rng, n - 1, 4, 4)
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
    assert launch_counts() == {"grid_sample_cuda": 0, "grid_sample_backward_cuda": 0,
                               "warp_chain_cuda": 0, "resize_quantize_int8_cuda": 0}


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
    ml, mr = smooth_grids(rng, n - 1, 4, 4), smooth_grids(rng, n - 1, 4, 4)
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


@pytest.mark.parametrize("n", [5, 25])
def test_predict_clip_bf16_within_jax_default_warp(n):
    """bf16 warps: the port's (K1's and K2's plain versions, the Pallas
    kernels' four taps with merged weights) against the JAX package's
    default predict path (the XLA gather's LERP,
    floodseg_tpu/ops/grid_sample.py), both predict_clips in bf16. The
    encoder is the identity on unit-scale bf16 maps (9x9x8) and the decoder
    a float32 cast, so the logits are the interpolated maps themselves:
    frame 0 (one warp, through the identity grid) within 2e-2 and the
    chained frames within 3e-2, the JAX package's own Pallas-versus-gather
    tolerances (tests/test_pallas_warp.py); the class maps (argmax over the
    8 channels) equal wherever the top-2 gap exceeds twice the tolerance.
    n = 25 runs the main path's 23-step chain on 4x4 grids. Measured: frame 0
    equal; the chained frames at most 0.0156 (n = 5) and 0.0234 (n = 25)
    apart at values up to 3.5, and 99.2% or more of the maps equal."""
    rng = np.random.default_rng(n)
    fp, fn = (rng.standard_normal((1, 9, 9, 8)).astype(np.float32) for _ in range(2))
    ml, mr = smooth_grids(rng, n - 1, 4, 4), smooth_grids(rng, n - 1, 4, 4)
    dg = default_grid(64, 64)
    ref = JaxInterpolator(lambda x: x, lambda f: f.astype(jnp.float32)).predict_clip(
        jnp.asarray(fp, jnp.bfloat16), jnp.asarray(fn, jnp.bfloat16), jnp.asarray(ml),
        jnp.asarray(mr), n, default_grid=jnp.asarray(dg))
    ref = np.asarray(ref)
    with torch.no_grad():
        ours = FlowInterpolator(lambda x: x, lambda f: f.float()).predict_clip(
            torch.from_numpy(fp).to(torch.bfloat16), torch.from_numpy(fn).to(torch.bfloat16),
            torch.from_numpy(ml), torch.from_numpy(mr), n,
            default_grid=torch.from_numpy(dg)).numpy()
    assert ours.shape == ref.shape == (n, 9, 9, 8)
    for frames, tol in ((slice(0, 1), 2e-2), (slice(1, n), 3e-2)):
        np.testing.assert_allclose(ours[frames], ref[frames], rtol=tol, atol=tol)
        top2 = np.sort(ref[frames], axis=-1)[..., -2:]
        clear = (top2[..., 1] - top2[..., 0]) > 2 * tol * (1 + np.abs(top2[..., 1]))
        assert clear.mean() > 0.5
        np.testing.assert_array_equal(ours[frames].argmax(-1)[clear],
                                      ref[frames].argmax(-1)[clear])


@pytest.fixture(scope="module")
def jax_windows(pair):
    """Two windows of a synthetic clip (65 px key frames, n = 5) through the
    JAX package's cached builders (window 0 full, window 1 cached), and its
    interpolator's logits of both. The JAX builders get the frames
    normalised on the host; the port's take the raw uint8 frames."""
    jm, variables, _ = pair
    ref = builder_windows()
    n, out_size, wins, frames, dg = (ref[k] for k in ("n", "out_size", "wins",
                                                      "frames", "dg"))
    j_full, j_cached = jax_cached_fns(jm, n=n, out_size=out_size, default_grid=dg)
    j0, jenc0 = j_full(variables, jnorm(frames[0]), jnorm(frames[1]),
                       wins[0]["mvs_left"], wins[0]["mvs_right"])
    j1, jenc1 = j_cached(variables, jenc0, jnorm(frames[3]),
                         wins[1]["mvs_left"], wins[1]["mvs_right"])
    logits = [_jax_interp(jm, variables).predict_clip(
        jnorm(frames[0]) if i == 0 else None, jnorm(frames[2 * i + 1]),
        wins[i]["mvs_left"], wins[i]["mvs_right"], n, default_grid=jnp.asarray(dg),
        out_size=out_size, f_prev_enc=None if i == 0 else jenc0) for i in (0, 1)]
    return dict(ref, maps=(j0, j1), encs=(jenc0, jenc1), logits=logits)


def assert_builders_match_jax(maps, encs, single, ref, gap=1e-4, enc_tol=TOL):
    """The raw next-key encodings agree like the encoder does; the single-
    window builder gives the full program's maps; the int32 maps equal
    JAX's wherever the top-2 logit gap exceeds ``gap``."""
    n, out_size = ref["n"], ref["out_size"]
    for ours, theirs in zip(encs, ref["encs"]):
        np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), **enc_tol)
    np.testing.assert_array_equal(single.numpy(), maps[0].numpy())
    for ours, theirs, lg in zip(maps, ref["maps"], ref["logits"]):
        assert ours.dtype == torch.int32 and ours.shape == (n,) + out_size
        top2 = np.sort(np.asarray(lg), axis=-1)[..., -2:]
        clear = (top2[..., 1] - top2[..., 0]) > gap
        assert clear.mean() > 0.9
        np.testing.assert_array_equal(ours.numpy()[clear], np.asarray(theirs)[clear])


def test_cached_predict_builders_match_jax(pair, jax_windows):
    """Full window, then the cached window that reuses its next-key
    encoding, through both packages' builders."""
    _, _, port = pair
    maps, encs, single = run_port_builders(port, port.state_dict(), jax_windows)
    assert_builders_match_jax(maps, encs, single, jax_windows)


def test_predict_builders_bind_variables_not_module_weights(pair, jax_windows):
    """The builders' contract is JAX's: fn(variables, ...) depends on
    ``variables`` alone. Built on a model whose own weights come from
    another seed and called with the fixture's variables, they give the
    maps and encodings of JAX run on those variables, and exactly what the
    builders give on the fixture's own model."""
    _, _, port = pair
    other = init_from_generator_(build_model("pspnet", layers=50, with_aux=False),
                                 torch.Generator().manual_seed(11))
    own = {k: v.clone() for k, v in other.state_dict().items()}
    maps, encs, single = run_port_builders(other, port.state_dict(), jax_windows)
    assert_builders_match_jax(maps, encs, single, jax_windows)
    ref_maps, ref_encs, _ = run_port_builders(port, port.state_dict(), jax_windows)
    for a, b in zip(maps + encs, ref_maps + ref_encs):
        assert torch.equal(a, b)
    # the module's own weights are untouched
    for k, v in other.state_dict().items():
        assert torch.equal(v, own[k]), k


def test_predict_builders_split_decode_for_the_seghead(pair, jax_windows, monkeypatch):
    """PSPNet's SegHead decodes the key map and the interpolated maps as
    two calls (the JAX package's _decode_split_ok); the tail window, one."""
    _, _, port = pair
    assert decode_split_ok(port)
    batches = []
    decode = port.decode
    monkeypatch.setattr(port, "decode", lambda f: batches.append(f.shape[0]) or decode(f))
    n, wins, frames = jax_windows["n"], jax_windows["wins"], jax_windows["frames"]
    fn = make_flow_predict_fn(port, n=n, out_size=jax_windows["out_size"],
                              default_grid=jax_windows["dg"], device="cpu")
    fn(port.state_dict(), frames[0], frames[1], wins[0]["mvs_left"], wins[0]["mvs_right"])
    assert batches == [1, n - 1]


def test_predict_builders_raise_on_int8():
    """The int8 encoder trunk is not ported: asking for it raises. (The int8
    decoder is, tests/test_torch_flow_int8.py.)"""
    m = torch.nn.Module()
    with pytest.raises(NotImplementedError, match="int8 encoder trunk"):
        make_flow_predict_fn(m, n=5, int8_encode=True, device="cpu")
    with pytest.raises(NotImplementedError, match="int8 encoder trunk"):
        make_cached_flow_predict_fn(m, n=5, int8_encode=True, device="cpu")


def test_cached_builder_unfused_argmax_matches_fused(pair, jax_windows):
    """The unfused epilogue (fused_argmax=False: resize, then argmax) no
    longer raises: over both windows it gives the fused builders' maps
    wherever the top-2 logit gap exceeds 1e-4, and the same encodings."""
    _, _, port = pair
    n, out_size, dg = (jax_windows[k] for k in ("n", "out_size", "dg"))
    wins, frames = jax_windows["wins"], jax_windows["frames"]
    out = {}
    for fused in (True, False):
        full, cached = make_cached_flow_predict_fn(port, n=n, out_size=out_size,
                                                   default_grid=dg, fused_argmax=fused,
                                                   device="cpu")
        m0, enc0 = full(port.state_dict(), frames[0], frames[1], wins[0]["mvs_left"],
                        wins[0]["mvs_right"])
        m1, enc1 = cached(port.state_dict(), enc0, frames[3], wins[1]["mvs_left"],
                          wins[1]["mvs_right"])
        out[fused] = (m0, m1, enc0, enc1)
    for i, lg in enumerate(jax_windows["logits"]):
        top2 = np.sort(np.asarray(lg), axis=-1)[..., -2:]
        clear = (top2[..., 1] - top2[..., 0]) > 1e-4
        assert clear.mean() > 0.9 and out[False][i].dtype == torch.int32
        np.testing.assert_array_equal(out[False][i].numpy()[clear], out[True][i].numpy()[clear])
    assert torch.equal(out[False][2], out[True][2]) and torch.equal(out[False][3], out[True][3])


def test_full_precision_f32_is_scoped():
    """TF32 and the bf16 reduced-precision reduction are off inside the
    block and the caller's flags come back after, also when the block
    raises."""
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul

    def flags():
        return (cudnn.allow_tf32, matmul.allow_tf32,
                matmul.allow_bf16_reduced_precision_reduction)

    prev = flags()
    try:
        (cudnn.allow_tf32, matmul.allow_tf32,
         matmul.allow_bf16_reduced_precision_reduction) = True, True, True
        with pytest.raises(ValueError):
            with full_precision_f32():
                assert flags() == (False, False, False)
                raise ValueError
        assert flags() == (True, True, True)
    finally:
        (cudnn.allow_tf32, matmul.allow_tf32,
         matmul.allow_bf16_reduced_precision_reduction) = prev


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
    weights, so the two agree within 1 grey level. The sample-dict
    ``Resize`` gives the same frames."""
    cv2 = pytest.importorskip("cv2")
    img = np.random.default_rng(4).integers(0, 256, (64, 48, 3), dtype=np.uint8)
    ours = resize_frames(img, (65, 65)).numpy()
    ref = cv2.resize(img, (65, 65), interpolation=cv2.INTER_LINEAR)
    assert ours.dtype == np.uint8 and ours.shape == ref.shape
    assert np.abs(ours.astype(int) - ref.astype(int)).max() <= 1
    sample = Resize((65, 65))({"frame_prev": img}, np.random.default_rng(0))
    np.testing.assert_array_equal(sample["frame_prev"], ours)
    assert MEAN == list(JAX_MEAN) and STD == list(JAX_STD)


def test_port_imports_no_jax():
    """No module of floodseg_tpu_torch, and not chip_smoke.py, imports jax,
    floodseg_tpu, PIL, cv2, imageio or yaml; checked in a fresh
    interpreter's sys.modules after importing every module of the port and
    the test, profiling, s4GAN, U2PL and CLI entry points by name (the
    config, checkpoint, logging, runner and main modules)."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import floodseg_tpu_torch as pkg\n"
        "for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "from floodseg_tpu_torch.ops import grid_sample_matmul\n"
        "from floodseg_tpu_torch.train import (make_crop_forward, make_flow_phase_fns,\n"
        "    make_flow_test_crop_fn, multi_scale_test, profile_predict_phases, run_test,\n"
        "    sliding_window_predict, flow_sliding_window_test, run_gan_fit,\n"
        "    make_gan_train_step, role_datasets, train_loaders, run_contrastive_fit,\n"
        "    make_u2pl_steps, create_u2pl_state, sync_teacher, contra_memobank_loss)\n"
        "from floodseg_tpu_torch.models import S4GANDiscriminator, with_rep\n"
        "from floodseg_tpu_torch.ops.u2pl import U2PLDraws, generate_unsup_data\n"
        "from floodseg_tpu_torch.core.config import load_config, fit_config\n"
        "from floodseg_tpu_torch.core.checkpoint import CheckpointManager\n"
        "from floodseg_tpu_torch.core.logging import RunLogger\n"
        "from floodseg_tpu_torch.cli.runner import Runner\n"
        "from floodseg_tpu_torch.cli.main import main, run\n"
        "from floodseg_tpu_torch.models.torch_import import load_torch_file\n"
        "load_config([f'configs/{n}.yaml' for n in ('train_base', 'train_flow_supervised',\n"
        "                                            'dataset_flow', 'pspnet')])\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('jax', 'floodseg_tpu', 'PIL', 'cv2', 'imageio', 'yaml'))\n"
        "print('BAD', bad)\n"
        "assert not bad, bad\n"
        "for m in ('ops.warp_kernels', 'ops.quant', 'ops.resize_kernels',\n"
        "          'models.deeplabv3', 'models.vit', 'ops.metrics', 'core.profiler',\n"
        "          'data.image', 'data.avi', 'data.dataset', 'data.loader',\n"
        "          'data.synthetic', 'data.transforms', 'train.evaluate',\n"
        "          'train.predict', 'train.gan', 'models.discriminator', 'ops.u2pl',\n"
        "          'train.memory_bank', 'train.contrastive', 'models.semi',\n"
        "          'core.config', 'core.yaml_subset', 'core.checkpoint', 'core.logging',\n"
        "          'cli.runner', 'cli.main', 'models.torch_import'):\n"
        "    assert 'floodseg_tpu_torch.' + m in sys.modules, m\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "BAD []" in res.stdout
