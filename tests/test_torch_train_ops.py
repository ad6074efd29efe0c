"""The training slice's ops against the JAX package's, on the CPU.

The warp's backward (the plain K1-bwd against ``jax.vjp`` of
floodseg_tpu/ops/grid_sample.py::grid_sample, the autograd wrapper against
PyTorch's autograd of the plain forward), the masked warp chains and the
interpolator's training forward with their gradients, BatchNorm in
training mode with its running statistics, the channel dropout given
flax's keep mask, the losses, the optimizers and the head mask through the
weight bridge. Inputs are made from seeded numpy generators and go through
both packages; float64 comparisons run JAX under ``jax.enable_x64``. Each
assert states its tolerance.
"""

import jax
import jax.numpy as jnp
import flax.linen as fnn
import numpy as np
import optax
import pytest
import torch

from floodseg_tpu.models import build_model as jax_build_model
from floodseg_tpu.models.layers import TorchBatchNorm
from floodseg_tpu.models.vit import SegmenterViT as JaxSegmenterViT
from floodseg_tpu.ops import losses as jl
from floodseg_tpu.ops.grid_sample import grid_sample as jax_grid_sample
from floodseg_tpu.train import optim as jax_optim
from floodseg_tpu.train.supervised import make_loss_fn as jax_make_loss_fn
from floodseg_tpu.video import flow_model as jfm

from floodseg_tpu_torch.models import SegmenterViT, build_model
from floodseg_tpu_torch.models.layers import BatchNorm2d, Dropout, dropout_generator
from floodseg_tpu_torch.ops import (
    grid_sample,
    grid_sample_autograd,
    grid_sample_backward,
    grid_sample_backward_cuda,
    launch_counts,
    losses,
    reset_launch_counts,
)
from floodseg_tpu_torch.train import (
    TrainState,
    head_mask,
    make_loss_fn,
    make_optimizer,
    poly_schedule,
)
from floodseg_tpu_torch.train.state import overlay
from floodseg_tpu_torch.video import FlowInterpolator, interp_weight, warp_chain_masked

from torch_port_fixtures import jax_head_mask_through_bridge

F64 = dict(rtol=1e-7, atol=0.0)


def _t(a):
    return torch.from_numpy(np.array(a))


def _grid(kind, rng, b, h, w, align):
    """clamp: points past the border on a smaller grid; shape: a smooth grid
    of another shape inside the frame; identity: every pixel's own centre."""
    if kind == "clamp":
        return rng.uniform(-1.5, 1.5, (b, 5, 7, 2)).astype(np.float32)
    if kind == "shape":
        base = np.stack(np.meshgrid(np.linspace(-0.9, 0.9, 6), np.linspace(-0.9, 0.9, 4)), -1)
        return (base[None] + rng.uniform(-0.05, 0.05, (b, 4, 6, 2))).astype(np.float32)
    if align:
        xs, ys = np.linspace(-1, 1, w), np.linspace(-1, 1, h)
    else:
        xs, ys = (2 * np.arange(w) + 1) / w - 1, (2 * np.arange(h) + 1) / h - 1
    g = np.stack(np.meshgrid(xs, ys), -1)[None].repeat(b, 0)
    return g.astype(np.float32)


# -------------------------------------------------------------- warp backward

@pytest.mark.parametrize("kind", ["clamp", "shape", "identity"])
@pytest.mark.parametrize("align", [False, True])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_grid_sample_backward_matches_jax_vjp(dtype, align, kind):
    """The plain K1-bwd against jax.vjp of the XLA warp: float64 within
    rtol 1e-7, float32 within rtol 1e-5 (the sums run in another order),
    both with atol 1e-6 of the gradient's largest magnitude for elements
    that cancel to about zero."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 9, 11, 6)).astype(dtype)
    grid = _grid(kind, rng, 2, 9, 11, align)
    g = rng.standard_normal((2,) + grid.shape[1:3] + (6,)).astype(dtype)
    with jax.enable_x64(dtype == "float64"):
        _, vjp = jax.vjp(lambda v: jax_grid_sample(v, jnp.asarray(grid), align), jnp.asarray(x))
        ref = np.asarray(vjp(jnp.asarray(g))[0])
    ours = grid_sample_backward(_t(g), _t(grid), x.shape, align).numpy()
    assert ours.dtype == ref.dtype
    rtol = 1e-7 if dtype == "float64" else 1e-5
    np.testing.assert_allclose(ours, ref, rtol=rtol, atol=1e-6 * np.abs(ref).max())


@pytest.mark.parametrize("align", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_autograd_wrapper_matches_plain_autograd(dtype, align):
    """grid_sample_autograd's gradient (the plain K1-bwd on the CPU) against
    PyTorch's autograd through the plain forward; no launch is counted."""
    rng = np.random.default_rng(4)
    x0 = _t(rng.standard_normal((2, 9, 11, 8))).to(dtype)
    grid = _t(_grid("clamp", rng, 2, 9, 11, align))
    cot = _t(rng.standard_normal((2, 5, 7, 8))).to(dtype)
    reset_launch_counts()
    grads = []
    for fn in (grid_sample_autograd, grid_sample):
        x = x0.clone().requires_grad_(True)
        out = fn(x, grid, align)
        (out * cot).sum().backward()
        grads.append((out.detach(), x.grad))
    np.testing.assert_array_equal(grads[0][0].numpy(), grads[1][0].numpy())
    tol = 1e-12 if dtype == torch.float64 else 1e-5
    np.testing.assert_allclose(grads[0][1].numpy(), grads[1][1].numpy(), rtol=tol, atol=tol)
    assert all(v == 0 for v in launch_counts().values())


def test_autograd_wrapper_refuses_a_grid_gradient_and_bad_shapes():
    x = torch.zeros((1, 4, 4, 8), requires_grad=True)
    grid = torch.zeros((1, 2, 2, 2), requires_grad=True)
    with pytest.raises(ValueError, match="no gradient"):
        grid_sample_autograd(x, grid)
    g = torch.zeros((1, 2, 2, 8))
    with pytest.raises(ValueError, match="do not match"):
        grid_sample_backward_cuda(g, grid.detach(), (1, 4, 4, 4))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        grid_sample_backward_cuda(g.double(), grid.detach(), (1, 4, 4, 8))
    with pytest.raises(ValueError, match="contiguous"):
        grid_sample_backward_cuda(torch.zeros((1, 8, 2, 2)).permute(0, 2, 3, 1),
                                  grid.detach(), (1, 4, 4, 8))
    # CPU float32 takes the plain version
    out = grid_sample_backward_cuda(torch.ones((1, 2, 2, 8)), grid.detach(), (1, 4, 4, 8))
    assert out.shape == (1, 4, 4, 8) and float(out.sum()) == pytest.approx(4 * 8)


# --------------------------------------------------------- masked chains

def _smooth(rng, t, b, gh, gw):
    """Near-identity grids on multiples of 2**-10: their float32 tap
    coordinates are exact, so XLA's fusing of that arithmetic into fused
    multiply-adds (it does inside lax.scan) changes no weight and float64
    comparisons measure the algorithm."""
    base = np.stack(np.meshgrid(np.linspace(-1, 1, gw), np.linspace(-1, 1, gh)), -1)
    g = base[None, None] + rng.uniform(-0.15, 0.15, (t, b, gh, gw, 2))
    return (np.round(g * 1024) / 1024).astype(np.float32)


@pytest.mark.parametrize("index", [(1, 3), (4, 2)])
def test_warp_chain_masked_matches_jax(index):
    """Values and the gradient with respect to f (a random cotangent) in
    float64, within rtol 1e-7, per-sample chain lengths."""
    rng = np.random.default_rng(5)
    f = rng.standard_normal((2, 7, 9, 4))
    grids = _smooth(rng, 4, 2, 3, 4)
    cot = rng.standard_normal((2, 7, 9, 4))
    idx = np.asarray(index, np.int32)
    with jax.enable_x64(True):
        ref, vjp = jax.vjp(lambda v: jfm.warp_chain_masked(v, jnp.asarray(grids),
                                                           jnp.asarray(idx)), jnp.asarray(f))
        ref_g = np.asarray(vjp(jnp.asarray(cot))[0])
    x = _t(f).requires_grad_(True)
    out = warp_chain_masked(x, _t(grids), _t(idx))
    (out * _t(cot)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), **F64)
    np.testing.assert_allclose(x.grad.numpy(), ref_g, rtol=1e-7, atol=1e-12)


def test_interp_weight_matches_jax():
    idx, n = np.array([1, 3, 24]), np.array([25, 25, 25])
    for jdt, tdt in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)):
        ref = np.asarray(jfm.interp_weight(jnp.asarray(idx), jnp.asarray(n), jdt)
                         .astype(jnp.float32))
        ours = interp_weight(_t(idx), _t(n), tdt).float().numpy()
        np.testing.assert_array_equal(ours, ref)


@pytest.mark.parametrize("no_warp", [False, True])
@pytest.mark.parametrize("feature_based", [True, False])
def test_train_forward_matches_jax(feature_based, no_warp):
    """FlowInterpolator.train_forward with linear encode and decode maps:
    logits and the gradients with respect to both key frames and both maps'
    weights, float64 within rtol 1e-7."""
    rng = np.random.default_rng(6)
    b, s, c, k = 2, 13, 6, 3
    fp, fn = rng.standard_normal((2, b, s, s, 3))
    we, wd = rng.standard_normal((3, c)), rng.standard_normal((c, k))
    ml, mr = _smooth(rng, 3, b, 2, 3), _smooth(rng, 3, b, 2, 3)
    li, ri = np.array([1, 3], np.int32), np.array([3, 2], np.int32)
    cot = rng.standard_normal((b, 17, 19, k))

    def pool(x, xp):  # 13 -> 7: stride-2 sampling then a linear map
        return x[:, ::2, ::2]

    with jax.enable_x64(True):
        def jfwd(fp_, fn_, we_, wd_):
            interp = jfm.FlowInterpolator(
                encode=lambda x: jnp.einsum("bhwc,cd->bhwd", pool(x, jnp), we_),
                decode=lambda f: jnp.einsum("bhwc,cd->bhwd", f, wd_),
                feature_based=feature_based, no_warp=no_warp)
            return interp.train_forward(fp_, fn_, jnp.asarray(ml), jnp.asarray(mr),
                                        jnp.asarray(li), jnp.asarray(ri), out_size=(17, 19))
        args = [jnp.asarray(a) for a in (fp, fn, we, wd)]
        ref, vjp = jax.vjp(jfwd, *args)
        ref_grads = [np.asarray(g) for g in vjp(jnp.asarray(cot))]

    tens = [_t(a).requires_grad_(True) for a in (fp, fn, we, wd)]
    interp = FlowInterpolator(
        encode=lambda x: torch.einsum("bhwc,cd->bhwd", pool(x, torch), tens[2]).contiguous(),
        decode=lambda f: torch.einsum("bhwc,cd->bhwd", f, tens[3]).contiguous(),
        feature_based=feature_based, no_warp=no_warp)
    out = interp.train_forward(tens[0], tens[1], _t(ml), _t(mr), _t(li), _t(ri),
                               out_size=(17, 19))
    (out * _t(cot)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), **F64)
    for t, g in zip(tens, ref_grads):
        np.testing.assert_allclose(t.grad.numpy(), g, rtol=1e-7, atol=1e-10)


# ------------------------------------------------------- BN and dropout

@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_batchnorm_train_matches_jax(dtype):
    """Training-mode BN: output, gradients and the running statistics after
    two calls, against TorchBatchNorm (float64 within rtol 1e-7 and 1e-12;
    float32 within 1e-5 and 1e-6)."""
    rng = np.random.default_rng(7)
    x = (rng.standard_normal((3, 5, 6, 8)) * 2 + 0.5).astype(dtype)
    scale, bias = rng.uniform(0.5, 1.5, 8).astype(dtype), rng.normal(0, 0.1, 8).astype(dtype)
    rm, rv = rng.normal(0, 0.1, 8).astype(dtype), rng.uniform(0.5, 1.5, 8).astype(dtype)
    cot = rng.standard_normal(x.shape).astype(dtype)
    jdt = jnp.float64 if dtype == "float64" else jnp.float32
    with jax.enable_x64(dtype == "float64"):
        bn = TorchBatchNorm(use_running_average=False, dtype=jdt, param_dtype=jdt)
        stats = {"mean": jnp.asarray(rm), "var": jnp.asarray(rv)}

        def f(xx, s, bb, st):
            y, mut = bn.apply({"params": {"scale": s, "bias": bb}, "batch_stats": st}, xx,
                              mutable=["batch_stats"])
            return y, mut["batch_stats"]

        (ref, st1), vjp = jax.vjp(lambda xx, s, bb: f(xx, s, bb, stats), jnp.asarray(x),
                                  jnp.asarray(scale), jnp.asarray(bias))
        zeros = jax.tree.map(jnp.zeros_like, st1)
        ref_grads = [np.asarray(g) for g in vjp((jnp.asarray(cot), zeros))]
        _, st2 = f(jnp.asarray(x) * 0.5, jnp.asarray(scale), jnp.asarray(bias), st1)

    tdt = torch.float64 if dtype == "float64" else torch.float32
    m = BatchNorm2d(8, tdt).to(tdt).train()
    with torch.no_grad():
        m.weight.copy_(_t(scale))
        m.bias.copy_(_t(bias))
        m.running_mean.copy_(_t(rm))
        m.running_var.copy_(_t(rv))
    xt = _t(x).permute(0, 3, 1, 2).requires_grad_(True)
    y = m(xt)
    (y * _t(cot).permute(0, 3, 1, 2)).sum().backward()
    tol = dict(rtol=1e-7, atol=1e-12) if dtype == "float64" else dict(rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(y.detach().permute(0, 2, 3, 1).numpy(), np.asarray(ref), **tol)
    for got, want in ((xt.grad.permute(0, 2, 3, 1), ref_grads[0]), (m.weight.grad, ref_grads[1]),
                      (m.bias.grad, ref_grads[2])):
        np.testing.assert_allclose(got.numpy(), want, **tol)
    np.testing.assert_allclose(m.running_mean.numpy(), np.asarray(st1["mean"]), **tol)
    np.testing.assert_allclose(m.running_var.numpy(), np.asarray(st1["var"]), **tol)
    with torch.no_grad():
        m(_t(x).permute(0, 3, 1, 2) * 0.5)
    np.testing.assert_allclose(m.running_mean.numpy(), np.asarray(st2["mean"]), **tol)
    np.testing.assert_allclose(m.running_var.numpy(), np.asarray(st2["var"]), **tol)


def _flax_keep_mask(shape, key):
    """flax's channel-dropout mask, read by applying the JAX SegHead's
    Dropout (rate 0.1, broadcast over H and W) to ones: (B, C) bool."""
    out = fnn.Dropout(0.1, broadcast_dims=(1, 2)).apply(
        {}, jnp.ones(shape), deterministic=False, rngs={"dropout": key})
    return np.asarray(out[:, 0, 0, :] != 0)


def test_channel_dropout_matches_flax_given_its_mask():
    """With flax's keep mask injected, the channel dropout gives flax's output
    to the bit (float32), and its gradient keeps the same channels."""
    rng = np.random.default_rng(8)
    x = rng.standard_normal((3, 4, 5, 64)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    keep = _flax_keep_mask(x.shape, key)
    assert 0 < keep.mean() < 1
    ref = np.asarray(fnn.Dropout(0.1, broadcast_dims=(1, 2)).apply(
        {}, jnp.asarray(x), deterministic=False, rngs={"dropout": key}))
    d = Dropout(0.1, broadcast_dims=(2, 3)).train()
    d.keep = _t(keep)[:, :, None, None]
    xt = _t(x).permute(0, 3, 1, 2).requires_grad_(True)
    y = d(xt)
    np.testing.assert_array_equal(y.detach().permute(0, 2, 3, 1).numpy(), ref)
    y.sum().backward()
    np.testing.assert_array_equal(xt.grad[:, :, 0, 0].numpy() != 0, keep)


def test_channel_dropout_draws_from_its_generator_only():
    d = Dropout(0.1, broadcast_dims=(2, 3)).train()
    x = torch.ones((8, 512, 2, 2))
    with pytest.raises(RuntimeError, match="generator"):
        d(x)
    outs = []
    for _ in range(2):
        with dropout_generator(d, torch.Generator().manual_seed(5)):
            outs.append(d(x))
    assert d.generator is None
    np.testing.assert_array_equal(outs[0].numpy(), outs[1].numpy())
    kept = (outs[0][:, :, 0, 0] != 0).float().mean().item()
    assert 0.85 < kept < 0.95  # keep probability 0.9 over 4096 channel maps
    assert torch.equal(d.eval()(x), x)


def test_pspnet_train_mode_returns_aux_and_seg_head_keys_stay():
    m = build_model("pspnet", with_aux=True)
    assert isinstance(m.cls[3], Dropout) and "cls.4.weight" in m.state_dict()
    m.train()
    for mod in m.modules():
        if isinstance(mod, Dropout):
            mod.rate = 0.0
    out = m(torch.zeros((1, 17, 17, 3)))
    assert set(out) == {"pred", "aux"} and out["aux"].shape == (1, 17, 17, 5)
    assert set(m.eval()(torch.zeros((1, 17, 17, 3)))) == {"pred"}


# ------------------------------------------------------------------- losses

def _logits_labels(rng, b=2, h=9, w=11, c=5, ignore=0.1):
    logits = rng.standard_normal((b, h, w, c)) * 2
    labels = rng.integers(0, c, (b, h, w))
    labels = np.where(rng.random(labels.shape) < ignore, 255, labels).astype(np.int32)
    return logits, labels


@pytest.mark.parametrize("min_kept,thresh", [
    (100000, 0.7),   # min_kept above the valid pixels: no mining
    (150, 0.7),      # the 150th probability below 0.7: the threshold is 0.7
    (150, 0.01),     # the 150th probability above thresh: it is the threshold
])
def test_ohem_matches_jax(min_kept, thresh):
    """OHEM CE value and gradient in float64 (rtol 1e-10), in each of the
    three regimes of min_kept, and ohem_with_aux."""
    rng = np.random.default_rng(9)
    logits, labels = _logits_labels(rng)
    aux = rng.standard_normal(logits.shape)
    with jax.enable_x64(True):
        def f(lg, ax):
            return jl.ohem_with_aux(lg, ax, jnp.asarray(labels), 0.4, 255, thresh, min_kept)
        ref, vjp = jax.vjp(f, jnp.asarray(logits), jnp.asarray(aux))
        ref_g = [np.asarray(g) for g in vjp(jnp.asarray(1.0))]
        main = float(jl.ohem_cross_entropy(jnp.asarray(logits), jnp.asarray(labels), 255,
                                           thresh, min_kept))
    lg, ax = _t(logits).requires_grad_(True), _t(aux).requires_grad_(True)
    out = losses.ohem_with_aux(lg, ax, _t(labels), 0.4, 255, thresh, min_kept)
    out.backward()
    assert float(out.detach()) == pytest.approx(float(ref), rel=1e-10)
    assert float(losses.ohem_cross_entropy(_t(logits), _t(labels), 255, thresh, min_kept)) \
        == pytest.approx(main, rel=1e-10)
    np.testing.assert_allclose(lg.grad.numpy(), ref_g[0], rtol=1e-10, atol=1e-14)
    np.testing.assert_allclose(ax.grad.numpy(), ref_g[1], rtol=1e-10, atol=1e-14)


@pytest.mark.parametrize("with_aux", [False, True])
def test_cross_entropy_matches_jax(with_aux):
    """Plain CE, alone and with the aux term (make_loss_fn("ce")), float64
    within rtol 1e-10."""
    rng = np.random.default_rng(10)
    logits, labels = _logits_labels(rng)
    aux = rng.standard_normal(logits.shape) if with_aux else None
    with jax.enable_x64(True):
        out = {"pred": jnp.asarray(logits), "aux": None if aux is None else jnp.asarray(aux)}
        ref = float(jax_make_loss_fn("ce", 0.4, 255)(out, jnp.asarray(labels)))
    ours = make_loss_fn("ce", 0.4, 255)({"pred": _t(logits),
                                         "aux": None if aux is None else _t(aux)}, _t(labels))
    assert float(ours) == pytest.approx(ref, rel=1e-10)
    if not with_aux:
        assert float(losses.cross_entropy_loss(_t(logits), _t(labels), 255)) \
            == pytest.approx(ref, rel=1e-10)


def test_loss_in_float32_of_bf16_logits():
    rng = np.random.default_rng(11)
    logits, labels = _logits_labels(rng)
    lb = _t(logits).to(torch.bfloat16)
    ref = float(jl.ohem_cross_entropy(jnp.asarray(lb.float().numpy()).astype(jnp.bfloat16),
                                      jnp.asarray(labels), 255, 0.7, 150))
    ours = losses.ohem_cross_entropy(lb, _t(labels), 255, 0.7, 150)
    assert ours.dtype == torch.float32
    assert float(ours) == pytest.approx(ref, rel=1e-5)


# ---------------------------------------------------- optimizer and mask

class _Tiny(torch.nn.Module):
    """A PSPNet-shaped module tree: trunk ``layer1``, heads ``ppm``, ``cls``
    and ``aux`` (which gets no gradient)."""

    def __init__(self, rng):
        super().__init__()
        for name, shape in (("layer1", (4, 3)), ("ppm", (3, 3)), ("cls", (3, 2)),
                            ("aux", (2, 2))):
            lin = torch.nn.Module()
            lin.weight = torch.nn.Parameter(_t(rng.standard_normal(shape).astype(np.float32)))
            setattr(self, name, lin)


@pytest.mark.parametrize("opt", ["sgd", "adam"])
def test_optimizer_matches_optax_with_head_group(opt):
    """Three steps of the port's optimizer and poly schedule with the head
    group at 10x against make_optimizer's optax chain, float32 within rtol
    1e-5; the aux parameters get no gradient and are still decayed and
    moved, as optax moves a zero-gradient parameter."""
    rng = np.random.default_rng(12)
    model = _Tiny(rng)
    tops = {"layer1": "backbone", "ppm": "ppm", "cls": "cls", "aux": "aux"}
    params = {tops[n.split(".")[0]]: {"k": jnp.asarray(p.detach().numpy())}
              for n, p in model.named_parameters()}
    grads = [{k: {"k": rng.standard_normal(v["k"].shape).astype(np.float32)}
              for k, v in params.items()} for _ in range(3)]
    base_lr, max_iter, wd = (0.01 if opt == "sgd" else 0.001), 10, 1e-4
    tx = jax_optim.make_optimizer(base_lr, max_iter, opt, 0.9, wd)
    state = tx.init(params)
    for g in grads:
        g = {k: ({"k": jnp.zeros_like(v["k"])} if k == "aux" else v) for k, v in g.items()}
        upd, state = tx.update(jax.tree.map(jnp.asarray, g), state, params)
        params = optax.apply_updates(params, upd)

    torch_opt, sched = make_optimizer(model, base_lr, max_iter, opt, 0.9, wd)
    ts = TrainState(0, model, torch_opt, sched)
    for g in grads:
        torch_opt.zero_grad(set_to_none=True)
        for n, p in model.named_parameters():
            top = tops[n.split(".")[0]]
            if top != "aux":
                p.grad = _t(g[top]["k"])
        ts.apply_gradients()
    assert ts.step == 3
    for n, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(params[tops[n.split(".")[0]]]["k"]),
                                   rtol=1e-5, atol=1e-6, err_msg=n)


def test_poly_schedule_matches_jax():
    """The LR of each step in float32, as the JAX schedule computes it
    from its int32 step (equal, or one float32 ulp apart where the two
    libraries' float32 powers round apart)."""
    ours, ref = poly_schedule(1e-4, 37), jax_optim.poly_schedule(1e-4, 37)
    for k in (0, 1, 5, 36, 37, 40):
        assert ours(k) == pytest.approx(float(ref(jnp.asarray(k, jnp.int32))), rel=1.2e-7)
    assert ours(0) == float(np.float32(1e-4))


@pytest.mark.parametrize("arch", ["pspnet", "deeplabv3", "vit"])
def test_head_mask_equals_jax_through_the_bridge(arch):
    """The set of parameters at 10x LR equals JAX's head_mask carried
    through the bridge, for every parameter of each architecture."""
    if arch == "vit":
        cfg = dict(image_size=64, patch_size=32, d_model=64, n_layers=1, dec_layers=1,
                   n_heads=2)
        jm = JaxSegmenterViT(classes=5, dropout=0.0, **cfg)
        port = SegmenterViT(classes=5, **cfg)
    else:
        jm = jax_build_model(arch, classes=5, layers=50, with_aux=True)
        port = build_model(arch, with_aux=True)
    size = 64 if arch == "vit" else 65
    key = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(lambda: jm.init({"params": key, "dropout": key},
                                            jnp.zeros((1, size, size, 3)), train=True))
    variables = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), dict(shapes))
    want = jax_head_mask_through_bridge(variables)
    ours = head_mask(port)
    assert set(ours) <= set(want)
    assert ours == {k: want[k] for k in ours}
    assert any(ours.values()) and not all(ours.values())


def test_training_after_predict_in_one_process():
    """The resize and pooling matrices are cached on the device; a cache
    first filled inside inference mode (a predict call) must still serve a
    training step, which saves them for backward."""
    from floodseg_tpu_torch.ops import adaptive_avg_pool, resize_bilinear
    sizes = (11, 13)
    with torch.inference_mode():
        resize_bilinear(torch.zeros((1, 5, 7, 3)), sizes, align_corners=True)
        adaptive_avg_pool(torch.zeros((1, 5, 7, 3)), 3)
    x = torch.ones((1, 5, 7, 3), requires_grad=True)
    (resize_bilinear(x, sizes, align_corners=True).sum()
     + adaptive_avg_pool(x, 3).sum()).backward()
    assert x.grad is not None and torch.isfinite(x.grad).all()


def test_overlay_is_shape_checked():
    m = build_model("pspnet", with_aux=False)
    w = torch.full_like(m.state_dict()["cls.4.weight"], 0.5)
    overlay(m, {"cls.4.weight": w, "not.a.key": torch.zeros(1)})
    assert torch.equal(m.cls[4].weight.detach(), w)
    with pytest.raises(ValueError, match="pretrained shape"):
        overlay(m, {"cls.4.weight": torch.zeros(3)})
