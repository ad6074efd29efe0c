"""The port's int8 encoder trunk (floodseg_tpu_torch/ops/quant.py::
int8_resnet_trunk and ppm_folded) against the JAX package's
(floodseg_tpu/ops/quant.py), on the CPU.

The PSPNet-50 trunk (deep-base stem, every block of layer3/4 dilated, then
the folded PPM) and the DeepLabV3-50 trunk (torchvision's stem and
dilations), full width, weights drawn in numpy in the init's shapes with
every BN perturbed (tests/torch_port_fixtures.py), carried through the
weight bridge; a 49 px frame, so every map is odd-sized (25, 13, 7); the
compute dtype float32 and bfloat16. The JAX trunk runs jitted once a case
and records every block's input and output and every int8 convolution's
operands and int32 accumulator.

Held:
- every int8 convolution of the trunk (52: the 1x1s, the 3x3s at stride 2
  and at dilations 2 and 4, the strided downsample), fed JAX's int8 input
  and int8 weights, gives JAX's int32 accumulator exactly;
- each bottleneck, fed JAX's input for it, gives JAX's output within
  BLOCK_TOL of its largest magnitude, and its int8 maps agree with JAX's
  on all but LANE_SHARE of their lanes, each at most LANE_GAP steps apart.
  XLA contracts the dequantization ``acc * (sx * sw) + b_f`` into one
  fused multiply-add on the CPU where the port rounds twice, and its rsqrt
  in the BN fold differs from torch's by an ulp in about 1 value in 3, so
  a value at a rounding boundary quantizes one step apart, and a
  per-tensor scale that moves re-rounds its whole map. Measured, PSPNet /
  DeepLabV3: float32 outputs within 7.0e-4 / 1.3e-4 of scale, lanes off
  4.0e-5 / 0 at 1 step; bfloat16 within 9.2e-3 / 5.1e-3, lanes off
  9.2e-2 (one map re-rounded at a moved scale) / 7.4e-3 at 2 / 1 steps;
- the whole encoding within ENC_TOL: through 16 blocks those boundary
  cases compound, each block quantizing at the scales of its own input.
  Measured, the mean / largest gap as shares of the largest magnitude:
  float32 2.0e-3 / 3.9e-2 (PSPNet), 2.0e-4 / 8.0e-3 (DeepLabV3);
  bfloat16 2.1e-3 / 4.5e-2, 9.4e-4 / 1.0e-2.

About 31 s alone (4 JAX jits of the trunk).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from floodseg_tpu.ops import quant as jq

from floodseg_tpu_torch.ops import quant as pq

from torch_port_fixtures import deeplabv3_pair, one_torch_thread, pspnet50_pair  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

SIZE = 49
BLOCKS = {"layer1": 3, "layer2": 4, "layer3": 6, "layer4": 3}
TRUNK = {"pspnet": dict(deep_base=True, semseg_dilation=True),
         "deeplabv3": dict(deep_base=False, semseg_dilation=False)}
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
# a block's output against JAX's, share of its largest magnitude
BLOCK_TOL = {"float32": 2e-3, "bfloat16": 2e-2}
# the int8 maps inside a block fed JAX's input: share of lanes off, largest step
LANE_SHARE = {"float32": 1e-3, "bfloat16": 0.15}
LANE_GAP = {"float32": 1, "bfloat16": 2}
# the encoding: (mean, largest) gap as shares of its largest magnitude
ENC_TOL = {"float32": (5e-3, 0.1), "bfloat16": (1e-2, 0.15)}


@pytest.fixture(scope="module", params=sorted(TRUNK))
def pair(request):
    arch = request.param
    make = pspnet50_pair if arch == "pspnet" else deeplabv3_pair
    return (arch,) + make(size=SIZE, compiled_init=False)


def _jax_run(arch, params, stats, x, dtype):
    """JAX's encoding (float32), and each block's (input, output) and each
    int8 conv's (x_q, w_q, acc), recorded inside one jit."""
    block_fn, conv_fn = jq._int8_bottleneck, jq.conv_int8

    def run(params, stats, x):
        blocks, convs = [], []

        def block(p, s, x, stride, dilation, dt, eps):
            y = block_fn(p, s, x, stride, dilation, dt, eps)
            blocks.append((x.astype(jnp.float32), y.astype(jnp.float32)))
            return y

        def conv(x_q, w_q, padding, dilation=(1, 1), strides=(1, 1)):
            acc = conv_fn(x_q, w_q, padding, dilation, strides)
            convs.append((x_q, w_q, acc))
            return acc

        jq._int8_bottleneck, jq.conv_int8 = block, conv
        try:
            f = jq.int8_resnet_trunk(params["backbone"], stats["backbone"], x, depth=50,
                                     dtype=dtype, **TRUNK[arch])
            if arch == "pspnet":
                f = jq.ppm_folded(params["ppm"], stats["ppm"], f, dtype=dtype)
        finally:
            jq._int8_bottleneck, jq.conv_int8 = block_fn, conv_fn
        return f.astype(jnp.float32), blocks, convs

    return jax.device_get(jax.jit(run)(params, stats, x))


class _Convs:
    """Records the port's conv_int8 calls (operands and geometry)."""

    def __init__(self, monkeypatch):
        self.calls, conv = [], pq.conv_int8

        def recording(x_q, w_q, padding, dilation=(1, 1), strides=(1, 1)):
            self.calls.append((x_q.numpy(), w_q.numpy(), padding, tuple(dilation),
                               tuple(strides)))
            return conv(x_q, w_q, padding, dilation, strides)

        monkeypatch.setattr(pq, "conv_int8", recording)


def _trunk_state(arch, port):
    return port.state_dict() if arch == "pspnet" else port.backbone.state_dict()


def _port_encode(arch, port, x, dtype):
    with torch.no_grad():
        f = pq.int8_resnet_trunk(_trunk_state(arch, port), x, depth=50, dtype=dtype,
                                 **TRUNK[arch])
        if arch == "pspnet":
            f = pq.ppm_folded(port.ppm.state_dict(), f, dtype=dtype)
    return f


@pytest.fixture(scope="module", params=sorted(DTYPES))
def trunks(request, pair):
    arch, _, variables, port = pair
    jdt, tdt = DTYPES[request.param]
    x = np.random.default_rng(3).standard_normal((1, SIZE, SIZE, 3)).astype(np.float32)
    ref, blocks, convs = _jax_run(arch, variables["params"], variables["batch_stats"],
                                  jnp.asarray(x), jdt)
    mp = pytest.MonkeyPatch()
    rec = _Convs(mp)
    try:
        got = _port_encode(arch, port, torch.from_numpy(x), tdt)
    finally:
        mp.undo()
    return dict(arch=arch, dtype=request.param, tdt=tdt, port=port, ref=np.asarray(ref),
                got=got.float().numpy(), blocks=blocks, convs=convs, port_convs=rec.calls)


def _block_plan(arch):
    """(block name, stride, dilation) in the trunk's order."""
    semseg = TRUNK[arch]["semseg_dilation"]
    plan = []
    for name, n in BLOCKS.items():
        new = {"layer3": 2, "layer4": 4}.get(name, 1)
        prev = {"layer4": 2}.get(name, 1)
        for i in range(n):
            d = new if (semseg or i > 0) else prev
            plan.append((f"{name}.{i}", 2 if (name, i) == ("layer2", 0) else 1, d))
    return plan


def test_int8_conv_accumulators_equal_jax(trunks):
    """Each of the trunk's int8 convolutions, given JAX's int8 input and its
    HWIO weights as OIHW, gives JAX's int32 accumulator exactly; the convs
    include 3x3s at stride 2, at dilation 2 and at 4, a strided 1x1 and odd
    sizes."""
    convs, geo = trunks["convs"], trunks["port_convs"]
    assert len(convs) == len(geo) == 52
    for (x_q, w_q, acc), (_, w_port, padding, dilation, strides) in zip(convs, geo):
        w = torch.from_numpy(np.ascontiguousarray(np.asarray(w_q).transpose(3, 2, 0, 1)))
        assert w.shape == w_port.shape
        got = pq.conv_int8(torch.from_numpy(np.array(x_q)), w, padding, dilation, strides)
        np.testing.assert_array_equal(got.numpy(), np.asarray(acc))
    kinds = {(w.shape[-1], s, d) for _, w, _, d, s in geo}
    assert {(3, (2, 2), (1, 1)), (1, (2, 2), (1, 1)), (3, (1, 1), (2, 2)),
            (3, (1, 1), (4, 4))} <= kinds
    assert {x.shape[1] for x, *_ in geo} == {13, 7}


def test_int8_blocks_match_jax(trunks, monkeypatch):
    """Each bottleneck on JAX's input for it: its output within BLOCK_TOL of
    its scale; its int8 maps (conv1's input, conv2's, conv3's) off on at
    most LANE_SHARE of their lanes by at most LANE_GAP steps."""
    arch, dt, tdt, port = (trunks[k] for k in ("arch", "dtype", "tdt", "port"))
    sd = _trunk_state(arch, port)
    plan = _block_plan(arch)
    assert len(plan) == len(trunks["blocks"]) == 16
    jax_maps = [np.asarray(x_q) for x_q, _, _ in trunks["convs"]]
    k, worst = 0, (0.0, 0, 0.0)
    for (name, stride, dilation), (x, y) in zip(plan, trunks["blocks"]):
        rec = _Convs(monkeypatch)
        with torch.no_grad():
            got = pq._int8_bottleneck(sd, name, torch.from_numpy(np.array(x)).to(tdt),
                                      stride, dilation, tdt, 1e-5).float().numpy()
        ref = np.asarray(y)
        err = float(np.abs(got - ref).max() / np.abs(ref).max())
        for x_q, *_ in rec.calls:
            d = np.abs(x_q.astype(np.int32) - jax_maps[k].astype(np.int32))
            worst = (max(worst[0], float((d != 0).mean())), max(worst[1], int(d.max())),
                     worst[2])
            k += 1
        worst = worst[:2] + (max(worst[2], err),)
    assert k == len(jax_maps)
    share, gap, err = worst
    print(f"{arch} {dt}: blocks' largest gap {err:.2e} of scale, int8 lanes off "
          f"{share:.2e} at most {gap} steps")
    assert err <= BLOCK_TOL[dt]
    assert share <= LANE_SHARE[dt] and gap <= LANE_GAP[dt]


def test_int8_trunk_encoding_matches_jax(trunks):
    """The encoding (PSPNet: c4 and the folded PPM, 4096 channels;
    DeepLabV3: c4, 2048) within ENC_TOL of its largest magnitude, finite,
    of the JAX shape."""
    ref, got, dt = trunks["ref"], trunks["got"], trunks["dtype"]
    c = 4096 if trunks["arch"] == "pspnet" else 2048
    assert got.shape == ref.shape == (1, 7, 7, c) and np.isfinite(got).all()
    scale = np.abs(ref).max()
    gap = np.abs(got - ref)
    mean, largest = float(gap.mean() / scale), float(gap.max() / scale)
    print(f"{trunks['arch']} {dt}: encoding gap mean {mean:.2e}, largest {largest:.2e}")
    assert mean <= ENC_TOL[dt][0] and largest <= ENC_TOL[dt][1]


@pytest.mark.parametrize("k,stride,dilation,size", [
    (3, 2, 1, 17), (1, 2, 1, 15), (3, 1, 2, 13), (3, 1, 4, 11), (3, 2, 1, 16)])
def test_conv_int8_strided_dilated_matches_jax(k, stride, dilation, size):
    """conv_int8's im2col at stride 2 and dilations 2 and 4, on odd and even
    sizes, against JAX's int8 convolution: the int32 sums equal."""
    rng = np.random.default_rng(k * 100 + stride * 10 + dilation)
    x = rng.integers(-127, 128, (2, size, size, 24)).astype(np.int8)
    w = rng.integers(-127, 128, (k, k, 24, 40)).astype(np.int8)
    p = (k // 2) * dilation
    padding = ((p, p), (p, p))
    want = jq.conv_int8(jnp.asarray(x), jnp.asarray(w), padding, (dilation,) * 2, (stride,) * 2)
    got = pq.conv_int8(torch.from_numpy(x), torch.from_numpy(w.transpose(3, 2, 0, 1).copy()),
                       padding, (dilation,) * 2, (stride,) * 2)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
