"""The port's predict builders with the int8 encoder (``int8_encode=True``)
against the JAX package's ``make_flow_predict_fn(int8_encode=True)``, on
the CPU.

PSPNet-50 (the deep-base trunk and the folded PPM) with the full-precision
and the int8 decoder, and DeepLabV3-50 (the torchvision trunk) with the
full-precision one, at 65 px key frames, 4x4 block grids, n = 5, float32,
weights drawn in numpy in the init's shapes with every BN perturbed. The
JAX builder runs jitted on window 0 and on window 1 (whose previous key is
window 0's next one); the port's cached builders run window 0 whole and
window 1 from window 0's next-key encoding, its single-window builder
window 0.

Held: the single-window maps equal the full program's; the maps of each
window equal JAX's on at least MAP_SHARE of the pixels. The int8 trunk
agrees with JAX's up to quantization boundary cases that compound through
the blocks (tests/test_torch_int8_trunk.py), which move pixels near a
class tie, more with the int8 decoder, which quantizes the encodings
again (measured: 0.9978-0.9995 of the pixels equal with the
full-precision decoders, 0.9908 and 0.9974 with the int8 one).

Also: the builders fold and quantize the variables bound for the call,
not the module's weights; the ViT raises (tests/test_torch_flow_vit.py);
and ``run_flow_predict`` passes ``int8_encode`` to the whole-frame
(``no_cropping``) builders only, never to the crop route's, as the JAX
Runner does.

About 47 s alone (3 JAX predict programs, the int8 decoder's the slowest).
"""

import numpy as np
import pytest
import torch

from floodseg_tpu.train.flow import make_flow_predict_fn as jax_predict_fn

from floodseg_tpu_torch.data import generate_synthetic_dataset
from floodseg_tpu_torch.models import build_model, init_from_generator_
from floodseg_tpu_torch.ops import launch_counts, reset_launch_counts
from floodseg_tpu_torch.train import predict as port_predict
from floodseg_tpu_torch.train import run_flow_predict

from torch_port_fixtures import (  # noqa: F401
    builder_windows,
    deeplabv3_pair,
    jnorm,
    one_torch_thread,
    pspnet50_pair,
    run_port_builders,
)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

MAP_SHARE = 0.98
CASES = [("pspnet", False), ("pspnet", True), ("deeplabv3", False)]


@pytest.fixture(scope="module")
def windows():
    return builder_windows()


@pytest.fixture(scope="module")
def pairs():
    return {"pspnet": pspnet50_pair(size=65, compiled_init=False),
            "deeplabv3": deeplabv3_pair(size=65, compiled_init=False)}


def _jax_maps(jm, variables, ref, int8_decode):
    n, out_size, wins, frames, dg = (ref[k] for k in ("n", "out_size", "wins", "frames", "dg"))
    fn = jax_predict_fn(jm, n=n, out_size=out_size, default_grid=dg, int8_decode=int8_decode,
                        int8_encode=True)
    return [np.asarray(fn(variables, jnorm(frames[2 * i]), jnorm(frames[2 * i + 1]),
                          wins[i]["mvs_left"], wins[i]["mvs_right"])) for i in (0, 1)]


@pytest.fixture(scope="module", params=CASES, ids=["pspnet", "pspnet_int8_decode",
                                                   "deeplabv3"])
def case(request, pairs, windows):
    arch, int8_decode = request.param
    jm, variables, port = pairs[arch]
    ref = _jax_maps(jm, variables, windows, int8_decode)
    reset_launch_counts()
    maps, encs, single = run_port_builders(port, port.state_dict(), windows,
                                           int8_encode=True, int8_decode=int8_decode)
    launches = launch_counts()
    return dict(arch=arch, int8_decode=int8_decode, ref=ref, maps=maps, encs=encs,
                single=single, launches=launches)


def test_int8_encode_builders_match_jax(case):
    """Window 0 (full program) and window 1 (cached, from window 0's next-key
    encoding) equal JAX's maps on at least MAP_SHARE of the pixels; the
    single-window builder gives the full program's maps; on the CPU no
    kernel launch is counted."""
    n, out_size = 5, (72, 80)
    assert torch.equal(case["single"], case["maps"][0])
    c = 4096 if case["arch"] == "pspnet" else 2048
    assert case["encs"][0].shape == (1, 9, 9, c)
    shares = []
    for ours, theirs in zip(case["maps"], case["ref"]):
        assert ours.dtype == torch.int32 and ours.shape == (n,) + out_size
        shares.append(float((ours.numpy() == theirs).mean()))
    print(case["arch"], case["int8_decode"], shares)
    assert min(shares) >= MAP_SHARE
    assert all(v == 0 for v in case["launches"].values())


@pytest.mark.parametrize("arch", ["pspnet", "deeplabv3"])
def test_int8_encode_binds_variables_not_module_weights(pairs, windows, arch):
    """The int8 trunk folds and quantizes the variables bound for the call:
    builders made on a model from another seed and called with the pair's
    variables give exactly the pair's model's maps and encodings."""
    _, _, port = pairs[arch]
    other = init_from_generator_(build_model(arch, layers=50, with_aux=False),
                                 torch.Generator().manual_seed(11))
    got = run_port_builders(other, port.state_dict(), windows, int8_encode=True)
    want = run_port_builders(port, port.state_dict(), windows, int8_encode=True)
    for a, b in zip(got[0] + got[1] + (got[2],), want[0] + want[1] + (want[2],)):
        assert torch.equal(a, b)
    mine = run_port_builders(other, other.state_dict(), windows, int8_encode=True)
    assert not torch.equal(mine[1][0], want[1][0])


@pytest.mark.parametrize("no_cropping", [False, True], ids=["crop_route", "no_cropping"])
def test_run_flow_predict_passes_int8_encode_to_the_whole_frame_route_only(
        tmp_path_factory, monkeypatch, no_cropping):
    """The JAX Runner's predict passes ``int8_encode`` to the whole-frame
    builders (``make_flow_predict_fn`` and the cached pair) and only
    ``int8_decode`` to the crop route's ``make_flow_predict_crop_fn``;
    ``run_flow_predict`` does the same."""
    tree = generate_synthetic_dataset(str(tmp_path_factory.mktemp("int8_encode_tree")),
                                      num_frames=11, size=(64, 64), frame_delta=5)
    seen = {}

    class Built(Exception):
        pass

    def spy(name):
        def build(model, **kw):
            seen[name] = kw
            if name != "make_flow_predict_fn":
                raise Built
            return lambda *a: None
        return build

    for name in ("make_flow_predict_fn", "make_cached_flow_predict_fn",
                 "make_flow_predict_crop_fn"):
        monkeypatch.setattr(port_predict, name, spy(name))
    with pytest.raises(Built):
        run_flow_predict(torch.nn.Module(), {}, tree, "synth", frame_delta=5, resize=(64, 64),
                         crop=(33, 33), no_cropping=no_cropping, int8_decode=True,
                         int8_encode=True, workers=1, device="cpu")
    if no_cropping:
        assert set(seen) == {"make_flow_predict_fn", "make_cached_flow_predict_fn"}
        assert all(kw["int8_encode"] is True and kw["int8_decode"] is True
                   for kw in seen.values())
    else:
        assert set(seen) == {"make_flow_predict_crop_fn"}
        assert "int8_encode" not in seen["make_flow_predict_crop_fn"]
        assert seen["make_flow_predict_crop_fn"]["int8_decode"] is True
