"""Flow train and eval steps, and the flow-predict program builders
(counterpart of floodseg_tpu/train/flow.py).

Training (``flow_train_forward``, ``plain_train_forward``,
``make_flow_train_step``, ``make_flow_eval_step``): the JAX steps' math on
the model's own parameters, updated in place (train/supervised.py says how
a step is called). BN statistics update at each BN call, so they thread
through encode(prev), encode(next) and decode in that order, as the JAX
package threads them. The step's dropout generator splits into three
seeds, as JAX's ``r1, r2, r3``: encode(prev), encode(next), decode (both
decodes of the logit-warping mode use the third). The warps are K1 with
K1-bwd as their gradient (video/flow_model.py).

Test: ``make_flow_test_crop_fn`` runs the crops of a frame through
``flow_train_forward`` in eval mode as one batch (the flow sliding-window
test, train/evaluate.py::flow_sliding_window_test).

Predict:

``make_flow_predict_fn``, ``make_cached_flow_predict_fn``,
``make_flow_predict_crop_fn``, ``make_flow_test_crop_fn`` and
``make_flow_phase_fns`` keep the JAX package's signatures and return
values (and take ``device``). Where the JAX builders jit a
program that applies a flax module to a ``variables`` tree, these bind the
``variables`` mapping (the model's ``state_dict()`` keys) to the module for
the call with ``torch.func.functional_call``, the PyTorch counterpart of
``apply``, and run eagerly under ``torch.inference_mode``.

The predict functions take key frames as uint8 or float pixel values in
NHWC and normalise them on the device with ``MEAN``/``STD``, as bench.py
does around the JAX builders; the test crop function takes the test
transform's frames, normalised on the host, as the JAX one does. They run
on ``device`` (``None`` -> ``cuda``; core/device.py) and move the model
there, channels-last on the card.
Float policy: each call runs inside ``full_precision_f32`` (TF32 off for
convolutions and matrix products, bf16 products reduced in float32, the
caller's flags restored after), so a float32 model computes in float32 and
a bf16 one rounds each product once, as the JAX package's do.
"""

import time
from typing import Callable, Dict, Mapping, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
from torch.func import functional_call

from floodseg_tpu_torch.core.device import DeviceLike, full_precision_f32, resolve_device
from floodseg_tpu_torch.core.profiler import cuda_sync, span
from floodseg_tpu_torch.data.transforms import MEAN, STD
from floodseg_tpu_torch.models.deeplabv3 import ASPP
from floodseg_tpu_torch.models.layers import data_parallel
from floodseg_tpu_torch.models.pspnet import PPM
from floodseg_tpu_torch.models.resnet import ResNetFeatures
from floodseg_tpu_torch.ops.quant import (
    int8_deeplab_decode,
    int8_resnet_trunk,
    int8_seghead_decode,
    ppm_folded,
)
from floodseg_tpu_torch.ops.resize import resize_bilinear
from floodseg_tpu_torch.parallel.mesh import World, gather
from floodseg_tpu_torch.train.state import TrainState
from floodseg_tpu_torch.train.supervised import (
    backward_and_update,
    dropout_seed,
    split_seeds,
    step_metrics,
)
from floodseg_tpu_torch.ops.warp_kernels import grid_sample_cuda
from floodseg_tpu_torch.video.flow_model import FlowInterpolator


# ---------------------------------------------------------------- training

def _index(batch: Dict, key: str, device: torch.device) -> torch.Tensor:
    """A batch's per-sample chain lengths as a tensor on ``device`` (the
    loader keeps ids host-side). To the card through pinned memory without
    blocking: a pageable copy would wait for the card to finish the queued
    work, and the step would stop the host from running ahead."""
    index = torch.as_tensor(np.asarray(batch[key]))
    if device.type != "cuda":
        return index.to(device)
    return index.pin_memory().to(device, non_blocking=True)


def flow_train_forward(model: nn.Module, batch: Dict, rng: Optional[torch.Generator],
                       train: bool, feature_based: bool = True,
                       no_warp: bool = False) -> torch.Tensor:
    """Interpolated forward at the current frame: ``FlowInterpolator.
    train_forward`` over the model's encode and decode (both key frames
    encoded, each sample's maps warped through its own chain, blended by
    (n - index) / n and decoded, or decoded, then the logits warped),
    resized to the frame size with align_corners=True. Returns the logits;
    with ``train`` the model runs in training mode (batch statistics, BN
    running statistics updated, dropout from ``rng``: encode(prev) draws
    from the first seed, encode(next) from the second, every decode from
    the third)."""
    fp = batch["frame_prev"]
    li, ri = _index(batch, "left_index", fp.device), _index(batch, "right_index", fp.device)
    s1, s2, s3 = split_seeds(rng, 3)
    enc_seeds = iter((s1, s2))
    model.train(train)

    def encode(x):
        with dropout_seed(model, next(enc_seeds), x.device):
            return model.encode(x)[0]

    def decode(f):
        with dropout_seed(model, s3, f.device):
            return model.decode(f)

    interp = FlowInterpolator(encode=encode, decode=decode, feature_based=feature_based,
                              no_warp=no_warp)
    return interp.train_forward(fp, batch["frame_next"], batch["mvs_left"],
                                batch["mvs_right"], li, ri)


def plain_train_forward(model: nn.Module, images: torch.Tensor,
                        rng: Optional[torch.Generator], train: bool) -> torch.Tensor:
    """Single-frame encode -> decode (the no-interpolation branch), resized
    to the frame size; the generator splits into two seeds."""
    h, w = images.shape[1], images.shape[2]
    s1, s2 = split_seeds(rng, 2)
    model.train(train)
    with dropout_seed(model, s1, images.device):
        f = model.encode(images)[0]
    with dropout_seed(model, s2, images.device):
        logits = model.decode(f)
    if tuple(logits.shape[1:3]) != (h, w):
        logits = resize_bilinear(logits, (h, w), align_corners=True)
    return logits


def make_flow_train_step(model: nn.Module, loss_fn: Callable, num_classes: int,
                         ignore_index: int = 255, feature_based: bool = True,
                         no_warp: bool = False,
                         world: Optional[World] = None) -> Tuple[Callable, Callable]:
    """(interp_step, plain_step), each step(state, batch, rng) -> (state,
    metrics) with the loss and the counts of the argmax against the labels
    (computed before the update). The caller flips the
    no_interpolation_percentage coin on the host. With a ``world`` of more
    than one rank, each rank's forward (K1 and K1-bwd on its slice) runs
    under ``data_parallel`` and the loss is the gathered global batch's
    (train/supervised.py says how)."""
    def _step(state: TrainState, batch: Dict, rng: Optional[torch.Generator], plain: bool):
        labels = gather(batch["label"], world)
        with full_precision_f32():
            with data_parallel(model, world):
                if plain:
                    logits = plain_train_forward(model, batch["frame_current"], rng, True)
                else:
                    logits = flow_train_forward(model, batch, rng, True, feature_based,
                                                no_warp)
            logits = gather(logits, world)
            loss = loss_fn({"pred": logits}, labels)
            backward_and_update(state, loss, world)
        return state, {"loss": loss.detach(),
                       **step_metrics(logits, labels, num_classes, ignore_index)}

    return (lambda state, batch, rng: _step(state, batch, rng, False),
            lambda state, batch, rng: _step(state, batch, rng, True))


def make_flow_eval_step(model: nn.Module, num_classes: int, ignore_index: int = 255,
                        feature_based: bool = True, no_warp: bool = False) -> Callable:
    """eval_step(state, batch) -> metrics: the interpolated forward in eval
    mode, without gradients (whole-frame validation)."""
    def eval_step(state: TrainState, batch: Dict):
        with torch.no_grad(), full_precision_f32():
            logits = flow_train_forward(model, batch, None, False, feature_based, no_warp)
        return step_metrics(logits, batch["label"], num_classes, ignore_index)

    return eval_step


# ------------------------------------------------------------------ predict


def _predict_encode(model: nn.Module, int8_encode: bool) -> Callable:
    """Encode closure: the model's ``encode``, or the W8A8 ResNet trunk
    (ops/quant.py::int8_resnet_trunk: every bottleneck conv in int8, the
    stem, the residual adds and PSPNet's PPM in full precision), its
    weights folded and quantized from the variables bound for the call.
    Dispatches as the JAX package's ``_predict_encode``: PSPNet (``ppm``)
    runs the deep-base stem with every block of layer3/4 dilated, then
    ``ppm_folded`` with the model's bins; DeepLabV3 (``backbone``) the
    torchvision trunk, whose c4 is the encoding; other models raise."""
    if not int8_encode:
        return lambda x: model.encode(x)[0]
    if isinstance(getattr(model, "ppm", None), PPM) and isinstance(model, ResNetFeatures):
        trunk, bins = model, tuple(b[0].bin_size for b in model.ppm.features)

        def encode(x):
            c4 = int8_resnet_trunk(model.state_dict(keep_vars=True), x, depth=trunk.depth,
                                   deep_base=True, semseg_dilation=True, dtype=_dtype(trunk))
            return ppm_folded(model.ppm.state_dict(keep_vars=True), c4, bins=bins,
                              dtype=_dtype(trunk))

        return encode
    trunk = getattr(model, "backbone", None)
    if not isinstance(trunk, ResNetFeatures):
        raise ValueError("int8_encode supports the pspnet/deeplabv3 ResNet trunks; use the "
                         "bf16 encoder for other archs")
    return lambda x: int8_resnet_trunk(
        trunk.state_dict(keep_vars=True), x, depth=trunk.depth, deep_base=trunk.deep_base,
        semseg_dilation=trunk.semseg_dilation, dtype=_dtype(trunk))


def _dtype(trunk: nn.Module) -> torch.dtype:
    """A ResNet trunk's compute dtype (its first block's conv's)."""
    return trunk.layer1[0].conv1.compute_dtype


def _predict_decode(model: nn.Module, int8_decode: bool) -> Callable:
    """Decode closure: the model's ``decode``, or an int8-quantized decoder
    whose weights are folded and quantized from the variables bound for the
    call: the PSPNet SegHead ``cls`` (ops/quant.py::int8_seghead_decode) or
    the DeepLabV3 DeepLabHead ``classifier`` (int8_deeplab_decode). Other
    heads raise."""
    if not int8_decode:
        return model.decode
    head = getattr(model, "cls", None)
    if isinstance(head, nn.Sequential):
        int8_decode_fn = int8_seghead_decode
    else:
        head = getattr(model, "classifier", None)
        if not (isinstance(head, nn.Sequential) and isinstance(head[0], ASPP)):
            raise ValueError(
                "int8_decode supports the pspnet SegHead and the deeplabv3 "
                "DeepLabHead decoders; use bf16 decode for other archs")
        int8_decode_fn = int8_deeplab_decode

    dtype = getattr(head[-1], "compute_dtype", torch.bfloat16)

    def decode(f, act_absmax=None):
        return int8_decode_fn(head.state_dict(keep_vars=True), f, dtype=dtype,
                              act_absmax=act_absmax)

    return decode


def decode_split_ok(model: nn.Module) -> bool:
    """Whether predict_clip decodes the key map and the interpolated maps as
    two calls: only for the PSPNet SegHead (``cls``), as the JAX package's
    ``_decode_split_ok`` decides. The DeepLabHead and the ViT's
    MaskTransformer decode the window as one call; the DeepLabHead's int8
    form quantizes at per-call scales, so a split decode would compute
    something else."""
    return isinstance(getattr(model, "cls", None), nn.Module)


class _Bound(nn.Module):
    """Holds ``model`` as a submodule so that ``functional_call`` can bind a
    variables mapping to it for the duration of one ``fn`` call."""

    def __init__(self, model: nn.Module, fn: Callable):
        super().__init__()
        self.model = model
        self.fn = fn

    def forward(self, *args):
        return self.fn(*args)


def _prepare(model: nn.Module, device: torch.device) -> nn.Module:
    model.to(device).eval()
    if device.type == "cuda":
        model.to(memory_format=torch.channels_last)
    return model


class _Program(NamedTuple):
    """What every predict builder shares: the device, the interpolator over
    the model's encode/decode closures, the default grid on the device, and
    the on-device frame normalisation and grid conversion."""
    dev: torch.device
    interp: FlowInterpolator
    dg: Optional[torch.Tensor]
    norm: Callable
    grids: Callable


def _normalizer(dev: torch.device) -> Callable:
    """norm(x): pixel values to the device, float32, (x - MEAN) / STD."""
    mean = torch.tensor(MEAN, dtype=torch.float32, device=dev)
    std = torch.tensor(STD, dtype=torch.float32, device=dev)
    return lambda x: (torch.as_tensor(x, device=dev).to(torch.float32) - mean) / std


def _program(model, feature_based, no_warp, default_grid, int8_decode, int8_encode,
             device) -> _Program:
    dev = resolve_device(device)
    interp = FlowInterpolator(
        encode=_predict_encode(model, int8_encode),
        decode=_predict_decode(model, int8_decode),
        feature_based=feature_based, no_warp=no_warp,
        decode_wants_absmax=int8_decode, decode_split=decode_split_ok(model))
    _prepare(model, dev)
    dg = None if default_grid is None else torch.as_tensor(
        np.asarray(default_grid, np.float32), device=dev).contiguous()
    norm = _normalizer(dev)

    def grids(g):
        return torch.as_tensor(g, dtype=torch.float32, device=dev).contiguous()

    return _Program(dev, interp, dg, norm, grids)


def _bind(model: nn.Module, run: Callable) -> Callable:
    """call(variables, *args): ``run(*args)`` with ``variables`` bound to
    the model, under inference mode and ``full_precision_f32``."""
    bound = _Bound(model, run)

    def call(variables: Mapping[str, torch.Tensor], *args):
        with torch.inference_mode(), full_precision_f32():
            state = {f"model.{k}": v for k, v in variables.items()}
            return functional_call(bound, state, args)

    return call


def _builder(model, n, feature_based, no_warp, out_size, default_grid,
             int8_decode, int8_encode, device, cached_key, fused_argmax=True):
    prog = _program(model, feature_based, no_warp, default_grid, int8_decode,
                    int8_encode, device)

    def run(first, frame_next, mvs_left, mvs_right, return_next_enc):
        """first: a frame (full) or the cached previous encoding."""
        with span("predict_inputs"):
            frame_prev = None if cached_key else prog.norm(first)
            f_prev_enc = torch.as_tensor(first, device=prog.dev) if cached_key else None
            frame_next = prog.norm(frame_next)
            mvs_left, mvs_right = prog.grids(mvs_left), prog.grids(mvs_right)
        return prog.interp.predict_clip(
            frame_prev, frame_next, mvs_left, mvs_right, n, default_grid=prog.dg,
            out_size=out_size, f_prev_enc=f_prev_enc, return_next_enc=return_next_enc,
            argmax_epilogue=True, fused_argmax=fused_argmax)

    call = _bind(model, run)

    def window(variables: Mapping[str, torch.Tensor], *args):
        """The call inside the span ``predict_window``: its own time,
        outside the phases' spans that ``run`` opens, is the binding and
        the two modes."""
        with span("predict_window"):
            return call(variables, *args)

    return window


def make_flow_predict_fn(model: nn.Module, n: int, feature_based: bool = True,
                         no_warp: bool = False,
                         out_size: Tuple[int, int] = (1072, 1920),
                         default_grid: Optional[np.ndarray] = None,
                         int8_decode: bool = False,
                         int8_encode: bool = False,
                         device: DeviceLike = None) -> Callable:
    """One program for a whole key-frame window.

    Returns fn(variables, frame_prev, frame_next, mvs_left, mvs_right) ->
    (n, out_h, out_w) int32 class maps: interpolation, upsample to
    ``out_size`` (align_corners=True) and argmax, all on the device.
    """
    call = _builder(model, n, feature_based, no_warp, out_size, default_grid,
                    int8_decode, int8_encode, device, cached_key=False)
    return lambda variables, fp, fn, ml, mr: call(variables, fp, fn, ml, mr, False)


def make_cached_flow_predict_fn(model: nn.Module, n: int,
                                feature_based: bool = True,
                                no_warp: bool = False,
                                out_size: Tuple[int, int] = (1072, 1920),
                                default_grid: Optional[np.ndarray] = None,
                                int8_decode: bool = False,
                                int8_encode: bool = False,
                                fused_argmax: bool = True,
                                device: DeviceLike = None):
    """(full_fn, cached_fn) for sequential video with key-feature reuse:
    consecutive windows share a key frame, so the previous window's encoded
    next key replaces one of the two encoder passes (eval BN makes the
    outputs equal).

    full_fn(variables, fp, fn, ml, mr)           -> (maps, f_next_enc)
    cached_fn(variables, f_prev_enc, fn, ml, mr) -> (maps, f_next_enc)

    ``fused_argmax``: the epilogue is ``resize_argmax`` (True) or
    ``resize_bilinear`` to ``out_size`` and then the argmax (False, the
    JAX package's unfused variant that bench.py --epilogue-ab measures);
    the maps are the same up to exact ties.
    """
    args = (model, n, feature_based, no_warp, out_size, default_grid,
            int8_decode, int8_encode, device)
    full = _builder(*args, cached_key=False, fused_argmax=fused_argmax)
    cached = _builder(*args, cached_key=True, fused_argmax=fused_argmax)
    return (lambda variables, fp, fn, ml, mr: full(variables, fp, fn, ml, mr, True),
            lambda variables, enc, fn, ml, mr: cached(variables, enc, fn, ml, mr, True))


def make_flow_predict_crop_fn(model: nn.Module, n: int, num_classes: int,
                              feature_based: bool = True, no_warp: bool = False,
                              default_grid: Optional[np.ndarray] = None,
                              int8_decode: bool = False,
                              device: DeviceLike = None) -> Callable:
    """Crop predict for the default (no_cropping=False) predict path: the
    full n-frame interpolation runs on every sliding-window crop.

    Returns fn(variables, fp_crops (N, ch, cw, 3), fn_crops, ml/mr
    (T, N, bh, bw, 2)) -> (N, n, ch, cw, num_classes) float32
    probabilities on the device: each crop's logits up-sampled to the crop
    (align_corners=True), then softmax in float32. Crops run one at a time
    with batch 1 (the JAX package vmaps them), into one output buffer. The
    key map is resampled through the FULL-frame ``default_grid``, as the
    reference does on crops. Crops are raw pixels, normalised on the device.
    """
    prog = _program(model, feature_based, no_warp, default_grid, int8_decode, False,
                    device)

    def run(fp_crops, fn_crops, mvs_left, mvs_right):
        fp = torch.as_tensor(fp_crops, device=prog.dev)
        fn = torch.as_tensor(fn_crops, device=prog.dev)
        ml, mr = prog.grids(mvs_left), prog.grids(mvs_right)
        crops, ch, cw = fp.shape[:3]
        out = torch.empty((crops, n, ch, cw, num_classes), dtype=torch.float32,
                          device=prog.dev)
        for i in range(crops):
            logits = prog.interp.predict_clip(
                prog.norm(fp[i:i + 1]), prog.norm(fn[i:i + 1]),
                ml[:, i:i + 1].contiguous(), mr[:, i:i + 1].contiguous(), n,
                default_grid=prog.dg, out_size=(ch, cw))
            out[i] = torch.softmax(logits.to(torch.float32), dim=-1)[..., :num_classes]
        return out

    return _bind(model, run)


def make_flow_test_crop_fn(model: nn.Module, num_classes: int, feature_based: bool = True,
                           no_warp: bool = False, device: DeviceLike = None) -> Callable:
    """Batched crop forward for the flow sliding-window test: all crops of a
    frame run as one batch through ``flow_train_forward`` in eval mode
    (each crop's chains masked to its own length, every warp K1), then the
    float32 softmax, sliced to ``num_classes``.

    Returns fn(variables, frame_prev (N, ch, cw, 3), frame_next, mvs_left,
    mvs_right (T, N, bh, bw, 2), left_index (N,), right_index (N,)) ->
    (N, ch, cw, num_classes) float32 probabilities on the device. The
    frames are normalised (the flow test transform normalises on the host).
    """
    prog = _program(model, feature_based, no_warp, None, False, False, device)

    def run(frame_prev, frame_next, mvs_left, mvs_right, left_index, right_index):
        batch = {"frame_prev": torch.as_tensor(frame_prev, dtype=torch.float32,
                                               device=prog.dev),
                 "frame_next": torch.as_tensor(frame_next, dtype=torch.float32,
                                               device=prog.dev),
                 "mvs_left": prog.grids(mvs_left), "mvs_right": prog.grids(mvs_right),
                 "left_index": np.asarray(left_index), "right_index": np.asarray(right_index)}
        logits = flow_train_forward(model, batch, None, False, feature_based, no_warp)
        return torch.softmax(logits.to(torch.float32), dim=-1)[..., :num_classes]

    return _bind(model, run)


def make_flow_phase_fns(model: nn.Module, n: int, feature_based: bool = True,
                        out_size: Tuple[int, int] = (1072, 1920),
                        default_grid: Optional[np.ndarray] = None,
                        device: DeviceLike = None) -> Dict[str, Callable]:
    """The predict path cut into the four phases of the reference's
    profiler regions, one function each (the production builders run them
    as one call):

    - ``encode(variables, frames)``: key frames (raw pixels, normalised on
      the device) -> their encoding;
    - ``warp_chain(f, grids)``: (1, H, W, C) and (n-1, 1, gh, gw, 2) ->
      (n-1, H, W, C): K1 onto the first grid, one K2 launch for the rest
      (the chain of ``predict_clip``), each step resized back to the
      feature size (align_corners=True);
    - ``fuse(f, f_next, fwd, bwd)``: the key map through the identity
      ``default_grid`` (K1, align_corners=True; feature_based only) and the
      (n - p) / n, p / n blend of fwd and the reversed bwd -> (n, H, W, C);
    - ``decode(variables, maps)``: one decode of the stack, resized to
      ``out_size`` (align_corners=True), argmax -> (n, out_h, out_w) int32.

    Each runs under inference mode and ``full_precision_f32``.
    """
    prog = _program(model, feature_based, False, default_grid, False, False, device)

    def scoped(fn):
        def call(*args):
            with torch.inference_mode(), full_precision_f32():
                return fn(*args)
        return call

    def warp_chain(f, grids):
        chain = FlowInterpolator._predict_chain(f.contiguous(), prog.grids(grids))
        if chain.shape[1:3] != f.shape[1:3]:
            chain = resize_bilinear(chain, tuple(f.shape[1:3]), align_corners=True)
        return chain

    def fuse(f, f_next, fwd, bwd):
        fk = f
        if feature_based and prog.dg is not None:
            fk = grid_sample_cuda(f.contiguous(), prog.dg[None], align_corners=True)
            if fk.shape[1:3] != f.shape[1:3]:
                fk = resize_bilinear(fk, tuple(f.shape[1:3]), align_corners=True)
        p = torch.arange(1, n, dtype=torch.float32, device=f.device)[:, None, None, None]
        wf = ((n - p) / n).to(f.dtype)
        wb = (p / n).to(f.dtype)
        inter = wf * fwd + wb * torch.flip(bwd, dims=(0,))
        return torch.cat([fk[:1], inter], dim=0)

    def decode(maps):
        out = model.decode(maps)
        if tuple(out.shape[1:3]) != tuple(out_size):
            out = resize_bilinear(out, out_size, align_corners=True)
        return torch.argmax(out, dim=-1).to(torch.int32)

    return {"encode": _bind(model, lambda frames: model.encode(prog.norm(frames))[0]),
            "warp_chain": scoped(warp_chain), "fuse": scoped(fuse),
            "decode": _bind(model, decode)}


def profile_predict_phases(model: nn.Module, variables: Mapping[str, torch.Tensor],
                           batch: Dict, n: int, feature_based: bool = True,
                           out_size: Tuple[int, int] = (1072, 1920),
                           default_grid: Optional[np.ndarray] = None, repeats: int = 5,
                           device: DeviceLike = None) -> Dict[str, float]:
    """Run one clip phase by phase (``make_flow_phase_fns``) and return the
    mean seconds of each, named as the reference's profiler regions:
    predict_encoder, predict_warp, predict_fusion, predict_decoder. Every
    phase and the card are warmed up first; a region runs its phase
    ``repeats`` times and ends with ``cuda_sync``. ``batch``: one window's
    frame_prev, frame_next (raw pixels) and mvs_left, mvs_right."""
    fns = make_flow_phase_fns(model, n, feature_based, out_size, default_grid, device)
    dev = resolve_device(device)
    fp, fnx = batch["frame_prev"], batch["frame_next"]
    ml, mr = (torch.as_tensor(batch[k], dtype=torch.float32, device=dev).contiguous()
              for k in ("mvs_left", "mvs_right"))

    f = fns["encode"](variables, fp)
    f2 = fns["encode"](variables, fnx)
    fwd, bwd = fns["warp_chain"](f, ml), fns["warp_chain"](f2, mr)
    fns["decode"](variables, fns["fuse"](f, f2, fwd, bwd))
    cuda_sync()

    times = {}

    def timed(name, fn):
        t0 = time.perf_counter()
        for _ in range(repeats):
            out = fn()
        cuda_sync()
        times[name] = (time.perf_counter() - t0) / repeats
        return out

    f = timed("predict_encoder", lambda: fns["encode"](variables, fp))
    f2 = fns["encode"](variables, fnx)
    fwd = timed("predict_warp", lambda: fns["warp_chain"](f, ml))
    bwd = fns["warp_chain"](f2, mr)
    maps = timed("predict_fusion", lambda: fns["fuse"](f, f2, fwd, bwd))
    timed("predict_decoder", lambda: fns["decode"](variables, maps))
    return times
