"""Keyframe-warp interpolation (counterpart of
floodseg_tpu/video/flow_model.py).

Encode the two key frames only, warp the feature (or logit) maps along the
per-frame block-MV grids, blend the forward and backward warps linearly,
and decode. The warps go through the hand-written kernels: the first warp
of each chain changes shape (feature resolution -> grid resolution) and is
K1 (``grid_sample_cuda``); the n-2 further warps run at grid resolution in
one K2 launch (``warp_chain_cuda``). The key map is resampled once through
the identity ``default_grid`` with K1 (align_corners=True). On CPU tensors
the wrappers compute their plain versions.

With an int8 decoder (``decode_wants_absmax``), the interpolator passes
the decoder a bound on the decoded stack's |max|: the larger absmax of the
two raw key encodings, taken before any warp, since every decoded map is a
convex combination of them. The interpolated stack goes from grid
resolution to feature resolution and to int8 at that bound's scale in one
K3 launch (``resize_quantize_int8_cuda``), and the key map is quantized at
the same scale, so the decoder receives int8 maps.

Training (``warp_chain_masked``, ``interp_weight``,
``FlowInterpolator.train_forward``) warps each sample through its own
number of grids: every warp is K1 through ``grid_sample_autograd``, whose
gradient is K1-bwd, and a ``j < index`` select keeps a sample's carry past
its chain's length. K2 neither masks nor has a gradient, so training does
not use it.

The contract is the JAX package's outputs, not its TPU schedule.
"""

from dataclasses import dataclass
from functools import partial
from typing import Callable, Optional

import torch

from floodseg_tpu_torch.core.profiler import span
from floodseg_tpu_torch.ops.quant import quantize_with_scale, scale_from_absmax
from floodseg_tpu_torch.ops.resize import resize_argmax, resize_bilinear
from floodseg_tpu_torch.ops.resize_kernels import resize_quantize_int8_cuda
from floodseg_tpu_torch.ops.warp_kernels import (
    grid_sample_autograd,
    grid_sample_cuda,
    warp_chain_cuda,
)


def warp(x: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """One block-MV warp (bilinear, border, align_corners=False)."""
    return grid_sample_cuda(x, grid, align_corners=False)


def warp_chain_masked(f: torch.Tensor, grids: torch.Tensor,
                      index: torch.Tensor) -> torch.Tensor:
    """Warp each sample through its first ``index`` grids (the training path).

    f: (B, H, W, C) maps; grids: (T, B, gh, gw, 2) padded chains, float32
    and contiguous; index: (B,) integers >= 1 on f's device. The first warp
    runs always and changes the shape to the grid's; each later step j
    warps the carry and keeps the result where ``j < index``. The chain is
    resized back to (H, W) with align_corners=True.
    """
    b, h, w, _ = f.shape
    y = grid_sample_autograd(f, grids[0])
    keep_shape = (b, 1, 1, 1)
    for j in range(1, grids.shape[0]):
        nxt = grid_sample_autograd(y, grids[j])
        y = torch.where((j < index).view(keep_shape), nxt, y)
    if _hw(y) != (h, w):
        y = resize_bilinear(y, (h, w), align_corners=True)
    return y


def interp_weight(index: torch.Tensor, n: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """(n - index) / n as (B, 1, 1, 1) in ``dtype``, computed at
    ``promote_types(dtype, float32)``."""
    wdt = torch.promote_types(dtype, torch.float32)
    s = (n.to(wdt) - index.to(wdt)) / n.to(wdt)
    return s.view(-1, 1, 1, 1).to(dtype)


def _hw(x: torch.Tensor):
    return tuple(x.shape[1:3])


def _absmax(x: torch.Tensor) -> torch.Tensor:
    return torch.amax(x.abs()).float()


@dataclass(frozen=True)
class FlowInterpolator:
    """Wraps an encoder/decoder pair with keyframe-warp interpolation.

    encode: NHWC images -> NHWC feature map; decode: NHWC features -> NHWC
    logits. feature_based: warp features then decode (True), or decode the
    key frames then warp their logits (False). no_warp: pure linear blend of
    the key maps. decode_wants_absmax: ``decode`` is an int8 decoder taking
    ``act_absmax=`` (ops/quant.py::int8_seghead_decode); feature_based only.
    """

    encode: Callable[[torch.Tensor], torch.Tensor]
    decode: Callable[..., torch.Tensor]
    feature_based: bool = True
    no_warp: bool = False
    decode_wants_absmax: bool = False
    decode_split: bool = False

    def train_forward(self, frame_prev: torch.Tensor, frame_next: torch.Tensor,
                      mvs_left: torch.Tensor, mvs_right: torch.Tensor,
                      left_index: torch.Tensor, right_index: torch.Tensor,
                      out_size: Optional[tuple] = None) -> torch.Tensor:
        """Interpolated prediction at the current frame, differentiable.

        frame_*: (B, H, W, 3); mvs_*: (T, B, gh, gw, 2) padded chains;
        *_index: (B,) chain lengths. Returns logits at ``out_size``
        (default: the frame size), resized with align_corners=True.
        ``encode`` runs on frame_prev, then on frame_next, before any
        ``decode`` (a training model's BN statistics thread in that order).
        """
        h, w = _hw(frame_prev)
        out_size = tuple(out_size or (h, w))
        n = left_index + right_index

        def blend(mp, mn):
            return (mp * interp_weight(left_index, n, mp.dtype)
                    + mn * interp_weight(right_index, n, mn.dtype))

        f_prev, f_next = self.encode(frame_prev), self.encode(frame_next)
        if self.feature_based:
            if not self.no_warp:
                f_prev = warp_chain_masked(f_prev, mvs_left, left_index)
                f_next = warp_chain_masked(f_next, mvs_right, right_index)
            out = self.decode(blend(f_prev, f_next))
        else:
            o_prev, o_next = self.decode(f_prev), self.decode(f_next)
            if not self.no_warp:
                o_prev = warp_chain_masked(o_prev, mvs_left, left_index)
                o_next = warp_chain_masked(o_next, mvs_right, right_index)
            out = blend(o_prev, o_next)
        if _hw(out) != out_size:
            out = resize_bilinear(out, out_size, align_corners=True)
        return out

    @staticmethod
    def _predict_chain(f: torch.Tensor, grids: torch.Tensor) -> torch.Tensor:
        """f (1, H, W, C), grids (T, 1, gh, gw, 2) -> (T, gh, gw, C): step k
        is f warped through grids[0..k]."""
        return warp_chain_cuda(warp(f, grids[0]), grids[1:])

    def predict_clip(
        self,
        frame_prev: Optional[torch.Tensor],
        frame_next: Optional[torch.Tensor],
        mvs_left: Optional[torch.Tensor],
        mvs_right: Optional[torch.Tensor],
        n: int,
        default_grid: Optional[torch.Tensor] = None,
        out_size: Optional[tuple] = None,
        f_prev_enc: Optional[torch.Tensor] = None,
        return_next_enc: bool = False,
        argmax_epilogue: bool = False,
        fused_argmax: bool = True,
    ):
        """Segment all ``n`` frames of a keyframe window.

        frame_prev/frame_next: (1, H, W, 3) key frames (frame_next None for
        the tail window). mvs_left: (n-1, 1, gh, gw, 2) forward grids;
        mvs_right: the matching inv_grids, reversed. Returns (n, H', W',
        classes) logits for frames [prev, ..., prev+n-1], or int32 class
        maps (n, H', W') with ``argmax_epilogue``: ``resize_argmax``
        (``fused_argmax``), or ``resize_bilinear`` to ``out_size`` and then
        the argmax (the same maps up to exact ties).

        ``f_prev_enc`` replaces the encoding of frame_prev (the previous
        window's next key); ``return_next_enc`` also returns the raw encoding
        of frame_next, before the identity-grid resample.

        The phases run in the spans ``predict_encoder``, ``predict_warp``,
        ``predict_fusion`` (the int8 bound, the key map, the blend, the
        resize back or K3, the quantizing), ``predict_decoder`` and
        ``predict_epilogue``, once a call each (core/profiler.py::span).
        """
        ref_frame = frame_prev if frame_prev is not None else frame_next
        h, w = _hw(ref_frame)
        out_size = tuple(out_size or (h, w))
        single = frame_next is None

        enc, dec = self.encode, self.decode
        if not self.feature_based:
            # segmentation mode decodes the key frames first and warps the
            # full-resolution logits; the batched decode is then the identity
            def enc(x):
                o = self.decode(self.encode(x))
                if _hw(o) != (h, w):
                    o = resize_bilinear(o, (h, w), align_corners=True)
                return o

            def dec(x):
                return x

        with span("predict_encoder"):
            if single:
                f = f_prev_enc if f_prev_enc is not None else enc(frame_prev)
                f_next = None
            elif f_prev_enc is not None:
                f = f_prev_enc
                f_next = enc(frame_next)
            else:
                # both key frames in one batched encoder call (eval BN is
                # batch-invariant)
                f_both = enc(torch.cat([frame_prev, frame_next], dim=0))
                f, f_next = f_both[:1], f_both[1:]
        f_next_raw = f_next
        fh, fw = _hw(f)

        with span("predict_warp"):
            if not single and not self.no_warp:
                fwd = self._predict_chain(f.contiguous(), mvs_left)
                bwd = self._predict_chain(f_next.contiguous(), mvs_right)

        with span("predict_fusion"):
            # int8 decoder: max|stack| <= max(max|f|, max|f_next|), a bound
            # that the raw key encodings give before any map is fused
            absmax_hint = scale = None
            if self.decode_wants_absmax and self.feature_based:
                absmax_hint = _absmax(f)
                if f_next is not None:
                    absmax_hint = torch.maximum(absmax_hint, _absmax(f_next))
                scale = scale_from_absmax(absmax_hint)

            # key-frame map through the identity grid (feature_based only)
            if self.feature_based and not self.no_warp and default_grid is not None:
                fk = grid_sample_cuda(f.contiguous(), default_grid[None],
                                      align_corners=True)
                if _hw(fk) != (fh, fw):
                    fk = resize_bilinear(fk, (fh, fw), align_corners=True)
                f = fk

            inter = None
            if not single:
                p = torch.arange(1, n, dtype=torch.float32,
                                 device=f.device)[:, None, None, None]
                wf = ((n - p) / n).to(f.dtype)
                wb = (p / n).to(f.dtype)
                if self.no_warp:
                    inter = wf * f + wb * f_next
                else:
                    # step k pairs fwd[k] with bwd[n-2-k]; the blend and the
                    # bilinear resize are both linear, so only the fused maps
                    # are resized back to feature resolution
                    inter = wf * fwd + wb * torch.flip(bwd, dims=(0,))
                    if _hw(inter) != (fh, fw):
                        if scale is not None:
                            inter = resize_quantize_int8_cuda(inter, scale, (fh, fw),
                                                              align_corners=True)
                        else:
                            inter = resize_bilinear(inter, (fh, fw), align_corners=True)

            if scale is not None:
                # every piece at the hint's scale: equal to quantizing the stack
                f = quantize_with_scale(f, scale)
                if inter is not None and inter.dtype != torch.int8:
                    inter = quantize_with_scale(inter, scale)
                dec = partial(dec, act_absmax=absmax_hint)

        with span("predict_decoder"):
            if single:
                out = dec(f)
            elif self.decode_split:
                out = torch.cat([dec(f), dec(inter)], dim=0)
            else:
                out = dec(torch.cat([f, inter], dim=0))
        with span("predict_epilogue"):
            if argmax_epilogue and not fused_argmax:
                if _hw(out) != out_size:
                    out = resize_bilinear(out, out_size, align_corners=True)
                out = torch.argmax(out, dim=-1).to(torch.int32)
            elif argmax_epilogue:
                out = resize_argmax(out, out_size, align_corners=True)
            elif _hw(out) != out_size:
                out = resize_bilinear(out, out_size, align_corners=True)
        if return_next_enc:
            return out, f_next_raw
        return out
