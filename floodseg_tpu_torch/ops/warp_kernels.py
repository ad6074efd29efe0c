"""The warp kernels K1, K1-bwd and K2: wrappers, plain versions, launch
counts, and the differentiable warp of the training path.

Counterpart of floodseg_tpu/ops/pallas_warp.py. The kernels are CUDA C++
for sm_90a in ``csrc/warp.cu`` (their notes there give the Pallas kernel
each replaces, its bound on the card and what the design does about it):

- K1 ``grid_sample_cuda(x, grid, align_corners)`` replaces
  ``grid_sample_pallas``; its plain version is ``ops.grid_sample.grid_sample``.
- K1-bwd ``grid_sample_backward_cuda(grad_out, grid, x_shape,
  align_corners)`` is K1's gradient with respect to x, which the JAX
  package leaves to XLA's autodiff of ``ops/grid_sample.py::grid_sample``;
  its plain version is ``ops.grid_sample.grid_sample_backward``. It is a
  deterministic gather by source pixel: an index build (each point's four
  entries e = k * P + p ordered by (source pixel, e) into CSR offsets, one
  block an image, its working arrays in shared memory or, for grids too
  large for that, in a device workspace) and one pass that sums each
  pixel's entries in that order and writes grad_x once. That is the order
  in which the plain version's ``index_add_`` adds on the CPU, so the
  kernel is bit-equal to the plain version computed there, and the same
  from run to run. The wrapper allocates the index (CSR offsets and (p, w)
  entries) and any workspace, whose size the library gives, with
  ``torch.empty``; nothing is cleared and no float32 scratch is taken for
  bf16. Its bound is bytes: grad_out read and grad_x written once, 123 MB
  (36.7 us on an H100 SXM) at the training head shape (2, 27, 27, 4096)
  -> (2, 55, 55, 4096) in float32 and 47.8 MB (14.3 us) at (2, 27, 27,
  4096) -> (2, 27, 27, 4096). The first design scattered with float4
  atomics into a float32 accumulator cleared by a memset (and rounded
  into bf16 by one more pass): about 2.6 times those bytes at the head
  shape, since the accumulator is twice the L2 and every atomic a read
  and a write of it, and an order of sums that changed from run to run.
  ``grid_sample_autograd`` is the ``torch.autograd.Function`` that runs K1
  forward and K1-bwd backward; grids get no gradient.
- K2 ``warp_chain_cuda(y0, grids)`` replaces ``warp_chain_pallas``; its
  plain version is ``warp_chain_plain`` below.

Each wrapper checks device, dtype (float32 or bfloat16; grids float32),
shape and contiguity and raises on anything its kernel does not take. For
tensors on the CPU it then computes the plain version; for CUDA tensors it
launches the kernel on the current stream, or raises. Outputs are
allocated with ``torch.empty`` and nothing synchronises. Each wrapper
counts its launches in ``<wrapper>.launches``, a plain integer that
``reset_launch_counts`` sets back to 0.
"""

import ctypes
from typing import NamedTuple

import torch

from floodseg_tpu_torch.ops import build
from floodseg_tpu_torch.ops.grid_sample import (
    blend_taps,
    grid_sample,
    grid_sample_backward,
    tap_indices_weights,
)

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_VEC_BYTES = 16            # one 16-byte load per thread and tap
_CHAIN_THREADS = 1024      # csrc/warp.cu kChainThreads
_CHAIN_TABLE_POINTS = (1, 2, 4, 8)  # tap-table points a thread, compiled
_TAP_INDEX_BYTES = 8       # four uint16 source points a table entry
_SMEM_OPTIN = 232448       # dynamic shared memory an sm_90 block may opt into
_CHAIN_PREF_BYTES = 64     # preferred channel bytes per point in a K2 tile


def _library():
    lib = build.load("warp")
    if not getattr(lib, "_floodseg_bound", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.floodseg_grid_sample.argtypes = [p, p, p, i, i, i, i, i, i, i, i, i, p]
        lib.floodseg_grid_sample.restype = i
        lib.floodseg_warp_chain.argtypes = [p, p, p, i, i, i, i, i, i, i, i, i, p]
        lib.floodseg_warp_chain.restype = i
        lib.floodseg_grid_sample_backward.argtypes = [p, p, p, p, p, p, i, i, i, i, i,
                                                      i, i, i, i, p]
        lib.floodseg_grid_sample_backward.restype = i
        lib.floodseg_grid_sample_backward_workspace.argtypes = [i, i, i, i, i]
        lib.floodseg_grid_sample_backward_workspace.restype = ctypes.c_longlong
        lib._floodseg_bound = True
    return lib


def _check_pair(x: torch.Tensor, grid: torch.Tensor, what: str) -> bool:
    """Validate a (data, grids) pair; True when both lie on the CPU."""
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"{what}: data must be float32 or bfloat16, got {x.dtype}")
    if grid.dtype != torch.float32:
        raise TypeError(f"{what}: grids must be float32, got {grid.dtype}")
    if not (x.is_contiguous() and grid.is_contiguous()):
        raise ValueError(f"{what}: inputs must be contiguous")
    if x.device.type == "cpu" and grid.device.type == "cpu":
        return True
    if x.device != grid.device or x.device.type != "cuda":
        raise ValueError(f"{what}: data on {x.device} and grids on "
                         f"{grid.device}; both must be on one CUDA device "
                         "or both on the CPU")
    return False


def _vectorized(c: int, *tensors: torch.Tensor) -> bool:
    itemsize = tensors[0].element_size()
    return (c * itemsize) % _VEC_BYTES == 0 and all(
        t.data_ptr() % _VEC_BYTES == 0 for t in tensors)


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {err}")


def grid_sample_cuda(x: torch.Tensor, grid: torch.Tensor,
                     align_corners: bool = False) -> torch.Tensor:
    """K1: bilinear border-padded warp. x (B, H, W, C), grid (B, gh, gw, 2)
    float32 -> (B, gh, gw, C) in x.dtype."""
    if x.dim() != 4 or grid.dim() != 4 or grid.shape[-1] != 2:
        raise ValueError(f"grid_sample_cuda: x must be (B, H, W, C) and grid "
                         f"(B, gh, gw, 2); got {tuple(x.shape)} and {tuple(grid.shape)}")
    b, h, w, c = x.shape
    gb, gh, gw, _ = grid.shape
    if gb != b:
        raise ValueError(f"grid_sample_cuda: batch mismatch {b} vs {gb}")
    if _check_pair(x, grid, "grid_sample_cuda"):
        return grid_sample(x, grid, align_corners)
    out = torch.empty((b, gh, gw, c), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    vec = _vectorized(c, x, out)
    with torch.cuda.device(x.device):
        err = _library().floodseg_grid_sample(
            x.data_ptr(), grid.data_ptr(), out.data_ptr(), b, h, w, c, gh, gw,
            int(bool(align_corners)), _DTYPE_CODES[x.dtype], int(vec),
            torch.cuda.current_stream(x.device).cuda_stream)
    _raise_on(err, "grid_sample_cuda")
    grid_sample_cuda.launches += 1
    return out


grid_sample_cuda.launches = 0


def grid_sample_backward_cuda(grad_out: torch.Tensor, grid: torch.Tensor, x_shape,
                              align_corners: bool = False) -> torch.Tensor:
    """K1-bwd: the gradient of K1 with respect to x. grad_out (B, gh, gw, C),
    grid (B, gh, gw, 2) float32 -> grad_x of shape ``x_shape`` = (B, H, W, C)
    in grad_out.dtype, summed in float32 in the plain version's order, so
    bit-equal to it. Two launches (the index build, then the gather) count
    as one."""
    x_shape = tuple(int(s) for s in x_shape)
    if grad_out.dim() != 4 or grid.dim() != 4 or grid.shape[-1] != 2 or len(x_shape) != 4:
        raise ValueError(f"grid_sample_backward_cuda: grad_out must be (B, gh, gw, C), "
                         f"grid (B, gh, gw, 2) and x_shape (B, H, W, C); got "
                         f"{tuple(grad_out.shape)}, {tuple(grid.shape)} and {x_shape}")
    b, h, w, c = x_shape
    if tuple(grad_out.shape) != (b,) + tuple(grid.shape[1:3]) + (c,) or grid.shape[0] != b:
        raise ValueError(f"grid_sample_backward_cuda: grad_out {tuple(grad_out.shape)} "
                         f"and grid {tuple(grid.shape)} do not match x {x_shape}")
    if _check_pair(grad_out, grid, "grid_sample_backward_cuda"):
        return grid_sample_backward(grad_out, grid, x_shape, align_corners)
    out = torch.empty(x_shape, dtype=grad_out.dtype, device=grad_out.device)
    if out.numel() == 0:
        return out
    vec = _vectorized(c, grad_out, out)
    gh, gw = grid.shape[1], grid.shape[2]
    dev = grad_out.device
    with torch.cuda.device(dev):
        lib = _library()
        offsets = torch.empty((b, h * w + 1), dtype=torch.int32, device=dev)
        entries = torch.empty((b, 4 * gh * gw, 2), dtype=torch.int32, device=dev)
        size = lib.floodseg_grid_sample_backward_workspace(b, h, w, gh, gw)
        work = torch.empty(size, dtype=torch.uint8, device=dev) if size else None
        err = lib.floodseg_grid_sample_backward(
            grad_out.data_ptr(), grid.data_ptr(), out.data_ptr(), offsets.data_ptr(),
            entries.data_ptr(), None if work is None else work.data_ptr(), b, h, w, c, gh,
            gw, int(bool(align_corners)), _DTYPE_CODES[grad_out.dtype], int(vec),
            torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, "grid_sample_backward_cuda")
    grid_sample_backward_cuda.launches += 1
    return out


grid_sample_backward_cuda.launches = 0


class _GridSample(torch.autograd.Function):
    """K1 forward, K1-bwd backward; no gradient to the grid. CPU tensors
    take the plain versions in any float dtype (float64 for the oracle
    tests)."""

    @staticmethod
    def forward(ctx, x, grid, align_corners):
        ctx.save_for_backward(grid)
        ctx.x_shape = tuple(x.shape)
        ctx.align_corners = align_corners
        if x.device.type == "cpu" and grid.device.type == "cpu":
            return grid_sample(x, grid, align_corners)
        return grid_sample_cuda(x, grid, align_corners)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad_out):
        (grid,) = ctx.saved_tensors
        if grad_out.device.type == "cpu" and grid.device.type == "cpu":
            grad_x = grid_sample_backward(grad_out, grid, ctx.x_shape, ctx.align_corners)
        else:
            grad_x = grid_sample_backward_cuda(grad_out.contiguous(), grid, ctx.x_shape,
                                               ctx.align_corners)
        return grad_x, None, None


def grid_sample_autograd(x: torch.Tensor, grid: torch.Tensor,
                         align_corners: bool = False) -> torch.Tensor:
    """The training path's warp: ``grid_sample_cuda`` with
    ``grid_sample_backward_cuda`` as its gradient with respect to x (their
    plain versions for CPU tensors). Grids are batch data: a grid that
    requires a gradient raises."""
    if grid.requires_grad:
        raise ValueError("grid_sample_autograd: the grid gets no gradient; pass a "
                         "grid that does not require one")
    return _GridSample.apply(x, grid, align_corners)


def _merged_weights(idx: torch.Tensor, wgt: torch.Tensor, dtype) -> torch.Tensor:
    """The TPU chain kernel's one-hot row: weights of coinciding taps summed
    into the first of them in float32 (in tap order), then rounded to the
    state dtype. idx, wgt: (P, 4)."""
    out = []
    for k in range(4):
        s = torch.zeros_like(wgt[:, 0])
        first = torch.ones_like(idx[:, 0], dtype=torch.bool)
        for j in range(4):
            same = idx[:, j] == idx[:, k]
            s = s + torch.where(same, wgt[:, j], 0.0)
            if j < k:
                first &= ~same
        out.append(torch.where(first, s, 0.0))
    return torch.stack(out, dim=-1).to(dtype).to(wgt.dtype)


def warp_chain_plain(y0: torch.Tensor, grids: torch.Tensor) -> torch.Tensor:
    """Plain version of K2: apply ``grids`` (T, 1, gh, gw, 2) one after the
    other to ``y0`` (1, gh, gw, C) at grid resolution (align_corners=False)
    and return every intermediate, (T + 1, gh, gw, C) = [y0, w(y0, g0), ...].
    The carry is rounded to y0.dtype after every step."""
    _, gh, gw, c = y0.shape
    t = grids.shape[0]
    p = gh * gw
    cdt = torch.promote_types(y0.dtype, torch.float32)
    state = y0.reshape(p, c)
    steps = [state]
    for i in range(t):
        idx, wgt = tap_indices_weights(gh, gw, grids[i, 0].reshape(p, 2), False)
        wq = _merged_weights(idx, wgt, y0.dtype).to(cdt)
        state = blend_taps(state[idx].to(cdt), wq).to(y0.dtype)
        steps.append(state)
    return torch.stack(steps).reshape(t + 1, gh, gw, c)


class ChainGeometry(NamedTuple):
    """How K2 runs on a grid. ``table_points``: the tap-table points a
    thread builds each step in the ping-pong design (two carries, two tap
    tables), or 0 for the single-buffer design (one carry, no table).
    ``smem``: the block's dynamic shared memory in bytes."""
    c_tile: int
    threads: int
    table_points: int
    smem: int


def _chain_geometry(points: int, c: int, itemsize: int, vec_elems: int) -> ChainGeometry:
    """K2's geometry. The channel tile is a multiple of the vector width
    dividing C, at most 64 bytes a point, and as wide as fits. The
    ping-pong design is taken wherever two carries and two tap tables
    (four uint16 indices and four weights a point) fit one block's shared
    memory at some tile; else the single-buffer design, whose carry must
    fit alone. A block has ``_CHAIN_THREADS`` threads, or the largest
    multiple of a point's vectors below that: a thread keeps one vector of
    a point."""
    tiles = [ct for ct in range(max(vec_elems, _CHAIN_PREF_BYTES // itemsize), 0, -1)
             if c % ct == 0 and ct % vec_elems == 0]
    def threads(ct):
        return _CHAIN_THREADS // (ct // vec_elems) * (ct // vec_elems)

    for ct in tiles:
        smem = 2 * points * (ct * itemsize + _TAP_INDEX_BYTES + 4 * itemsize)
        per_thread = -(-points // threads(ct))
        # uint16 tap indices: the design never fits 65536 points anyway
        if (smem <= _SMEM_OPTIN and points < 1 << 16
                and per_thread <= _CHAIN_TABLE_POINTS[-1]):
            return ChainGeometry(ct, threads(ct), next(
                k for k in _CHAIN_TABLE_POINTS if k >= per_thread), smem)
    for ct in tiles:
        if points * ct * itemsize <= _SMEM_OPTIN:
            return ChainGeometry(ct, threads(ct), 0, points * ct * itemsize)
    raise ValueError(
        f"warp_chain_cuda: a grid of {points} points with C={c} does not fit "
        f"one block ({points * tiles[-1] * itemsize} bytes of carry at the "
        f"narrowest tile, at most {_SMEM_OPTIN} bytes of shared memory)")


def warp_chain_cuda(y0: torch.Tensor, grids: torch.Tensor) -> torch.Tensor:
    """K2: the fused warp chain. y0 (1, gh, gw, C); grids (T, 1, gh, gw, 2)
    float32 -> (T + 1, gh, gw, C). T = 0 returns y0 without a launch."""
    if y0.dim() != 4 or y0.shape[0] != 1:
        raise ValueError(f"warp_chain_cuda: y0 must be (1, gh, gw, C), got {tuple(y0.shape)}")
    _, gh, gw, c = y0.shape
    if grids.dim() != 5 or tuple(grids.shape[1:]) != (1, gh, gw, 2):
        raise ValueError(f"warp_chain_cuda: grids must be (T, 1, {gh}, {gw}, 2), "
                         f"got {tuple(grids.shape)}")
    on_cpu = _check_pair(y0, grids, "warp_chain_cuda")
    t = grids.shape[0]
    if t == 0:
        return y0.reshape(1, gh, gw, c)
    if on_cpu:
        return warp_chain_plain(y0, grids)
    out = torch.empty((t + 1, gh, gw, c), dtype=y0.dtype, device=y0.device)
    vec = _vectorized(c, y0, out)
    itemsize = y0.element_size()
    geo = _chain_geometry(gh * gw, c, itemsize, _VEC_BYTES // itemsize if vec else 1)
    with torch.cuda.device(y0.device):
        err = _library().floodseg_warp_chain(
            y0.data_ptr(), grids.data_ptr(), out.data_ptr(), t, gh, gw, c,
            geo.c_tile, geo.threads, geo.table_points, _DTYPE_CODES[y0.dtype], int(vec),
            torch.cuda.current_stream(y0.device).cuda_stream)
    _raise_on(err, "warp_chain_cuda")
    warp_chain_cuda.launches += 1
    return out


warp_chain_cuda.launches = 0


def reset_launch_counts() -> None:
    grid_sample_cuda.launches = 0
    grid_sample_backward_cuda.launches = 0
    warp_chain_cuda.launches = 0


def launch_counts() -> dict:
    return {"grid_sample_cuda": grid_sample_cuda.launches,
            "grid_sample_backward_cuda": grid_sample_backward_cuda.launches,
            "warp_chain_cuda": warp_chain_cuda.launches}
