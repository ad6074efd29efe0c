"""Data parallelism over ranks (counterpart of
floodseg_tpu/parallel/mesh.py).

The JAX package jits each step with the batch sharded over a mesh and the
state replicated; XLA then takes BatchNorm's moments, the losses and the
metrics over the global batch. The port runs one process a GPU (a rank)
and gets the same result by hand:

- ``World``: this process's rank, the number of ranks and their group (a
  world of one when no process group is set up); a world of one takes
  the one-device code path and launches no collective;
- the model runs on this rank's contiguous slice of the global batch
  (``shard_batch``, ``shard``), its BatchNorms reduce their sums over the
  ranks (models/layers.py::BatchNorm2d, through ``all_reduce_sum``, whose
  backward is an all-reduce too) and its dropout masks are drawn at the
  global shape and sliced;
- ``gather`` puts the model's outputs back together on every rank; its
  backward hands each rank its own slice of the gradient and communicates
  nothing, since every rank computes the same loss on the gathered batch.
  So the losses, OHEM's threshold, U2PL's percentiles and draws, the
  memory bank and the s4GAN discriminator all see the global batch,
  replicated;
- ``sum_gradients`` adds the sharded model's gradients over the ranks
  (a sum, not DDP's mean), so every rank takes the same optimizer step;
- ``make_dp_predict_fn``: one key-frame window a rank.

Collectives by backend: NCCL has all of them; gloo with CUDA tensors has
all-reduce and broadcast only, so there a gather is an all-reduce of a
zero-filled global buffer in which each rank wrote its slice (exact).
"""

from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterable, Optional

import numpy as np
import torch
import torch.distributed as dist

TIME_MAJOR_KEYS = ("mvs_left", "mvs_right")


@dataclass(frozen=True)
class World:
    """rank, size and the process group (None: the default group)."""
    rank: int = 0
    size: int = 1
    group: Optional[Any] = None

    @property
    def parallel(self) -> bool:
        return self.size > 1

    @property
    def is_main(self) -> bool:
        return self.rank == 0


def current_world(group=None) -> World:
    """The world of the initialized process group, or a world of one."""
    if not (dist.is_available() and dist.is_initialized()):
        return World()
    return World(dist.get_rank(group), dist.get_world_size(group), group)


def resolve_num_devices(num_devices: Optional[int], world: World) -> int:
    """``trainer.num_devices`` against the world: None is the world's size,
    n reads as min(n, size) as the JAX Runner reads it; below a world of
    more than one rank it raises, since a launched rank cannot sit out."""
    if num_devices is None:
        return world.size
    n = min(int(num_devices), world.size)
    if n < 1 or (world.parallel and n < world.size):
        raise ValueError(f"trainer.num_devices={num_devices} is below the world of "
                         f"{world.size} ranks; every launched rank takes part")
    return n


def shard(x, world: Optional[World], dim: int = 0):
    """This rank's contiguous slice of ``x`` along ``dim`` (which must
    divide by the world's size); ``x`` itself in a world of one (or
    None)."""
    if world is None or not world.parallel:
        return x
    n = x.shape[dim]
    if n % world.size:
        raise ValueError(f"a batch of {n} does not split over {world.size} ranks")
    k = n // world.size
    index = [slice(None)] * len(x.shape)
    index[dim] = slice(world.rank * k, (world.rank + 1) * k)
    return x[tuple(index)]


def shard_batch(batch: Dict, world: World,
                time_major_keys: Iterable[str] = TIME_MAJOR_KEYS) -> Dict:
    """This rank's contiguous slice of a global host batch: the grid chains
    (time-major, (T, B, ...)) on their second dim, scalars whole, every
    other array on its first dim (the layouts of the JAX ``shard_batch``)."""
    out = {}
    for k, v in batch.items():
        if np.ndim(v) == 0:
            out[k] = v
        else:
            out[k] = shard(v, world, 1 if k in time_major_keys else 0)
    return out


def _backend(world: World) -> str:
    return dist.get_backend(world.group)


def all_reduce_(x: torch.Tensor, world: World) -> torch.Tensor:
    """In-place sum over the ranks; ``x`` back."""
    dist.all_reduce(x, group=world.group)
    return x


def all_reduce_array(a: np.ndarray, world: Optional[World]) -> np.ndarray:
    """A host array summed over the ranks (through the card under NCCL);
    ``a`` itself in a world of one."""
    if world is None or not world.parallel:
        return a
    t = torch.from_numpy(np.ascontiguousarray(a))
    if _backend(world) == "nccl":
        t = t.to(torch.device("cuda", torch.cuda.current_device()))
    return all_reduce_(t, world).cpu().numpy()


def _all_gather(x: torch.Tensor, world: World) -> torch.Tensor:
    """The ranks' ``x`` (equal shapes) concatenated on dim 0, in rank order."""
    x = x.contiguous()
    n = x.shape[0]
    shape = (n * world.size,) + tuple(x.shape[1:])
    if _backend(world) == "nccl":
        out = x.new_empty(shape)
        dist.all_gather_into_tensor(out, x, group=world.group)
        return out
    if x.device.type == "cpu":
        parts = [torch.empty_like(x) for _ in range(world.size)]
        dist.all_gather(parts, x, group=world.group)
        return torch.cat(parts)
    # gloo with CUDA tensors: all-reduce a zero-filled buffer holding this
    # rank's slice
    out = x.new_zeros(shape)
    out[world.rank * n:(world.rank + 1) * n] = x
    return all_reduce_(out, world)


class _Gather(torch.autograd.Function):
    """All-gather on dim 0 whose backward returns this rank's slice of the
    incoming gradient: every rank computes the same loss on the gathered
    tensor, so the slice is this rank's share of the global gradient."""

    @staticmethod
    def forward(ctx, x, world):
        ctx.world, ctx.n = world, x.shape[0]
        return _all_gather(x, world)

    @staticmethod
    def backward(ctx, grad):
        r, n = ctx.world.rank, ctx.n
        return grad[r * n:(r + 1) * n], None


def gather(x, world: Optional[World]):
    """The global batch of a per-rank tensor (dim 0, rank order) on every
    rank, differentiable as ``_Gather``; ``x`` itself in a world of one (or
    None), and None for None."""
    if x is None or world is None or not world.parallel:
        return x
    if x.requires_grad:
        return _Gather.apply(x, world)
    return _all_gather(x, world)


class _AllReduce(torch.autograd.Function):
    """Sum over the ranks whose backward is the same sum of the incoming
    gradients: each rank's share of the sum feeds every rank's loss."""

    @staticmethod
    def forward(ctx, x, world):
        ctx.world = world
        return all_reduce_(x.clone(), world)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_(grad.clone(), ctx.world), None


def all_reduce_sum(x: torch.Tensor, world: World) -> torch.Tensor:
    """Differentiable sum of ``x`` over the ranks (BatchNorm's sums)."""
    return _AllReduce.apply(x, world)


@torch.no_grad()
def sum_gradients(params: Iterable[torch.Tensor], world: Optional[World]) -> None:
    """Add every parameter's ``.grad`` over the ranks in place, one
    all-reduce for each dtype; parameters without a gradient are left so
    (the same ones on every rank)."""
    if world is None or not world.parallel:
        return
    by_dtype: Dict[torch.dtype, list] = {}
    for p in params:
        if p.grad is not None:
            by_dtype.setdefault(p.grad.dtype, []).append(p.grad)
    for grads in by_dtype.values():
        flat = torch.cat([g.reshape(-1) for g in grads])
        all_reduce_(flat, world)
        offset = 0
        for g in grads:
            g.copy_(flat[offset:offset + g.numel()].view_as(g))
            offset += g.numel()


def barrier(world: Optional[World]) -> None:
    if world is not None and world.parallel:
        dist.barrier(group=world.group)


def make_dp_predict_fn(predict_fn: Callable, world: World) -> Callable:
    """Data-parallel clip inference: one key-frame window a rank.

    ``predict_fn(variables, fp, fn, ml, mr)`` predicts one clip (fp (1, H,
    W, 3), ml (T, 1, ...)) -> (n, h, w) int32 maps (the non-cached
    ``make_flow_predict_fn``). The returned function takes a global batch
    of clips on every rank: with as many clips as ranks, rank r runs clip r
    and the maps are gathered to every rank, (D * n, h, w) in clip order;
    a smaller (remainder) batch runs clip by clip on every rank, as the JAX
    Runner runs it."""
    def dp(variables, fp, fn_, ml, mr):
        if fp.shape[0] == world.size:
            r = world.rank
            out = predict_fn(variables, fp[r:r + 1], fn_[r:r + 1], ml[:, r:r + 1],
                             mr[:, r:r + 1])
            return gather(torch.as_tensor(out), world)
        outs = [torch.as_tensor(predict_fn(variables, fp[i:i + 1], fn_[i:i + 1],
                                           ml[:, i:i + 1], mr[:, i:i + 1]))
                for i in range(fp.shape[0])]
        return torch.cat(outs, dim=0)

    return dp
