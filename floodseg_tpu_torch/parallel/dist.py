"""Rendezvous of the ranks (counterpart of floodseg_tpu/parallel/dist.py).

The reference rendezvouses its DDP workers through SLURM variables and
NCCL; the JAX package through ``jax.distributed.initialize``. The port
calls ``torch.distributed.init_process_group``, one process a GPU.

Environment (read by the CLI when FLOODSEG_MULTIHOST is set):
  FLOODSEG_COORDINATOR    host:port   (MASTER_ADDR:MASTER_PORT)
  FLOODSEG_NUM_PROCESSES  world size  (WORLD_SIZE)
  FLOODSEG_PROCESS_ID     this rank   (RANK)
Without FLOODSEG_COORDINATOR the group rendezvouses by ``env://``: torchrun's
MASTER_ADDR, MASTER_PORT, WORLD_SIZE and RANK, the counterpart of a TPU
pod's auto-detection.
"""

import os
from typing import Mapping, Optional

import torch
import torch.distributed as dist


def _local_device(env: Mapping[str, str], device: Optional[str]) -> torch.device:
    """The device this process drives: ``cuda:LOCAL_RANK`` (``cuda:0`` when
    LOCAL_RANK is unset), or ``device`` when the caller names one."""
    if device is not None and torch.device(device).type == "cpu":
        return torch.device("cpu")
    return torch.device("cuda", int(env.get("LOCAL_RANK", 0)))


def maybe_initialize_multihost(env: Mapping[str, str] = os.environ,
                               device: Optional[str] = None) -> bool:
    """Initialize ``torch.distributed`` iff FLOODSEG_MULTIHOST is set and no
    process group exists yet (a launcher may have made it); True when it
    ran. The backend is ``nccl`` for a CUDA device and ``gloo`` on
    the CPU (``device="cpu"``). An explicit rendezvous must be fully
    specified: defaulting a missing
    NUM_PROCESSES or PROCESS_ID to a one-process world would make every
    host train alone instead of failing on a half-configured launch."""
    if not env.get("FLOODSEG_MULTIHOST") or dist.is_initialized():
        return False
    dev = _local_device(env, device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if env.get("FLOODSEG_COORDINATOR"):
        missing = [v for v in ("FLOODSEG_NUM_PROCESSES", "FLOODSEG_PROCESS_ID")
                   if env.get(v) is None]
        if missing:
            raise RuntimeError(
                "FLOODSEG_COORDINATOR is set but "
                f"{', '.join(missing)} is not; explicit multihost "
                "rendezvous needs all three (MASTER_ADDR/WORLD_SIZE/"
                "RANK equivalents)")
        kw = dict(init_method=f"tcp://{env['FLOODSEG_COORDINATOR']}",
                  world_size=int(env["FLOODSEG_NUM_PROCESSES"]),
                  rank=int(env["FLOODSEG_PROCESS_ID"]))
    else:
        kw = dict(init_method="env://")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, **kw)
    print(f"[multihost] torch.distributed initialized ({backend}): "
          f"rank {dist.get_rank()}/{dist.get_world_size()} on {dev}", flush=True)
    return True
