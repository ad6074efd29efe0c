"""Device resolution and the float policy.

Entry points run on the card: ``device=None`` means ``cuda``, and asking for
``cuda`` on a machine without a card raises instead of quietly running on
the CPU. Tests pass ``device="cpu"`` explicitly.

Float policy. The JAX package pins float32 convolutions and contractions to
full float32 (``precision="highest"``, floodseg_tpu/models/layers.py). On
the card cuDNN runs float32 convolutions in TF32 by default, which keeps
about three decimal digits. ``full_precision_f32`` is a context manager
that turns TF32 off for convolutions and matrix products and restores the
caller's flags on exit; the predict builders run each call inside it, so a
float32 program here means float32 arithmetic as in the JAX package, and
no other torch code in the process sees the flags change. bf16
convolutions are unaffected; the float32 resize contractions inside a bf16
program stay full float32, as ``precision="highest"`` keeps them in the
JAX package. It also turns off cuBLAS's reduced-precision reduction of
bf16 products (on by default in PyTorch: a split-K GEMM may add its
partial sums in bf16), so a bf16 product is summed in float32 and rounded
once, as flax's ``Dense(precision="highest")`` does in the ViT.
"""

import contextlib
from typing import Iterator, Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> ``cuda``; raise if a CUDA device is asked for but absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "floodseg_tpu_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain PyTorch path")
    return dev


@contextlib.contextmanager
def full_precision_f32() -> Iterator[None]:
    """TF32 off for cuDNN convolutions and CUDA matrix products, and bf16
    products reduced in float32, inside the block; the previous flags are
    restored on exit."""
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    prev = (cudnn.allow_tf32, matmul.allow_tf32,
            matmul.allow_bf16_reduced_precision_reduction)
    cudnn.allow_tf32 = matmul.allow_tf32 = False
    matmul.allow_bf16_reduced_precision_reduction = False
    try:
        yield
    finally:
        (cudnn.allow_tf32, matmul.allow_tf32,
         matmul.allow_bf16_reduced_precision_reduction) = prev
