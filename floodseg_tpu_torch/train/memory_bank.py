"""U2PL's class-wise memory bank of negative keys as fixed-capacity ring
buffers (counterpart of floodseg_tpu/train/memory_bank.py).

One (C, capacity + 1, D) float32 buffer on the device, a class's keys in
its first ``caps[c]`` rows and one scratch row at the end, with per-class
counts and ring pointers as device tensors. ``enqueue`` writes up to
``max_enqueue`` keys a class a step (a random subset of the step's
high-entropy keys; the reference enqueues all of them, which changes only
how fast the pool turns over) into the ring slots after the pointer, and
sends the rows that are not valid to the scratch row, so no write depends
on a count read back to the host. The slots are distinct because
``max_enqueue`` is at most every class's capacity, which the bank asserts
when it is made. ``sample_negatives`` draws indices uniformly over a
class's valid keys, with replacement.
"""

from dataclasses import dataclass

import torch


@dataclass
class MemoryBank:
    """buffer: (C, capacity + 1, D) float32, the last row scratch; counts:
    (C,) int64 valid keys of each class (at most its cap); ptrs: (C,) int64
    ring write pointers; caps: the per-class capacities (host ints)."""
    buffer: torch.Tensor
    counts: torch.Tensor
    ptrs: torch.Tensor
    caps: tuple

    @property
    def keys(self) -> torch.Tensor:
        """(C, capacity, D): the keys without the scratch row."""
        return self.buffer[:, :-1]


def create_memory_bank(num_classes: int, dim: int = 256, capacity: int = 30000,
                       class0_capacity: int = 50000, max_enqueue: int = 1024,
                       device=None) -> MemoryBank:
    """An empty bank: class 0 holds ``class0_capacity`` keys, the others
    ``capacity``. ``max_enqueue`` (the keys a class may take a step) must
    not exceed any class's capacity, or a step's ring slots would repeat."""
    caps = (class0_capacity,) + (capacity,) * (num_classes - 1)
    if max_enqueue > min(caps):
        raise ValueError(f"max_enqueue {max_enqueue} exceeds a class capacity {min(caps)}")
    return MemoryBank(
        buffer=torch.zeros((num_classes, max(caps) + 1, dim), dtype=torch.float32,
                           device=device),
        counts=torch.zeros(num_classes, dtype=torch.int64, device=device),
        ptrs=torch.zeros(num_classes, dtype=torch.int64, device=device),
        caps=caps)


@torch.no_grad()
def enqueue(bank: MemoryBank, c: int, new_keys: torch.Tensor, valid: torch.Tensor) -> None:
    """Ring-write the valid rows of ``new_keys`` (M, D) for class ``c`` in
    place; ``valid`` (M,) bool with every valid row first (the layout of
    ``masked_subset``). The count grows by the valid rows up to the cap and
    the pointer moves on by them modulo the cap."""
    m = new_keys.shape[0]
    cap = bank.caps[c]
    n_new = valid.sum()
    slots = (bank.ptrs[c] + torch.arange(m, device=valid.device)) % cap
    slots = torch.where(valid, slots, bank.buffer.shape[1] - 1)
    bank.buffer[c].index_copy_(0, slots, new_keys.to(bank.buffer.dtype))
    bank.counts[c] = torch.clamp(bank.counts[c] + n_new, max=cap)
    bank.ptrs[c] = (bank.ptrs[c] + n_new) % cap


def sample_negatives(bank: MemoryBank, c: int, idx: torch.Tensor) -> torch.Tensor:
    """Class ``c``'s keys at ``idx`` (drawn in [0, max(count, 1)); callers
    gate on counts[c] > 0)."""
    return bank.buffer[c][idx]
