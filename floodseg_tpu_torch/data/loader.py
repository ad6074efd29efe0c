"""Prefetching data loader (host threads) and the host -> card copy.

Counterpart of floodseg_tpu/data/loader.py. Items are read and transformed
by a thread pool (the port's JPEG decoder releases the GIL), collated to
numpy in one producer thread, optionally handed to ``device_put``, and
delivered in order.

PRNG discipline: item i of epoch e is transformed with
``np.random.default_rng((seed, e, i))``, whatever the workers' schedule.

Over the ranks of a ``world`` (parallel/mesh.py) a loader reads only this
rank's part: with ``share="rows"`` its contiguous share of every batch of
``batch_size`` (the global batch of a data-parallel step), with
``share="batches"`` every ``world.size``-th batch from its rank on (its
share of an evaluation pass). The PRNG discipline makes the items the ones
a one-rank loader gives.
"""

import queue
import threading
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, Iterator, Optional

import numpy as np
import torch

from floodseg_tpu_torch.core.device import DeviceLike, resolve_device
from floodseg_tpu_torch.data.dataset import _INT_KEYS, collate
from floodseg_tpu_torch.parallel.mesh import World, shard


def device_put(batch: Dict[str, np.ndarray], device: DeviceLike = None) -> Dict:
    """A collated batch on ``device`` (``None`` -> ``cuda``): every array
    but the ids becomes a tensor there. On the card each goes through a
    pinned host buffer and a ``non_blocking`` copy on the current stream,
    and nothing synchronises (counterpart of bench.py's device_put). The
    ids (frame ids, deltas) stay host-side numpy: reading them back from
    the card would wait for it."""
    dev = resolve_device(device)
    out = {}
    for k, v in batch.items():
        if k in _INT_KEYS:
            out[k] = v
            continue
        t = torch.from_numpy(np.ascontiguousarray(v))
        if dev.type == "cuda":
            t = t.pin_memory().to(dev, non_blocking=True)
        out[k] = t
    return out


class DataLoader:
    def __init__(
        self,
        dataset,
        batch_size: int = 1,
        shuffle: bool = False,
        drop_last: bool = False,
        num_workers: int = 8,
        seed: int = 0,
        prefetch: int = 2,
        device_put: Optional[Callable] = None,
        infinite: bool = False,
        world: Optional[World] = None,
        share: str = "rows",
    ):
        if share not in ("rows", "batches"):
            raise ValueError(f"share is 'rows' or 'batches', got {share!r}")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_workers = max(1, num_workers)
        self.seed = seed
        self.prefetch = prefetch
        self.device_put = device_put
        self.infinite = infinite
        self.world = world if world is not None and world.parallel else None
        self.share = share
        self.epoch = 0

    def __len__(self):
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def _epoch_indices(self, epoch: int) -> np.ndarray:
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng((self.seed, epoch)).shuffle(idx)
        return idx

    def _batches(self, epoch: int):
        idx = self._epoch_indices(epoch)
        n = len(idx)
        stop = n - n % self.batch_size if self.drop_last else n
        w = self.world
        for bi, s in enumerate(range(0, stop, self.batch_size)):
            if w is None:
                yield idx[s:s + self.batch_size]
            elif self.share == "rows":
                yield shard(idx[s:s + self.batch_size], w)
            elif bi % w.size == w.rank:
                yield idx[s:s + self.batch_size]

    def __iter__(self) -> Iterator:
        # claim this iteration's epoch up front: a consumer that breaks
        # early must not replay the same shuffle and transforms next time
        start_epoch = self.epoch
        self.epoch += 1
        out_q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def load_item(epoch, i):
            rng = np.random.default_rng((self.seed, epoch, int(i)))
            return self.dataset.get(int(i), rng)

        def put(item) -> bool:
            """Queue-put that gives up when the consumer is gone."""
            while not stop.is_set():
                try:
                    out_q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def schedule():
            epoch = start_epoch
            while True:
                for bidx in self._batches(epoch):
                    yield epoch, bidx
                if not self.infinite:
                    return
                epoch += 1

        def producer():
            pool = ThreadPoolExecutor(max_workers=self.num_workers)
            # item loads are submitted across upcoming batches, so that at
            # batch_size=1 every worker is busy; collate and device_put stay
            # in this one thread, which keeps the delivery ordered
            lookahead = -(-self.num_workers // self.batch_size) + max(self.prefetch, 1)
            pending: deque = deque()
            sched = schedule()
            try:
                while not stop.is_set():
                    while len(pending) < lookahead:
                        nxt = next(sched, None)
                        if nxt is None:
                            break
                        epoch, bidx = nxt
                        pending.append([pool.submit(load_item, epoch, int(i)) for i in bidx])
                    if not pending:
                        break
                    items = [f.result() for f in pending.popleft()]
                    batch = collate(items)
                    if self.device_put is not None:
                        batch = self.device_put(batch)
                    if not put(batch):
                        return
            except BaseException as e:  # surfaced to the consumer, which re-raises
                put(("__error__", e))
            finally:
                for futs in pending:
                    for f in futs:
                        f.cancel()
                put(None)
                pool.shutdown(wait=False)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                batch = out_q.get()
                if batch is None:
                    break
                if isinstance(batch, tuple) and len(batch) == 2 and batch[0] == "__error__":
                    raise RuntimeError("DataLoader worker failed") from batch[1]
                yield batch
        finally:
            stop.set()
            while not out_q.empty():
                try:
                    out_q.get_nowait()
                except queue.Empty:
                    break
