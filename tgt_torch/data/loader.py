"""Training sampler and a threaded prefetching batch loader (counterpart of
tgt_tpu/data/loader.py; ported: ``slice_for_rank``,
``DistributedTrainSampler`` and ``DataLoader``. The size-bucketed sampler
and the test sampler come with ROADMAP.md item 1j).

Sharding as the reference samplers (lib/training/samplers.py): each rank
owns a static contiguous slice of the dataset, shuffles within it each
epoch, and wrap-pads so that all ranks yield epochs of equal length. The
loader collates on a host thread while the card runs the previous batch.
"""
from __future__ import annotations

import queue
import threading
from typing import Callable, Dict, Iterator, List, Tuple

import numpy as np


def slice_for_rank(length: int, rank: int, world_size: int) -> Tuple[int, int]:
    """Contiguous per-rank slice (reference: samplers.py:30-44)."""
    base = length // world_size
    rem = length % world_size
    start = rank * base + min(rank, rem)
    end = start + base + (1 if rank < rem else 0)
    return start, end


class DistributedTrainSampler:
    """Static contiguous slice + in-slice shuffle + wrap-pad to equal
    length."""

    def __init__(self, length: int, batch_size: int, rank: int = 0,
                 world_size: int = 1, seed: int = 0):
        self.batch_size = batch_size
        self.seed = seed
        self.start, self.end = slice_for_rank(length, rank, world_size)
        self.per_rank = (length + world_size - 1) // world_size
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __iter__(self) -> Iterator[List[int]]:
        idx = np.arange(self.start, self.end)
        np.random.RandomState(self.seed + self.epoch).shuffle(idx)
        if len(idx) < self.per_rank and len(idx) > 0:
            idx = np.concatenate([idx, idx[:self.per_rank - len(idx)]])
        for i in range(0, len(idx), self.batch_size):
            yield idx[i:i + self.batch_size].tolist()

    def __len__(self) -> int:
        return (self.per_rank + self.batch_size - 1) // self.batch_size


class DataLoader:
    """Prefetching loader: dataset rows -> ``collate_fn`` on one host
    thread, at most ``PREFETCH`` batches ahead of the consumer."""

    PREFETCH = 4

    def __init__(self, dataset, sampler, collate_fn: Callable):
        self.dataset = dataset
        self.sampler = sampler
        self.collate_fn = collate_fn

    def _make_batch(self, batch_idx: List[int]) -> Dict[str, np.ndarray]:
        return self.collate_fn([self.dataset[i] for i in batch_idx])

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        batches = list(self.sampler)
        q: "queue.Queue" = queue.Queue(maxsize=self.PREFETCH)
        stop = threading.Event()

        def put(item) -> bool:
            """A put that gives up once the consumer has stopped (no thread
            left blocked on an early exit)."""
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.25)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                for bi in batches:
                    if stop.is_set() or not put(self._make_batch(bi)):
                        return
            except Exception as exc:  # surface worker errors to the consumer
                put(exc)
            finally:
                put(None)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    break
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()

    def __len__(self) -> int:
        return len(self.sampler)
