"""Host-side batch loader with one background prefetch thread
(``spnerf_tpu/data/loader.py``; numpy only).

A daemon thread assembles numpy batches ahead of the consumer, so host
data work overlaps device work; with ``num_workers`` above 1 it loads
each batch's samples on a pool of that many threads, as the reference
does (``data.num_workers``). Iterating returns a generator: its
``close()`` (or the end of the loop) stops the thread and joins it.
"""

from __future__ import annotations

import copy
import queue
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np


def collate(samples: list[dict]) -> dict:
    """Stack a list of same-keyed dict samples into batched numpy arrays."""
    out = {}
    for k in samples[0]:
        vals = [s[k] for s in samples]
        if isinstance(vals[0], dict):
            out[k] = collate(vals)
        else:
            out[k] = np.stack(vals)
    return out


class DataLoader:
    """Batches of the dataset with thread prefetch: in order, or with
    ``shuffle`` in an order drawn anew for every epoch from
    ``np.random.default_rng(seed)``; with ``infinite`` the epochs never
    end. With ``num_workers`` above 1 a batch's samples are loaded by
    ``ThreadPoolExecutor(num_workers).map`` (a fresh pool per batch, the
    samples in index order); with 0 or 1 on the loader's own thread. A
    dataset that draws from thread-local generators (``data/rng.py``)
    then draws on threads that differ from batch to batch, so its
    samples are no longer repeatable; the indices are."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = False,
                 drop_last: bool = True, seed: int = 0, prefetch: int = 2,
                 infinite: bool = False, num_workers: int = 0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.prefetch = prefetch
        self.infinite = infinite
        self.num_workers = num_workers
        self.shard_of = (0, 1)

    def shard(self, index: int, count: int) -> "DataLoader":
        """A copy that loads only the ``index``-th of ``count`` equal,
        contiguous parts of each batch: a data-parallel rank's rows. The
        batches' indices stay those of this loader."""
        out = copy.copy(self)
        out.shard_of = (index, count)
        return out

    def __len__(self):
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def batch_indices(self):
        """The index array of each batch, in the order they are loaded."""
        rng = np.random.default_rng(self.seed)
        n = len(self.dataset)
        stop = n - self.batch_size + 1 if self.drop_last else n
        while True:
            idx = np.arange(n)
            if self.shuffle:
                rng.shuffle(idx)
            for s in range(0, max(stop, 0), self.batch_size):
                yield idx[s:s + self.batch_size]
            if not self.infinite:
                return

    def _load(self, batch_idx) -> dict:
        index, count = self.shard_of
        if len(batch_idx) % count:
            raise ValueError(f"a batch of {len(batch_idx)} does not split "
                             f"into {count} parts")
        per = len(batch_idx) // count
        batch_idx = batch_idx[index * per:(index + 1) * per]

        def sample(i):
            return self.dataset[int(i)]

        if self.num_workers > 1:
            with ThreadPoolExecutor(self.num_workers) as pool:
                return collate(list(pool.map(sample, batch_idx)))
        return collate([sample(i) for i in batch_idx])

    def __iter__(self):
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = object()
        closed = threading.Event()

        def put(item) -> bool:
            # bounded-poll put, so that close() ends a worker blocked on a
            # full queue
            while not closed.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            try:
                for batch_idx in self.batch_indices():
                    if not put(self._load(batch_idx)):
                        return
                put(stop)
            except BaseException as e:  # noqa: BLE001 - raised in the consumer
                put(e)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is stop:
                    return
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            closed.set()
            t.join()
