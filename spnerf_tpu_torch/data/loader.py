"""Host-side batch loader with one background prefetch thread
(``spnerf_tpu/data/loader.py``; numpy only).

A daemon thread assembles numpy batches ahead of the consumer, so host
data work overlaps device work. Iterating returns a generator: its
``close()`` (or the end of the loop) stops the thread and joins it.
"""

from __future__ import annotations

import queue
import threading

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
    end. The reference's worker pool is not ported."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = False,
                 drop_last: bool = True, seed: int = 0, prefetch: int = 2,
                 infinite: bool = False):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.prefetch = prefetch
        self.infinite = infinite

    def __len__(self):
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _batches(self):
        rng = np.random.default_rng(self.seed)
        n = len(self.dataset)
        stop = n - self.batch_size + 1 if self.drop_last else n
        while True:
            idx = np.arange(n)
            if self.shuffle:
                rng.shuffle(idx)
            for s in range(0, max(stop, 0), self.batch_size):
                yield collate([self.dataset[int(i)]
                               for i in idx[s:s + self.batch_size]])
            if not self.infinite:
                return

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
                for batch in self._batches():
                    if not put(batch):
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
