"""Thread-local numpy RNG for datasets (``spnerf_tpu/data/rng.py``): the
same seeds and streams, so the port's host draws equal the JAX
package's."""

from __future__ import annotations

import threading
import zlib

import numpy as np


def stable_seed(*parts) -> int:
    """Process-independent seed from strings and ints (Python's ``hash``
    is salted per process)."""
    return zlib.crc32("/".join(str(p) for p in parts).encode()) % 2**31


class ThreadLocalRNG:
    """One numpy Generator per thread, seeded from (base seed, the
    thread's stream index): a shared Generator is not thread-safe."""

    def __init__(self, base_seed: int):
        self._base = int(base_seed) % 2**31
        self._tls = threading.local()
        self._lock = threading.Lock()
        self._next_stream = 0

    def get(self) -> np.random.Generator:
        rng = getattr(self._tls, "rng", None)
        if rng is None:
            with self._lock:
                stream = self._next_stream
                self._next_stream += 1
            rng = np.random.default_rng((self._base, stream))
            self._tls.rng = rng
        return rng
