"""Metric logging to ``metrics.jsonl`` (``spnerf_tpu/utils/logging.py``
without its optional TensorBoard writer)."""

from __future__ import annotations

import json
import time
from pathlib import Path


class MetricWriter:
    """Appends {"tag", "value", "step", "time"} lines to
    ``<log_dir>/metrics.jsonl``."""

    def __init__(self, log_dir: str | Path):
        self.log_dir = Path(log_dir)
        self.log_dir.mkdir(parents=True, exist_ok=True)
        self._jsonl = open(self.log_dir / "metrics.jsonl", "a")

    def scalar(self, tag: str, value, step: int):
        self._jsonl.write(json.dumps({"tag": tag, "value": float(value),
                                      "step": int(step),
                                      "time": time.time()}) + "\n")

    def scalars(self, metrics: dict, step: int, prefix: str = ""):
        for k, v in metrics.items():
            self.scalar(prefix + k, v, step)

    def flush(self):
        self._jsonl.flush()

    def close(self):
        self.flush()
        self._jsonl.close()


class NullWriter:
    """A ``MetricWriter`` that writes nothing: a data-parallel rank other
    than 0."""

    def scalar(self, tag: str, value, step: int):
        pass

    def scalars(self, metrics: dict, step: int, prefix: str = ""):
        pass

    def flush(self):
        pass

    def close(self):
        pass
