"""Global path roots: where data, checkpoints and exports live.

The same three roots as the JAX package, read from the same environment
variables: ``SPNERF_ROOT`` (default ``~/spnerf_runs``) and, each on its
own, ``SPNERF_DATA_PATH``, ``SPNERF_CKPT_PATH`` and ``SPNERF_EXPER_PATH``.
The demo's evidence files (``demo/run.py``) go to ``EVIDENCE_PATH``,
``$SPNERF_ROOT/evidence``.
"""

import os
from pathlib import Path

_ROOT = Path(os.environ.get("SPNERF_ROOT", Path.home() / "spnerf_runs"))

DATA_PATH = Path(os.environ.get("SPNERF_DATA_PATH", _ROOT / "data"))
CKPT_PATH = Path(os.environ.get("SPNERF_CKPT_PATH", _ROOT / "ckpts"))
EXPER_PATH = Path(os.environ.get("SPNERF_EXPER_PATH", _ROOT / "outputs"))
EVIDENCE_PATH = _ROOT / "evidence"
