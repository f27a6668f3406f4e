"""Process groups on ``torch.distributed`` (``spnerf_tpu/parallel/
distributed.py``).

The reference runs one JAX process per host and lets its mesh span the
hosts' devices; the port runs one process per device, PyTorch's own
idiom, started by ``torchrun --nproc_per_node=N``. The variables that
``torchrun`` sets stand in for the reference's:

    JAX_COORDINATOR_ADDRESS       MASTER_ADDR:MASTER_PORT
    JAX_NUM_PROCESSES             WORLD_SIZE
    JAX_PROCESS_ID                RANK
    (one process drives a host)   LOCAL_RANK: this process's card
    JAX_SHUTDOWN_TIMEOUT_SECONDS  SPNERF_DIST_TIMEOUT_SECONDS

``parallel/mesh.py`` then builds the 1-D "data" mesh over the ranks.
Without a group every function here answers as a single process does.
"""

from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

DEFAULT_TIMEOUT_S = 300


def is_initialized() -> bool:
    """Whether this process has joined a process group."""
    return dist.is_available() and dist.is_initialized()


def local_rank() -> int:
    """``LOCAL_RANK``: the index of this process's card on its host (0
    where it is unset)."""
    return int(os.environ.get("LOCAL_RANK", 0))


def rank_device(device="cuda") -> torch.device:
    """The device of this rank: ``cuda`` means ``cuda:LOCAL_RANK`` under a
    process group; any other device, or one with an index, is kept."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None and is_initialized():
        return torch.device("cuda", local_rank())
    return device


def maybe_initialize_distributed(backend: str | None = None,
                                 device=None) -> bool:
    """Join the process group that ``torchrun``'s variables describe.

    Returns True if this process is in a group: one that already existed
    (nothing is initialized twice) or the one joined here. Returns False,
    and does nothing, where ``WORLD_SIZE`` is unset or at most 1.
    ``backend`` defaults to ``nccl`` for a CUDA ``device`` (the default)
    and ``gloo`` for the CPU; NCCL takes one rank per card, so ranks that
    share a card need ``gloo``. A failed initialization raises.
    """
    if is_initialized():
        return True
    world = os.environ.get("WORLD_SIZE")
    if not world or int(world) <= 1:
        return False
    device = torch.device("cuda" if device is None else device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if device.type == "cuda":
        torch.cuda.set_device(device.index if device.index is not None
                              else local_rank())
    # Sharded exports have no sync point between their shards until the
    # barrier at the end, so the skew between shards (stragglers, uneven
    # hosts) lands entirely on that barrier: it has to wait that long.
    timeout_s = int(os.environ.get("SPNERF_DIST_TIMEOUT_SECONDS",
                                   DEFAULT_TIMEOUT_S))
    dist.init_process_group(backend, init_method="env://",
                            timeout=datetime.timedelta(seconds=timeout_s))
    return True


def process_index() -> int:
    """This process's rank (``jax.process_index()``); 0 without a group."""
    return dist.get_rank() if is_initialized() else 0


def process_count() -> int:
    """The number of ranks (``jax.process_count()``); 1 without a group."""
    return dist.get_world_size() if is_initialized() else 1


def process_local_batch_slice(global_batch_size: int) -> tuple[int, int]:
    """(start, size) of this process's slice of the global batch."""
    n = process_count()
    i = process_index()
    per = global_batch_size // n
    return i * per, per
