"""The data-parallel mesh and its sums (``spnerf_tpu/parallel/mesh.py``).

The reference shards a batch over a 1-D ``jax.sharding.Mesh`` (axis
"data"), replicates the parameters and lets XLA insert the sums over
devices. Here each rank is a process (``parallel/distributed.py``) that
holds its contiguous rows of the global batch, and the sums are explicit:

- BatchNorm's batch statistics (``models/superpoint.BatchNorm``), by
  ``psum``, which carries the gradient back;
- the losses' normalisers (``batch_sum``), so that each rank's loss is its
  share of the global batch's loss and the shares add up to it;
- the gradients after the backward (``sum_gradients``), in flat buckets,
  so that Adam sees the single-device gradient;
- the metrics (``sum_metrics``), so that rank 0 logs the global values.

The first two read the mesh that ``data_parallel`` makes active around a
training step's forward and backward; without one they are the identity,
and so is every function here on a mesh without a process group.
SuperPoint has ~1.3 M parameters: data parallelism is the only
parallelism that pays.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
from typing import Any

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from spnerf_tpu_torch.parallel import distributed


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This process's place on the 1-D data mesh: ``rank`` of ``size``
    ranks of ``group`` (None: one process, no collectives)."""

    rank: int = 0
    size: int = 1
    group: Any = None

    def rows(self, n: int) -> slice:
        """This rank's contiguous rows of a global batch of ``n``."""
        if n % self.size:
            raise ValueError(f"a batch of {n} does not split over "
                             f"{self.size} ranks")
        per = n // self.size
        return slice(self.rank * per, (self.rank + 1) * per)


def global_rows(n_local: int, mesh: Mesh | None) -> tuple[int, slice]:
    """(global batch size, this rank's rows of it) for a rank that holds
    ``n_local`` rows; (n_local, all rows) without a mesh."""
    if mesh is None:
        return n_local, slice(None)
    n = n_local * mesh.size
    return n, mesh.rows(n)


def make_mesh(group=None) -> Mesh:
    """The mesh over the ranks of ``group`` (default: every rank of the
    process group), of size 1 without a process group."""
    if not distributed.is_initialized():
        return Mesh()
    group = dist.group.WORLD if group is None else group
    return Mesh(dist.get_rank(group), dist.get_world_size(group), group)


def shard_batch(batch, mesh: Mesh):
    """This rank's contiguous rows of every array (numpy or torch) and
    list of a global batch, a dict of them possibly nested; other values
    pass as they are."""
    if mesh.size == 1:
        return batch
    if isinstance(batch, dict):
        return {k: shard_batch(v, mesh) for k, v in batch.items()}
    if isinstance(batch, (np.ndarray, torch.Tensor)) and batch.ndim == 0:
        return batch
    if isinstance(batch, (np.ndarray, torch.Tensor, list)):
        return batch[mesh.rows(len(batch))]
    return batch


def _src(mesh: Mesh) -> int:
    return dist.get_global_rank(mesh.group, 0)


@torch.no_grad()
def _flat(tensors, collective) -> None:
    """Run ``collective`` on one flat copy of the tensors of each (device,
    dtype) and copy the result back into them."""
    buckets = collections.defaultdict(list)
    for t in tensors:
        buckets[(t.device, t.dtype)].append(t)
    for group in buckets.values():
        flat = torch.cat([t.reshape(-1) for t in group])
        collective(flat)
        offset = 0
        for t in group:
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()


def replicate(tree, mesh: Mesh):
    """Rank 0's values on every rank, in place: a module's parameters and
    buffers, or the tensors of a dict or list. Returns ``tree``."""
    if mesh.group is None:
        return tree
    if isinstance(tree, nn.Module):
        tensors = list(tree.parameters()) + list(tree.buffers())
    elif isinstance(tree, dict):
        tensors = list(tree.values())
    else:
        tensors = list(tree)
    _flat(tensors, lambda flat: dist.broadcast(flat, _src(mesh),
                                               group=mesh.group))
    return tree


def broadcast(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Rank 0's ``t`` on every rank (a new tensor elsewhere; the shapes
    may differ between ranks, the dimensions and dtype may not)."""
    if mesh.group is None:
        return t
    shape = torch.tensor(t.shape, dtype=torch.int64, device=t.device)
    dist.broadcast(shape, _src(mesh), group=mesh.group)
    out = (t.contiguous() if mesh.rank == 0 else
           torch.empty(tuple(shape.tolist()), dtype=t.dtype, device=t.device))
    dist.broadcast(out, _src(mesh), group=mesh.group)
    return out


def barrier(mesh: Mesh) -> None:
    """Wait until every rank of the mesh is here."""
    if mesh.group is not None:
        dist.barrier(group=mesh.group)


class _Psum(torch.autograd.Function):
    """Sum over the ranks; the gradient of the sum is summed the same way
    (each rank's share of the loss reaches every rank's input)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def psum(x: torch.Tensor, mesh: Mesh | None) -> torch.Tensor:
    """``x`` summed over the ranks of ``mesh``, differentiable."""
    if mesh is None or mesh.group is None:
        return x
    return _Psum.apply(x, mesh.group)


# the mesh of the training step running in this process: BatchNorm reads
# it inside the model's forward, which takes no mesh argument
_active: Mesh | None = None


@contextlib.contextmanager
def data_parallel(mesh: Mesh | None):
    """Make ``mesh`` the one BatchNorm and ``batch_sum`` sum over inside
    the block (None: none)."""
    global _active
    saved, _active = _active, mesh
    try:
        yield
    finally:
        _active = saved


def active_mesh() -> Mesh | None:
    """The mesh of the enclosing ``data_parallel`` block, if any."""
    return _active


def batch_sum(x: torch.Tensor) -> torch.Tensor:
    """A loss normaliser (a count or a mask sum over this rank's rows)
    summed over the ranks of the active mesh, without gradient; ``x``
    itself outside a data-parallel step."""
    mesh = _active
    if mesh is None or mesh.group is None:
        return x
    out = x.detach().clone()
    dist.all_reduce(out, group=mesh.group)
    return out


def sum_gradients(params, mesh: Mesh | None) -> None:
    """Sum the parameters' gradients over the ranks, in place, one flat
    bucket per (device, dtype)."""
    if mesh is None or mesh.group is None:
        return
    grads = [p.grad for p in params if p.grad is not None]
    _flat(grads, lambda flat: dist.all_reduce(flat, group=mesh.group))


def sum_metrics(metrics: dict, mesh: Mesh | None) -> dict:
    """{name: scalar tensor} summed over the ranks in one collective."""
    if mesh is None or mesh.group is None:
        return metrics
    stacked = torch.stack([v.detach().float() for v in metrics.values()])
    dist.all_reduce(stacked, group=mesh.group)
    return dict(zip(metrics, stacked.unbind()))
