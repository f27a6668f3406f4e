"""The gather probes: ``gather_rows``, ``gather_columns`` and
``gather_in_rows`` launch ``csrc/probe_gather.cu``.

Replace the three kernels of ``benchmarks/mosaic_gather_probe.py:34
_run`` (:47, :60, :73), float32 values and int32 indices::

    gather_rows(table, idx)     table[idx]                   (T, F), (N,)
    gather_columns(table, idx)  take_along_axis(table, idx, axis=0)
    gather_in_rows(x, idx)      take_along_axis(x, idx, axis=1)

An index outside its axis gives NaN, as ``jnp.take`` and
``jnp.take_along_axis`` fill by default. CPU tensors take the ``_plain``
versions.

The column gather walks the output slab by slab (``csrc/probe_gather.cu``
says why): ``column_walk`` mirrors the kernel's index map, and
``column_hbm_bytes_model`` counts the HBM bytes a traversal's schedule
asks for under a stated rule, a count and not a measurement.
"""

from __future__ import annotations

import numpy as np
import torch

from spnerf_tpu_torch.kernels import _build

FORMS = {"rows": 0, "columns": 1, "in-rows": 2}
# csrc/probe_gather.cu's kSlab, kColThreads, kColSteps: a slab of 16
# columns (64 bytes of a float32 table row), 256 threads a block, each
# walking 2 groups of rows; a block covers 32 rows of one slab
SLAB, COL_THREADS, COL_STEPS = 16, 256, 2
COL_ROWS = COL_THREADS // SLAB * COL_STEPS
SECTOR, LINE = 32, 128  # bytes of an L2 sector and line
L2_PART = 25e6  # bytes of one of the H100's two L2 partitions


def launch_key(form: str) -> str:
    return f"probe_gather[{form}]"


def _check(name, src, idx, rank):
    if src.dim() != 2 or src.dtype != torch.float32:
        raise ValueError(f"{name}: a 2-D float32 source, not "
                         f"{tuple(src.shape)} {src.dtype}")
    if idx.dim() != rank or idx.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"{name}: {rank}-D integer indices, not "
                         f"{tuple(idx.shape)} {idx.dtype}")


def _filled(values, ok):
    return torch.where(ok, values, torch.full((), float("nan"),
                                              device=values.device))


def gather_rows_plain(table, idx):
    _check("gather_rows", table, idx, 1)
    ok = (idx >= 0) & (idx < table.shape[0])
    rows = table[idx.long().clamp(0, table.shape[0] - 1)]
    return _filled(rows, ok[:, None])


def gather_columns_plain(table, idx):
    _check("gather_columns", table, idx, 2)
    ok = (idx >= 0) & (idx < table.shape[0])
    return _filled(torch.gather(table, 0, idx.long().clamp(0, table.shape[0] - 1)), ok)


def gather_in_rows_plain(x, idx):
    _check("gather_in_rows", x, idx, 2)
    ok = (idx >= 0) & (idx < x.shape[1])
    return _filled(torch.gather(x, 1, idx.long().clamp(0, x.shape[1] - 1)), ok)


def _launch(form, src, idx, out_shape, N, G):
    src = src.contiguous()
    idx = idx.to(torch.int32).contiguous()
    out = torch.empty(out_shape, dtype=torch.float32, device=src.device)
    T, F = src.shape
    _build.check_cuda(f"probe_gather[{form}]", src=src, idx=idx, out=out)
    _build.launch("probe_gather", "probe_gather_launch", src, idx, out,
                  FORMS[form], T, F, N, G)
    _build.launch_counts[launch_key(form)] += 1
    return out


def gather_rows(table, idx):
    """table (T, F) float32, F % 4 == 0 on the card, idx (N,) ->
    (N, F)."""
    if not table.is_cuda:
        return gather_rows_plain(table, idx)
    _check("gather_rows", table, idx, 1)
    if table.shape[1] % 4:
        raise ValueError("gather_rows: F % 4 == 0 on the card (16-byte rows)")
    return _launch("rows", table, idx, (idx.shape[0], table.shape[1]),
                   idx.shape[0], 0)


def gather_columns(table, idx):
    """table (T, F) float32, idx (N, F) -> (N, F)."""
    if not table.is_cuda:
        return gather_columns_plain(table, idx)
    _check("gather_columns", table, idx, 2)
    if idx.shape[1] != table.shape[1]:
        raise ValueError(f"gather_columns: idx {tuple(idx.shape)} for a "
                         f"table of {table.shape[1]} columns")
    return _launch("columns", table, idx, tuple(idx.shape), idx.shape[0], 0)


def gather_in_rows(x, idx):
    """x (N, F) float32, idx (N, G) -> (N, G)."""
    if not x.is_cuda:
        return gather_in_rows_plain(x, idx)
    _check("gather_in_rows", x, idx, 2)
    if idx.shape[0] != x.shape[0]:
        raise ValueError(f"gather_in_rows: idx {tuple(idx.shape)} for "
                         f"{x.shape[0]} rows")
    return _launch("in-rows", x, idx, tuple(idx.shape), x.shape[0],
                   idx.shape[1])


def column_walk(N: int, F: int):
    """The column kernel's index map: ``(block, i, j)`` int64 arrays of
    every (output row, column) a thread of the grid visits, in the
    order of block, step and thread, as ``gather_columns_kernel``
    computes them (the launch's slab-major grid, its guards ``j < F`` and
    ``i < N``); each visit reads ``idx[i, j]`` once and writes
    ``out[i, j]``."""
    chunks = -(-N // COL_ROWS)
    blocks = chunks * -(-F // SLAB)
    b = np.arange(blocks)[:, None, None]
    k = np.arange(COL_STEPS)[None, :, None]
    tid = np.arange(COL_THREADS)[None, None, :]
    j = (b // chunks) * SLAB + tid % SLAB
    i = (b % chunks) * COL_ROWS + tid // SLAB + k * (COL_THREADS // SLAB)
    b, i, j = np.broadcast_arrays(b, i, j)
    keep = (j < F) & (i < N)
    return b[keep], i[keep], j[keep]


def column_hbm_bytes_model(idx: torch.Tensor, T: int, order: str = "slabs") -> int:
    """HBM bytes the column gather's schedule asks for, counted (not
    measured) by this rule: the indices and the output once each (4 bytes
    a value); each distinct 32-byte sector of the table the indices touch
    once, on its first touch; every further touch again with the chance
    that its sector has left L2, ``1 - L2_PART / live``, where ``live``
    is the table in 128-byte L2 lines that the blocks in flight address:
    all of it in ``"flat"`` order, one line of each row in ``"slabs"``
    order (a slab of 16 columns is half a line)."""
    N, F = idx.shape
    live = T * F * 4 if order == "flat" else T * LINE
    ids = idx.long()
    ok = (ids >= 0) & (ids < T)
    per_row = -(-F * 4 // SECTOR)
    sector = torch.arange(F, device=idx.device) * 4 // SECTOR
    distinct = torch.unique((ids * per_row + sector)[ok]).numel()
    again = int(ok.sum()) - distinct
    miss = max(0.0, 1.0 - L2_PART / live)
    return 2 * 4 * N * F + SECTOR * (distinct + round(again * miss))
