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
"""

from __future__ import annotations

import torch

from spnerf_tpu_torch.kernels import _build

FORMS = {"rows": 0, "columns": 1, "in-rows": 2}


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
