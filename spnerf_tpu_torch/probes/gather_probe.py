"""Gathers on the card: the port of ``benchmarks/mosaic_gather_probe.py``.

    python -m spnerf_tpu_torch.probes.gather_probe [--device cpu]

The TPU file asked which gather forms lower through Mosaic (only the
in-row lane gather did, which ruled out a fused hash-grid kernel there).
Here all three are written (``kernels/probe_gather.py``, which replaces
its ``_run``, :34), so the question becomes what each costs: each probe
checks the kernel against numpy bit for bit and times it, at the file's
sizes (which measure a launch) and at a 2^18 x 128 float32 table (128 MB,
past the 50 MB L2), the row gather with 2^20 indices and the two
take_along_axis forms with indices of the table's shape, as the file's
probes shape them. Lines: ``OK max|err|`` as the file's, then ms per call
and GB/s of the bytes the call must move (indices, the table values it
touches, the output).
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from spnerf_tpu_torch.device import resolve_device
from spnerf_tpu_torch.kernels.probe_gather import (
    gather_columns,
    gather_in_rows,
    gather_rows,
)
from spnerf_tpu_torch.probes import card_line, time_ms

# the file's probes (name, form, sizes) and the sizes past the L2
PROBES = (("take_2d(table,1d-idx)", "rows", {"T": 4096, "F": 128, "N": 256}),
          ("take_along_axis sublane", "columns", {"T": 512, "F": 128}),
          ("take_along_axis LANE", "in-rows", {"N": 256, "F": 128}))
PAST_L2 = {"rows": {"T": 1 << 18, "F": 128, "N": 1 << 20},
           "columns": {"T": 1 << 18, "F": 128},
           "in-rows": {"N": 1 << 18, "F": 128}}
KERNELS = {"rows": gather_rows, "columns": gather_columns,
           "in-rows": gather_in_rows}


def operands(form, device="cuda", T=None, F=128, N=None):
    """(source, int32 indices) as the file builds them: values
    ``arange % 997`` (exact integers in float32), indices drawn by
    ``np.random.default_rng(0)`` within the axis they index."""
    dev = resolve_device(device)
    rows = T if form != "in-rows" else N
    src = (torch.arange(rows * F, dtype=torch.int64, device=dev) % 997)
    src = src.to(torch.float32).reshape(rows, F)
    rng = np.random.default_rng(0)
    if form == "rows":
        idx = rng.integers(0, T, N)
    elif form == "columns":
        idx = rng.integers(0, T, (T, F))
    else:
        idx = rng.integers(0, F, (N, F))
    return src, torch.from_numpy(idx.astype(np.int32)).to(dev)


def numpy_reference(form, src, idx):
    s, i = src.cpu().numpy(), idx.cpu().numpy()
    if form == "rows":
        return s[i]
    return np.take_along_axis(s, i, axis=0 if form == "columns" else 1)


def moved_bytes(form, src, idx) -> int:
    """Indices + output + the source values the indices touch, each once."""
    F = src.shape[1]
    if form == "rows":
        touched = torch.unique(idx).numel() * F
    elif form == "columns":
        cols = torch.arange(F, device=idx.device, dtype=torch.int64)
        touched = torch.unique(idx.long() * F + cols).numel()
    else:
        rows = torch.arange(idx.shape[0], device=idx.device, dtype=torch.int64)
        touched = torch.unique(rows[:, None] * F + idx.long()).numel()
    out = idx.numel() * (F if form == "rows" else 1)
    return 4 * (touched + idx.numel() + out)


def probe(form, device="cuda", reps=5, name=None, **size):
    """(max |kernel - numpy|, ms per call, bytes moved) of one gather."""
    src, idx = operands(form, device, **size)
    kernel = KERNELS[form]
    got = kernel(src, idx)
    err = float(np.abs(got.cpu().numpy() - numpy_reference(form, src, idx)).max())
    ms = time_ms(lambda: kernel(src, idx), device, reps=reps)
    moved = moved_bytes(form, src, idx)
    label = name or f"{form} {tuple(src.shape)} x {tuple(idx.shape)}"
    print(f"{label:28s} {'OK  ' if err == 0 else 'FAIL'} max|err|={err}  "
          f"{ms:.4f} ms  {moved / ms / 1e6:.1f} GB/s", flush=True)
    return err, ms, moved


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    print(f"device: {card_line(args.device)}", flush=True)
    errors = [probe(form, args.device, name=name, **size)[0]
              for name, form, size in PROBES]
    errors += [probe(form, args.device, **PAST_L2[form])[0]
               for _, form, _ in PROBES]
    return 0 if max(errors) == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
