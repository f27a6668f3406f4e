"""The ``[probes]`` phase of ``chip_smoke.py``: the H100 probes P1-P4
(``spnerf_tpu_torch/probes/``) and their kernels on the card.

The drive: with the launch counters at 0, the kernel measurements of the
four probe modules' ``main()`` at their shapes (``micro_conv2``'s six
conv cases, ``micro_conv3``'s nine, ``mxu_probe``'s two chains,
``gather_probe``'s three gathers at the file's sizes and past the L2),
each timed over ``ITERS`` calls after a warm-up, as the modules print
them; then the counters are read. The library yardsticks of those
modules (matmul rates, conv1's forms, the deep scan) are no kernel of
ours and are not driven here.

Then one row for each kernel instance at the first drive shape that
launched it: the kernel against its plain version on the card, a second
launch bit-equal to the first, ms (CUDA events around one call, median
of ``REPS``), device ms (``torch.profiler``, the kernel's symbol), the
plain version's ms, the library call's, and the bound. The comparisons:
- int8 conv, int8 chain and the gathers: bit-equal (int32 sums are
  exact in any order; a gather copies values).
- bf16 conv: every value within 1 bf16 ulp at the larger of the two
  values, floored at 2^-8 of the largest output (``bf16_ulps``). Both
  sides sum the same exact bf16 products in float32, only in other
  orders: they differ by a few float32 ulps of the sum of |products|,
  far below a bf16 ulp at the floor, so a value can only land on the
  other side of one rounding boundary.
- bf16 chain, on the file's all-ones inputs: bit-equal, inf included
  (every value is a power of two, exact in any order, until layer 19
  overflows to inf on both sides). On seeded inputs (w of spectral norm
  about 1, ``chain_operands``) at depth 1 within 1 bf16 ulp as the conv,
  and at depth 32 within ``depth * 2^-9`` in norm relative to the plain
  version's output: each layer can move a value by at most one rounding
  (2^-9 relative each side), and a map of norm <= 1 does not grow what
  the layers before it moved.
Any failure raises; nothing falls back to the CPU.
"""

from __future__ import annotations

import math
import time

import torch
import torch.nn.functional as F

from spnerf_tpu_torch.kernels import _build
from spnerf_tpu_torch.kernels.probe_chain import (
    probe_chain,
    probe_chain_plain,
)
from spnerf_tpu_torch.kernels.probe_conv import (
    launch_key,
    probe_conv,
    probe_conv_plain,
)
from spnerf_tpu_torch.kernels import probe_chain as chain_mod
from spnerf_tpu_torch.kernels import probe_gather
from spnerf_tpu_torch.probes import gather_probe, micro_conv2, micro_conv3, mxu_probe
from spnerf_tpu_torch.tools.kernel_times import _events_ms, device_ms

ITERS = 3  # timed calls of each probe in the drive
REPS = 20  # calls of each timing of a row
SOURCES = {"conv": "spnerf_tpu_torch/kernels/csrc/probe_conv.cu",
           "chain": "spnerf_tpu_torch/kernels/csrc/probe_chain.cu",
           "gather": "spnerf_tpu_torch/kernels/csrc/probe_gather.cu"}
REPLACES = {"acc9": "benchmarks/micro_conv2.py:62",
            "concat": "benchmarks/micro_conv3.py:30",
            "chain": "benchmarks/mxu_probe.py:62",
            "gather": "benchmarks/mosaic_gather_probe.py:34"}
BF16_FLOOR = 2.0 ** -8
CHAIN_DEPTH, CHAIN_ROWS = 32, 8192  # mxu_probe.chain's defaults
CHAIN_ULP = 2.0 ** -9  # relative bound of one rounding, each side


def log(msg: str) -> None:
    print(msg, flush=True)


def bf16_ulps(got: torch.Tensor, want: torch.Tensor,
              floor: float = BF16_FLOOR) -> float:
    """Largest distance in bf16 ulps at the larger of the two values,
    floored at ``floor`` times the largest finite |want|; values with
    equal bits (inf and NaN among them) count 0."""
    same = got.view(torch.int16) == want.view(torch.int16)
    g, w = got.float(), want.float()
    if not bool(torch.isfinite(g[~same]).all() & torch.isfinite(w[~same]).all()):
        return math.inf
    finite = w[torch.isfinite(w)]
    top = float(finite.abs().max()) if finite.numel() else 0.0
    mag = torch.clamp_min(torch.maximum(g.abs(), w.abs()), max(floor * top, 1e-30))
    d = (g - w).abs() / torch.exp2(torch.floor(torch.log2(mag)) - 7)
    return float(torch.where(same, 0.0, d).max()) if d.numel() else 0.0


def chain_rel_error(got: torch.Tensor, want: torch.Tensor) -> float:
    """||got - want|| / ||want|| in float64 (inf where the infinities or
    NaNs differ)."""
    g, w = got.double(), want.double()
    if not torch.equal(torch.isfinite(g), torch.isfinite(w)):
        return math.inf
    ok = torch.isfinite(w)
    return float((g[ok] - w[ok]).norm() / w[ok].norm().clamp_min(1e-300))


def chain_operands(dtype, R=CHAIN_ROWS, device="cuda", seed=5):
    """Seeded chain operands that stay finite: int8 x in [-127, 127], w in
    [-8, 8]; bf16 x normal, w normal / (2 sqrt(128)), of spectral norm
    about 1."""
    gen = torch.Generator(device=device).manual_seed(seed)
    K = chain_mod.K
    if dtype == "int8":
        x = torch.randint(-127, 128, (R, K), generator=gen, device=device,
                          dtype=torch.int8)
        w = torch.randint(-8, 9, (K, K), generator=gen, device=device,
                          dtype=torch.int8)
        return x, w
    x = torch.randn((R, K), generator=gen, device=device)
    w = torch.randn((K, K), generator=gen, device=device) / (2 * math.sqrt(K))
    return x.to(torch.bfloat16), w.to(torch.bfloat16)


def check_equal_bits(name, a, b):
    if a.shape != b.shape or a.dtype != b.dtype or not torch.equal(
            a.contiguous().view(torch.uint8), b.contiguous().view(torch.uint8)):
        raise AssertionError(f"{name}: results differ in their bits")


def check(name, got, want):
    """The row's comparison (module docstring); returns max |got - want|
    over the finite values."""
    if got.dtype == torch.bfloat16:
        ulps = bf16_ulps(got, want)
        if ulps > 1.0:
            raise AssertionError(f"{name}: bf16 values {ulps} ulps apart")
    else:
        check_equal_bits(name, got, want)
    d = (got.double() - want.double()).abs()
    d = d[torch.isfinite(d)]
    return float(d.max()) if d.numel() else 0.0


def drive() -> tuple:
    """The probes' kernel measurements at their modules' shapes, with the
    counters at 0 before; (launch counts, gather max errors)."""
    _build.launch_counts.clear()
    for dt in ("bf16", "int8"):
        for C, W in micro_conv2.CONV_CASES:
            micro_conv2.bench_conv_rate(C, dt, W=W, iters=ITERS)
    for concat in (False, True):
        label = "concat" if concat else "acc9"
        for C, dt, Hb, W in micro_conv3.CONV_CASES:
            micro_conv3.bench_conv(C, dt, Hb=Hb, W=W, concat=concat,
                                   label=label, iters=ITERS)
    micro_conv3.bench_conv(128, "int8", Hb=32, concat=True, label="concat",
                           iters=ITERS)
    for dt in ("bf16", "int8"):
        mxu_probe.chain(dt, iters=ITERS)
    errors = [gather_probe.probe(form, reps=ITERS, name=name, **size)[0]
              for name, form, size in gather_probe.PROBES]
    errors += [gather_probe.probe(form, reps=ITERS, **gather_probe.PAST_L2[form])[0]
               for _, form, _ in gather_probe.PROBES]
    torch.cuda.synchronize()
    return dict(_build.launch_counts), errors


def conv_cases():
    """(dtype, order, C, Hb, W) of each conv instance at the first drive
    shape that launches it."""
    cases, seen = [], set()
    shapes = [(dt, "acc9", C, 8, W) for dt in ("bf16", "int8")
              for C, W in micro_conv2.CONV_CASES]
    shapes += [(dt, order, C, Hb, W) for order in ("acc9", "concat")
               for C, dt, Hb, W in micro_conv3.CONV_CASES]
    for case in shapes:
        if case[:3] not in seen:
            seen.add(case[:3])
            cases.append(case)
    return cases


def _times(fn, plain, lib, symbol):
    ms = _events_ms(fn, REPS, per_call=True)
    dev_ms, how = device_ms(fn, symbol, reps=10)
    plain_ms = _events_ms(plain, 1, per_call=True)
    lib_ms = _events_ms(lib, REPS, per_call=True)
    lib_dev_ms = device_ms(lib, reps=10)[0]
    return ms, dev_ms, how, plain_ms, lib_ms, lib_dev_ms


def _row(name, probe, source, replaces, launches, err, times, bound):
    ms, dev_ms, how, plain_ms, lib_ms, lib_dev_ms = times
    t_ops, t_bytes = bound
    return {"name": name, "probe": probe, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": lib_ms, "device_ms": dev_ms,
            "library_device_ms": lib_dev_ms, "device_ms_by": how}


def _log_row(row, shape, lib_name, extra=""):
    log(f"[kernel] {row['name']} ({row['probe']}): {shape}, max_abs_err "
        f"{row['max_abs_err']}{extra}, kernel {row['ms']:.4f} ms (median of "
        f"{REPS}; device {row['device_ms']:.4f} ms by {row['device_ms_by']}), "
        f"plain {row['plain_ms']:.4f} ms, library {lib_name} "
        f"{row['library_ms']:.4f} ms (device {row['library_device_ms']:.4f}), "
        f"bound {row['bound_ms']:.4f} ms ({row['bound_by']}), "
        f"{row['launches']} launches in the drive")


def conv_row(dtype, order, C, Hb, W, counts, peaks, n=480):
    x, w9 = micro_conv2.conv_operands(C, dtype, Hb, W, n)
    w = w9.reshape(9 * C, C) if order == "concat" else w9
    key = launch_key(x, order)
    got = probe_conv(x, w, order)
    check_equal_bits(f"{key} second launch", probe_conv(x, w, order), got)
    err = check(key, got, probe_conv_plain(x, w, order))
    patch_ms = None
    if dtype == "int8":  # _int_mm over the (M, 9 C) patches, built apart
        rows = x.reshape(n * Hb, W + 2, C)

        def patches():
            return torch.cat([rows[:, t % 3:t % 3 + W] for t in range(9)],
                             -1).reshape(-1, 9 * C)

        patch_ms = _events_ms(patches, 3, per_call=True)
        p, wc = patches(), w9.reshape(9 * C, C).t().contiguous().t()
        lib, lib_name = (lambda: torch._int_mm(p, wc)), "_int_mm of the patches"
    else:  # F.conv2d by the (1, 3) kernel of the weights summed over dy
        xc = x.permute(0, 3, 1, 2)  # channels-last NCHW, no copy
        wk = w9.float().reshape(3, 3, C, C).sum(0).permute(2, 1, 0)[:, :, None]
        wk = wk.to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
        lib, lib_name = (lambda: F.conv2d(xc, wk)), "F.conv2d (1, 3)"
    times = _times(lambda: probe_conv(x, w, order),
                   lambda: probe_conv_plain(x, w, order), lib, "probe_conv_kernel")
    rate = peaks[0] if dtype == "int8" else peaks[3]
    moved = (x.numel() + w.numel() + got.numel()) * x.element_size()
    row = _row(key, "P1" if order == "acc9" else "P2", SOURCES["conv"],
               REPLACES[order], counts.get(key, 0), err, times,
               (2 * n * Hb * W * 9 * C * C / rate * 1e3, moved / peaks[1] * 1e3))
    row["shape"] = [n, Hb, W + 2, C]
    row["patch_ms"] = patch_ms
    _log_row(row, f"x {tuple(x.shape)} {dtype} {order}", lib_name,
             "" if patch_ms is None else f" (patches {patch_ms:.4f} ms)")
    return row


def chain_row(dtype, counts, peaks):
    dt = mxu_probe.DTYPES[dtype]
    ones = torch.ones((CHAIN_ROWS, chain_mod.K), dtype=dt, device="cuda")
    w1 = torch.ones((chain_mod.K, chain_mod.K), dtype=dt, device="cuda")
    key = chain_mod.launch_key(ones)
    got = probe_chain(ones, w1, CHAIN_DEPTH)
    check_equal_bits(f"{key} second launch", probe_chain(ones, w1, CHAIN_DEPTH), got)
    check_equal_bits(f"{key} all ones", got, probe_chain_plain(ones, w1, CHAIN_DEPTH))
    x, w = chain_operands(dtype)
    err = check(f"{key} depth 1", probe_chain(x, w, 1), probe_chain_plain(x, w, 1))
    deep, want = probe_chain(x, w, CHAIN_DEPTH), probe_chain_plain(x, w, CHAIN_DEPTH)
    if dtype == "int8":
        check_equal_bits(f"{key} depth {CHAIN_DEPTH}", deep, want)
        rel = 0.0
    else:
        rel = chain_rel_error(deep, want)
        if not rel <= CHAIN_DEPTH * CHAIN_ULP:
            raise AssertionError(f"{key}: depth {CHAIN_DEPTH} relative error "
                                 f"{rel} (bound {CHAIN_DEPTH * CHAIN_ULP})")
    times = _times(lambda: probe_chain(ones, w1, CHAIN_DEPTH),
                   lambda: probe_chain_plain(ones, w1, CHAIN_DEPTH),
                   lambda: mxu_probe.chain_library(ones, w1, CHAIN_DEPTH),
                   "probe_chain_kernel")
    rate = peaks[0] if dtype == "int8" else peaks[3]
    moved = (2 * ones.numel() + w1.numel()) * ones.element_size()
    ops = 2 * CHAIN_ROWS * chain_mod.K ** 2 * CHAIN_DEPTH
    row = _row(key, "P3", SOURCES["chain"], REPLACES["chain"],
               counts.get(key, 0), err, times,
               (ops / rate * 1e3, moved / peaks[1] * 1e3))
    row["shape"] = [CHAIN_ROWS, chain_mod.K, CHAIN_DEPTH]
    row["seeded_rel_error"] = rel
    _log_row(row, f"x ({CHAIN_ROWS}, {chain_mod.K}) {dtype}, depth "
             f"{CHAIN_DEPTH}, all ones (the file's) bit-equal", "depth x matmul",
             f" at depth 1 on seeded inputs, seeded depth-{CHAIN_DEPTH} "
             f"relative error {rel:.3e}")
    return row


LIBRARY_GATHERS = {
    "rows": lambda s, i: torch.index_select(s, 0, i),
    "columns": lambda s, i: torch.gather(s, 0, i),
    "in-rows": lambda s, i: torch.gather(s, 1, i)}
PLAIN_GATHERS = {"rows": probe_gather.gather_rows_plain,
                 "columns": probe_gather.gather_columns_plain,
                 "in-rows": probe_gather.gather_in_rows_plain}


def gather_row(form, size, counts, peaks):
    src, idx = gather_probe.operands(form, "cuda", **size)
    kernel, key = gather_probe.KERNELS[form], probe_gather.launch_key(form)
    got = kernel(src, idx)
    check_equal_bits(f"{key} second launch", kernel(src, idx), got)
    err = check(key, got, PLAIN_GATHERS[form](src, idx))
    idx64 = idx.long()
    times = _times(lambda: kernel(src, idx), lambda: PLAIN_GATHERS[form](src, idx),
                   lambda: LIBRARY_GATHERS[form](src, idx64), "gather_")
    moved = gather_probe.moved_bytes(form, src, idx)
    row = _row(key, "P4", SOURCES["gather"], REPLACES["gather"],
               counts.get(key, 0), err, times, (0.0, moved / peaks[1] * 1e3))
    row["shape"] = [list(src.shape), list(idx.shape)]
    row["moved_bytes"] = moved
    _log_row(row, f"source {tuple(src.shape)}, indices {tuple(idx.shape)}, "
             f"{moved / 1e6:.1f} MB moved ({moved / row['device_ms'] / 1e6:.1f} "
             "GB/s on the device)", "index_select / gather")
    return row


def phase_probes(peaks) -> list:
    """The drive, then one checked and timed row per kernel instance;
    raises if a check fails or an instance never launched in the drive.
    ``peaks``: chip_smoke's (int8 op/s, bytes/s, float32 op/s, bf16
    op/s)."""
    t0 = time.perf_counter()
    counts, errors = drive()
    log(f"[probes] drive: launches {dict(sorted(counts.items()))}")
    if max(errors) != 0:
        raise AssertionError(f"[probes] a gather differs from numpy: {errors}")
    rows = []
    for case in conv_cases():
        rows.append(conv_row(*case, counts, peaks))
        torch.cuda.empty_cache()
    for dtype in ("bf16", "int8"):
        rows.append(chain_row(dtype, counts, peaks))
    for _, form, size in gather_probe.PROBES:
        rows.append(gather_row(form, size, counts, peaks))
        rows.append(gather_row(form, gather_probe.PAST_L2[form], counts, peaks))
        torch.cuda.empty_cache()
    missing = sorted({r["name"] for r in rows if not r["launches"]})
    if missing:
        raise AssertionError(f"[probes] never launched in the drive: {missing}")
    torch.cuda.empty_cache()
    log(f"[probes] {len(rows)} kernel rows; the phase took "
        f"{time.perf_counter() - t0:.1f} s")
    return rows
