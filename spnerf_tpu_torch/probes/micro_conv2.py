"""Matmul rates of the library and the 9-tap conv probe's rate on the card:
the port of ``benchmarks/micro_conv2.py``.

    python -m spnerf_tpu_torch.probes.micro_conv2 [--device cpu]

``bench_scan_matmul`` times one (M, K) @ (K, N) product (``torch.matmul``
in bf16, ``torch._int_mm`` in int8) where the TPU file scanned 24 of them
inside one jit; ``bench_conv_rate`` times ``kernels/probe_conv.py``'s
acc9 kernel, which replaces the file's Pallas kernel
(``bench_pallas_conv_rate``, :62): nine tap products over the same rows,
int8 or bf16, at C 64 and 128 on 480 bands of 8 x 640 and C 256 at W 320.
Each line gives ms per call and GMAC/s, and the card's name and power
limit lead the output.
"""

from __future__ import annotations

import argparse
import itertools

import torch

from spnerf_tpu_torch.device import resolve_device
from spnerf_tpu_torch.kernels.probe_conv import int_dot, probe_conv
from spnerf_tpu_torch.probes import card_line, generator, time_ms

DTYPES = {"int8": torch.int8, "bf16": torch.bfloat16}


def conv_operands(C, dtype, Hb=8, W=640, n=480, device="cuda", seed=0):
    """The probe's seeded x (n, Hb, W + 2, C) and w (9, C, C): int8 in
    [-127, 127), as the TPU file draws them, or bf16 normal values."""
    dev = resolve_device(device)
    gen = generator(dev, seed)
    if dtype == "int8":
        x = torch.randint(-127, 127, (n, Hb, W + 2, C), generator=gen,
                          device=dev, dtype=torch.int8)
        w = torch.randint(-127, 127, (9, C, C), generator=gen, device=dev,
                          dtype=torch.int8)
        return x, w
    x = torch.randn((n, Hb, W + 2, C), generator=gen, device=dev)
    w = torch.randn((9, C, C), generator=gen, device=dev)
    return x.to(torch.bfloat16), w.to(torch.bfloat16)


def bench_scan_matmul(M, K, N, dtype, steps=24, nbuf=4, device="cuda"):
    """GMAC/s of one (M, K) @ (K, N) product, timed over ``steps`` calls
    in a row on ``nbuf`` inputs."""
    dev = resolve_device(device)
    gen = generator(dev, 0)
    if dtype == "int8":
        xs = torch.randint(-127, 127, (nbuf, M, K), generator=gen, device=dev,
                           dtype=torch.int8)
        w = torch.randint(-127, 127, (K, N), generator=gen, device=dev,
                          dtype=torch.int8)
        mm = int_dot
    else:
        xs = torch.randn((nbuf, M, K), generator=gen, device=dev).to(DTYPES[dtype])
        w = torch.randn((K, N), generator=gen, device=dev).to(DTYPES[dtype])
        mm = torch.matmul
    calls = itertools.count()
    ms = time_ms(lambda: mm(xs[next(calls) % nbuf], w), dev, reps=steps)
    gmacs = M * K * N / 1e9
    print(f"matmul {dtype:5s} ({M},{K})@({K},{N}) x{steps}: {ms:8.4f} ms  "
          f"{gmacs / ms * 1e3:8.1f} GMAC/s", flush=True)
    return gmacs / ms * 1e3


def bench_conv_rate(C, dtype, Hb=8, W=640, n=480, device="cuda", iters=5):
    """GMAC/s of the acc9 probe kernel on n bands of Hb x W (the row
    shift of each tap over the same rows; no halo rows)."""
    x, w = conv_operands(C, dtype, Hb, W, n, device)
    ms = time_ms(lambda: probe_conv(x, w, "acc9"), device, reps=iters)
    gmacs = n * Hb * W * 9 * C * C / 1e9
    print(f"conv-probe {dtype:5s} C={C:3d} ({n} bands of {Hb}x{W}): "
          f"{ms:8.4f} ms  {gmacs / ms * 1e3:8.1f} GMAC/s", flush=True)
    return gmacs / ms * 1e3


# the conv cases of the TPU file's main(): (C, W)
CONV_CASES = ((128, 640), (64, 640), (256, 320))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    print(f"device: {card_line(args.device)}", flush=True)
    M = 1 << 18
    for dt in ("bf16", "int8"):
        bench_scan_matmul(M, 128, 128, dt, device=args.device)
        bench_scan_matmul(M, 64, 64, dt, device=args.device)
        bench_scan_matmul(M // 2, 576, 64, dt, device=args.device)
        bench_scan_matmul(M // 2, 1152, 128, dt, device=args.device)
    for dt in ("bf16", "int8"):
        for C, W in CONV_CASES:
            bench_conv_rate(C, dt, W=W, device=args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
