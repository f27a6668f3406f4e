"""Tensor-core rates on the card: the port of ``benchmarks/mxu_probe.py``.

    python -m spnerf_tpu_torch.probes.mxu_probe [--device cpu]

Three regimes, as in the TPU file:
  1. ``deep_scan``: a chain of ``depth`` (R, K) @ (K, N) bf16 products
     with ReLU, by ``torch.matmul`` (the TPU file scanned it inside one
     jit);
  2. ``square``: one square bf16 ``torch.matmul``;
  3. ``chain``: the dependent chain of ``kernels/probe_chain.py`` (R 8,192
     rows, K = N = 128, depth 32, the same w every layer), bf16 against
     int8, which replaces the file's ``pallas_chain`` (:62): does int8
     beat bf16 on a chain shaped like the render MLPs?
All inputs are ones, as in the TPU file, so the bf16 chain reaches inf
from layer 19 (128^19 > the bf16 range), there as here.
"""

from __future__ import annotations

import argparse

import torch

from spnerf_tpu_torch.device import resolve_device
from spnerf_tpu_torch.kernels.probe_chain import probe_chain
from spnerf_tpu_torch.kernels.probe_conv import int_dot
from spnerf_tpu_torch.probes import card_line, time_ms

DTYPES = {"bf16": torch.bfloat16, "int8": torch.int8}


def deep_scan(R, K, N, depth=384, iters=5, device="cuda"):
    dev = resolve_device(device)
    x = torch.ones((R, K), dtype=torch.bfloat16, device=dev)
    w = torch.ones((depth, K, N), dtype=torch.bfloat16, device=dev)

    def run():
        h = x
        for i in range(depth):
            h = torch.relu(h @ w[i])
        return h

    ms = time_ms(run, dev, reps=iters)
    tflops = 2 * R * K * N * depth / ms / 1e9
    print(f"deep-scan R={R} K={K} N={N} depth={depth}: {tflops:.1f} TFLOP/s",
          flush=True)
    return tflops


def square(M, iters=3, device="cuda"):
    dev = resolve_device(device)
    a = torch.ones((M, M), dtype=torch.bfloat16, device=dev)
    ms = time_ms(lambda: a @ a, dev, reps=iters)
    tflops = 2 * M ** 3 / ms / 1e9
    print(f"square {M}^3: {tflops:.1f} TFLOP/s", flush=True)
    return tflops


def chain_library(x, w, depth):
    """The chain as ``depth`` library products (``torch.matmul``,
    ``torch._int_mm``) with the layer's epilogue."""
    for _ in range(depth):
        if x.dtype == torch.int8:
            x = torch.clamp(int_dot(x, w) >> 7, -127, 127).to(torch.int8)
        else:
            x = torch.relu(x @ w)
    return x


def chain(dtype, depth=32, R=8192, K=128, N=128, iters=20, device="cuda"):
    """TOP/s of the probe kernel's chain on all-ones inputs; (rate, out)."""
    dev = resolve_device(device)
    x = torch.ones((R, K), dtype=DTYPES[dtype], device=dev)
    w = torch.ones((K, N), dtype=DTYPES[dtype], device=dev)
    ms = time_ms(lambda: probe_chain(x, w, depth), dev, reps=iters)
    tops = 2 * R * K * N * depth / ms / 1e9
    print(f"tc-chain {dtype}: {tops:.1f} TOP/s ({ms:.4f} ms)", flush=True)
    return tops, probe_chain(x, w, depth)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    print(f"device: {card_line(args.device)}", flush=True)
    deep_scan(4096, 128, 128, device=args.device)
    deep_scan(16384, 128, 128, depth=96, device=args.device)
    deep_scan(8192, 512, 512, depth=24, device=args.device)
    square(8192, device=args.device)
    chain("bf16", device=args.device)
    chain("int8", device=args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
