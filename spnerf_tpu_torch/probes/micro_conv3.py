"""Tap order of the conv probe, and conv1's formulations, on the card: the
port of ``benchmarks/micro_conv3.py``.

    python -m spnerf_tpu_torch.probes.micro_conv3 [--device cpu]

``bench_conv`` times ``kernels/probe_conv.py``, which replaces the file's
Pallas kernels (``bench_pallas_conv``, :30): acc9 (nine accumulated tap
products over shifted views of a resident input tile, ``kernel_acc``
:43) against concat (one product of the (M, 9 C) patches, each K chunk
of them a copy of the input at its tap's offset streamed into shared
memory, ``kernel_concat`` :52), over row bands of 8, 16 and 32; both
orders run every C and type. ``bench_conv1`` times the C_in = 1
first conv of SuperPoint (batch 64, 480 x 640, 64 channels, bf16) four
ways, as the file did through XLA: ``F.conv2d`` channels-last
(``xla_nhwc`` there) and NCHW (``xla_nchw``), and nine fused
multiply-adds in float32 (``fma``, ``fma_packed``: the same, its output
seen as 128 lanes).
"""

from __future__ import annotations

import argparse

import torch
import torch.nn.functional as F

from spnerf_tpu_torch.device import resolve_device
from spnerf_tpu_torch.kernels.probe_conv import probe_conv
from spnerf_tpu_torch.probes import card_line, generator, time_ms
from spnerf_tpu_torch.probes.micro_conv2 import conv_operands


def bench_conv(C, dtype, Hb=8, W=640, n=480, concat=False, label="",
               device="cuda", iters=5):
    """GMAC/s of the probe kernel in one tap order; concat takes the
    weights as the TPU file did, (9 C, C)."""
    x, w9 = conv_operands(C, dtype, Hb, W, n, device)
    w = w9.reshape(9 * C, C) if concat else w9
    order = "concat" if concat else "acc9"
    ms = time_ms(lambda: probe_conv(x, w, order), device, reps=iters)
    gmacs = n * Hb * W * 9 * C * C / 1e9
    print(f"pconv {label:8s} {dtype:5s} C={C:3d} Hb={Hb:2d}: {ms:8.4f} ms  "
          f"{gmacs / ms * 1e3:8.1f} GMAC/s", flush=True)
    return gmacs / ms * 1e3


CONV1_MODES = ("conv2d_nhwc", "conv2d_nchw", "fma", "fma_packed")


def conv1(x, k, mode):
    """relu(3x3 SAME conv) of (B, H, W, 1) bf16 images by (3, 3, 1, 64)
    bf16 taps -> (B, H, W, 64) bf16 ((B, H, W / 2, 128) for fma_packed)."""
    B, H, W, _ = x.shape
    if mode.startswith("conv2d"):
        wt = k.permute(3, 2, 0, 1).contiguous()  # (64, 1, 3, 3)
        xt = x.permute(0, 3, 1, 2)
        if mode == "conv2d_nhwc":
            xt = xt.contiguous(memory_format=torch.channels_last)
            wt = wt.contiguous(memory_format=torch.channels_last)
        else:
            xt = xt.contiguous()
        return torch.relu(F.conv2d(xt, wt, padding=1)).permute(0, 2, 3, 1)
    xp = F.pad(x[..., 0], (1, 1, 1, 1))
    acc = torch.zeros((B, H, W, 64), dtype=torch.float32, device=x.device)
    for dy in range(3):
        for dx in range(3):
            acc += xp[:, dy:dy + H, dx:dx + W, None].float() * k[dy, dx, 0].float()
    y = torch.clamp_min(acc, 0).to(torch.bfloat16)
    return y.reshape(B, H, W // 2, 128) if mode == "fma_packed" else y


def bench_conv1(mode, B=64, H=480, W=640, device="cuda", iters=5):
    dev = resolve_device(device)
    gen = generator(dev, 0)
    x = torch.randn((B, H, W, 1), generator=gen, device=dev).to(torch.bfloat16)
    k = torch.randn((3, 3, 1, 64), generator=gen, device=dev).to(torch.bfloat16)
    ms = time_ms(lambda: conv1(x, k, mode), dev, reps=iters)
    print(f"conv1 {mode:12s}: {ms:8.3f} ms/batch{B}", flush=True)
    return ms


# the conv cases of the TPU file's main(): (C, dtype, Hb, W), each in both
# tap orders, then int8 at Hb 32 in concat alone
CONV_CASES = ((128, "int8", 8, 640), (128, "int8", 16, 640),
              (128, "bf16", 16, 640), (256, "int8", 16, 320))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    print(f"device: {card_line(args.device)}", flush=True)
    for concat in (False, True):
        label = "concat" if concat else "acc9"
        for C, dt, Hb, W in CONV_CASES:
            bench_conv(C, dt, Hb=Hb, W=W, concat=concat, label=label,
                       device=args.device)
    bench_conv(128, "int8", Hb=32, concat=True, label="concat",
               device=args.device)
    for mode in CONV1_MODES:
        bench_conv1(mode, device=args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
