"""The 9-tap conv probe: ``probe_conv`` launches ``csrc/probe_conv.cu``.

Replaces the kernels of ``benchmarks/micro_conv2.py:62
bench_pallas_conv_rate`` and ``benchmarks/micro_conv3.py:30
bench_pallas_conv`` (bodies ``kernel_acc`` :43 and ``kernel_concat`` :52),
which measure the rate of one formulation of a 3x3 conv. For x (n, Hb,
W + 2, C) and w (9, C, C) (or the same values as (9 C, C))::

    out[b, h, j] = act(sum_{dy, dx} x[b, h, j + dx] @ w[3 dy + dx])

with the nine taps over the same row: dy only picks the weight, as in the
TPU bodies. int8: int32 sums, ReLU, then the cast to int8, which wraps
modulo 256 (``astype``); bf16: float32 sums, ReLU, bf16 to nearest even.
``order`` "acc9" adds nine tap products, "concat" takes one product of
the (M, 9 C) patches; the kernel's header says what each costs on the
card. CPU tensors take ``probe_conv_plain``.
"""

from __future__ import annotations

import torch

from spnerf_tpu_torch.kernels import _build

ORDERS = ("acc9", "concat")
CHANNELS = (64, 128, 256)  # the kernel's instances
_TYPES = {torch.int8: "int8", torch.bfloat16: "bf16"}
PLAIN_PIXELS = 1 << 17  # output pixels of one step of the plain version


def launch_key(x: torch.Tensor, order: str) -> str:
    return f"probe_conv[{_TYPES[x.dtype]}-{order}-{x.shape[-1]}]"


def _check(x, w, order):
    if x.dim() != 4 or x.dtype not in _TYPES or x.shape[2] < 3:
        raise ValueError(f"probe_conv: x (n, Hb, W + 2, C) int8 or bf16, not "
                         f"{tuple(x.shape)} {x.dtype}")
    C = x.shape[-1]
    if w.dtype != x.dtype or w.numel() != 9 * C * C:
        raise ValueError(f"probe_conv: w (9, {C}, {C}) of x's type, not "
                         f"{tuple(w.shape)} {w.dtype}")
    if order not in ORDERS:
        raise ValueError(f"probe_conv: order {order!r} (one of {ORDERS})")


def int_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact int32 product of int8 (M, K) and (K, N) by ``torch._int_mm``;
    on the card with M padded past 16 rows and b column-major, as cuBLAS
    takes them."""
    m = a.shape[0]
    if not a.is_cuda:
        return torch._int_mm(a.contiguous(), b.contiguous())
    if m <= 16:
        a = torch.nn.functional.pad(a, (0, 0, 0, 32 - m))
    return torch._int_mm(a.contiguous(), b.t().contiguous().t())[:m]


def _wrap_int8(acc: torch.Tensor) -> torch.Tensor:
    """int32 -> int8 modulo 256, as ``astype(int8)``."""
    return (((acc & 255) ^ 128) - 128).to(torch.int8)


def probe_conv_plain(x, w, order="acc9"):
    """Plain version of ``probe_conv``, on any device, in steps of
    ``PLAIN_PIXELS`` output pixels: acc9 adds the nine tap products (each
    rounded to float32 for bf16, as the reference's ``acc +=``), concat
    takes one product of the patches over K = 9 C."""
    _check(x, w, order)
    n, Hb, Wp, C = x.shape
    W = Wp - 2
    w9 = w.reshape(9, C, C)
    rows = x.reshape(n * Hb, Wp, C)
    out = torch.empty((n * Hb, W, C), dtype=x.dtype, device=x.device)
    step = max(1, PLAIN_PIXELS // W)
    for r0 in range(0, n * Hb, step):
        xr = rows[r0:r0 + step]
        taps = [xr[:, t % 3:t % 3 + W].reshape(-1, C) for t in range(9)]
        if x.dtype == torch.int8:
            if order == "acc9":
                acc = sum(int_dot(a, w9[t]) for t, a in enumerate(taps))
            else:
                acc = int_dot(torch.cat(taps, 1), w9.reshape(9 * C, C))
            y = _wrap_int8(torch.clamp_min(acc, 0))
        else:
            if order == "acc9":
                acc = taps[0].float() @ w9[0].float()
                for t in range(1, 9):
                    acc = acc + taps[t].float() @ w9[t].float()
            else:
                acc = torch.cat(taps, 1).float() @ w9.reshape(9 * C, C).float()
            y = torch.clamp_min(acc, 0).to(torch.bfloat16)
        out[r0:r0 + step] = y.reshape(-1, W, C)
    return out.reshape(n, Hb, W, C)


def pack_probe_weights(w: torch.Tensor, C: int) -> torch.Tensor:
    """w (9, C, C) -> the kernel's weight chunks: for each block of BN =
    min(C, 128) output channels, tap and chunk of KC input channels (128
    bytes of K), a KC x BN slab K-major in core matrices of 8 x e values
    (e = 16 bytes of K): element (k, n) at ``((n // 8) * (KC // e) + k //
    e) * 8 e + (n % 8) * e + k % e``, the layout of ``_build.pack_slabs``
    (leading byte offset 128, stride byte offset 8 e KC)."""
    e = 16 // w.element_size()
    kc, bn = min(C, 8 * e), min(C, 128)
    w = w.reshape(9, C // kc, kc // e, e, C // bn, bn // 8, 8)
    return w.permute(4, 0, 1, 5, 2, 6, 3).contiguous()


def probe_conv(x, w, order="acc9"):
    """The probe on the card: x (n, Hb, W + 2, C) int8 or bf16 with C 64,
    128 or 256 (bf16 concat: 64 or 128), w (9, C, C) or (9 C, C) of x's
    type -> (n, Hb, W, C). CPU tensors take the plain version; a CUDA
    tensor launches the kernel or raises."""
    if not x.is_cuda:
        return probe_conv_plain(x, w, order)
    _check(x, w, order)
    n, Hb, Wp, C = x.shape
    bf16 = x.dtype == torch.bfloat16
    if C not in CHANNELS or (bf16 and order == "concat" and C > 128):
        raise ValueError(f"probe_conv: no {order} kernel for "
                         f"{_TYPES[x.dtype]} at C {C}")
    x = x.contiguous()
    wpk = pack_probe_weights(w, C)
    out = torch.empty((n, Hb, Wp - 2, C), dtype=x.dtype, device=x.device)
    _build.check_cuda("probe_conv", x=x, w=wpk, out=out)
    _build.launch("probe_conv", "probe_conv_launch", x, wpk, out, n * Hb,
                  Wp - 2, C, int(bf16), int(order == "concat"))
    _build.launch_counts[launch_key(x, order)] += 1
    return out
