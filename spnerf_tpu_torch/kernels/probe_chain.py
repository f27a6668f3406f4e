"""The dependent-chain probe: ``probe_chain`` launches ``csrc/probe_chain.cu``.

Replaces the kernel of ``benchmarks/mxu_probe.py:62 pallas_chain``:
``depth`` products of x (R, 128) with the same w (128, 128)::

    int8: x <- clip(x @ w >> 7, -127, 127)    (int32 sums, arithmetic shift)
    bf16: x <- bf16(relu(x @ w))              (float32 sums, nearest even)

CPU tensors take ``probe_chain_plain``.
"""

from __future__ import annotations

import torch

from spnerf_tpu_torch.kernels import _build
from spnerf_tpu_torch.kernels.probe_conv import int_dot

K = 128  # K = N of the chain
_TYPES = {torch.int8: "int8", torch.bfloat16: "bf16"}


def launch_key(x: torch.Tensor) -> str:
    return f"probe_chain[{_TYPES[x.dtype]}]"


def _check(x, w, depth):
    if x.dim() != 2 or x.shape[1] != K or x.dtype not in _TYPES:
        raise ValueError(f"probe_chain: x (R, {K}) int8 or bf16, not "
                         f"{tuple(x.shape)} {x.dtype}")
    if tuple(w.shape) != (K, K) or w.dtype != x.dtype:
        raise ValueError(f"probe_chain: w ({K}, {K}) of x's type, not "
                         f"{tuple(w.shape)} {w.dtype}")
    if depth < 1:
        raise ValueError(f"probe_chain: depth {depth} (at least 1)")


def probe_chain_plain(x, w, depth):
    """Plain version of ``probe_chain``, on any device."""
    _check(x, w, depth)
    for _ in range(depth):
        if x.dtype == torch.int8:
            x = torch.clamp(int_dot(x, w) >> 7, -127, 127).to(torch.int8)
        else:
            x = torch.clamp_min(x.float() @ w.float(), 0).to(torch.bfloat16)
    return x


def probe_chain(x, w, depth):
    """The chain on the card: x (R, 128), w (128, 128), both int8 or both
    bf16 -> (R, 128) after ``depth`` layers. CPU tensors take the plain
    version; a CUDA tensor launches the kernel or raises."""
    if not x.is_cuda:
        return probe_chain_plain(x, w, depth)
    _check(x, w, depth)
    x, w = x.contiguous(), w.contiguous()
    out = torch.empty_like(x)
    _build.check_cuda("probe_chain", x=x, w=w, out=out)
    _build.launch("probe_chain", "probe_chain_launch", x, w, out, x.shape[0],
                  depth, int(x.dtype == torch.bfloat16))
    _build.launch_counts[launch_key(x)] += 1
    return out
