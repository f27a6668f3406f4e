"""Post-training int8 quantization helpers for the serving conv stack.

Counterpart of ``spnerf_tpu/ops/quantization.py``: per-output-channel
symmetric int8 weights, with float32 arithmetic in the reference's order.
"""

from __future__ import annotations

import torch


def quantize_weights(kernel: torch.Tensor):
    """(kh, kw, cin, cout) float kernel -> (int8 kernel, (cout,) f32
    scales): scale = (absmax + 1e-12) / 127, round half to even, clip to
    +-127."""
    kernel = kernel.float()
    absmax = kernel.abs().amax(dim=(0, 1, 2)) + 1e-12
    scale = absmax / 127.0
    q = torch.clamp(torch.round(kernel / scale), -127, 127).to(torch.int8)
    return q, scale
