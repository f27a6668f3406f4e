"""A model of the sums of ``csrc/render.cu``'s ``render_f32_kernel``, for
the tests.

The kernel forms each product x @ w of float32 values as three TF32
passes of wgmma m64nNk8 into one accumulator: the tensor cores read the
top 19 bits of a raw float32 word (``trunc``, x cut toward zero to TF32),
and lo = ``tf32_lo`` of each side carries the rest. Per chunk of
CK k-steps lo(x).trunc(w) and trunc(x).lo(w), then trunc(x).trunc(w) over
all of K, each k-step one ``_render_tc.tc_step`` (exact products, cut
toward zero below the largest exponent, the sum rounded toward zero).
The kernel's K order is ``hidden_order``, which permutes units within
each group of 8: a k-step holds the same 8 units either way, and
``tc_step`` does not depend on their order, so the model sums in k order.
"""

import torch

from _render_tc import tc_step

CK = 1  # render.cu kCK: k-steps of a chunk of lo(w)


def hidden_order(width: int) -> torch.Tensor:
    """(width,) int64: the hidden unit that column k of the kernel's A
    operand holds. In k-step s, column 8 s + c carries unit 8 s + 2 (c %
    4) + c // 4: the units a thread's float32 accumulator holds (columns
    8 j + 2 t + {0, 1}) in the slots of its tf32 m64k8 A fragment
    (columns t and t + 4). ``render.prepare_render_f32`` permutes the rows
    of w1, w2 and w3 by it, so the sums are the same."""
    k = torch.arange(width)
    return 8 * (k // 8) + 2 * (k % 4) + (k % 8) // 4


def tf32_lo(x: torch.Tensor) -> torch.Tensor:
    """float32 x -> x - trunc(x) rounded to TF32 (nearest, ties away from
    zero): ``csrc/tf32_tc.cuh`` tf32_lo. x - trunc(x) - tf32_lo(x) is
    within 2^-21 |x|."""
    bits = x.float().contiguous().view(torch.int32)
    rest = x.float() - (bits & ~0x1FFF).view(torch.float32)
    return ((rest.view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)


def trunc(x: torch.Tensor) -> torch.Tensor:
    """float32 -> cut toward zero to TF32 (the low 13 bits cleared)."""
    return (x.float().contiguous().view(torch.int32) & ~0x1FFF).view(
        torch.float32)


def f32_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (M, K) @ w (K, N), float32, as the kernel sums it."""
    x, w = x.float().contiguous(), w.float().contiguous()
    xh, xl, wh, wl = trunc(x), tf32_lo(x), trunc(w), tf32_lo(w)
    acc = torch.zeros((x.shape[0], w.shape[1]), dtype=torch.float32)
    steps = [slice(k, k + 8) for k in range(0, x.shape[1], 8)]
    for c in range(0, len(steps), CK):
        for ks in steps[c:c + CK]:
            acc = tc_step(xl[:, ks], wh[ks], acc)
        for ks in steps[c:c + CK]:
            acc = tc_step(xh[:, ks], wl[ks], acc)
    for ks in steps:
        acc = tc_step(xh[:, ks], wh[ks], acc)
    return acc


def kernel_head(w1, w2, w3):
    """enc, df -> head (M, 4) as render_f32_kernel forms it (float32
    weights; nothing rounded between the products)."""
    w1f, w2f, w3f = w1.float(), w2.float(), w3[:, :4].float()

    def head(enc, df):
        h = torch.relu(f32_matmul(enc, w1f))
        h = torch.relu(f32_matmul(h, w2f) + df)
        return f32_matmul(h, w3f)
    return head
