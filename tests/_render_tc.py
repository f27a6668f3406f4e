"""A model of the sums of ``csrc/render.cu``'s ``render_tc_kernel``, for
the tests.

``tc_step`` is one wgmma k-step of bf16 products to the bit (fitted on an
H100 to 262,144 outputs of the instruction; ``tests/test_torch_cuda.py``
holds it against a wgmma), ``tc_matmul`` a chain of them in k order, as
the kernel forms its products. ``fma_matmul`` sums by float32 FMAs in k
order: the library's order (cuBLAS takes it at the render's shapes, and
the plain version's ``torch.matmul`` on the card with it).
``kernel_head`` is the kernel's MLP: the tensor cores' sums, the test of
each sum against its bound, and FMAs in k order for the undecided ones.
"""

import contextlib

import torch

TC_K = 16  # the k-step of wgmma m64nNk16 with bf16 operands
TC_KEEP = 25  # bits the tensor cores keep below the largest product's exponent
SLACK = 8.0 * 2.0 ** -24  # render.cu kSlack


def _exponents(x: torch.Tensor) -> torch.Tensor:
    """floor(log2 |x|) as int32, -2048 where x is 0."""
    return torch.where(x != 0, torch.frexp(x)[1] - 1, -2048)


def _to_float32_rz(x: torch.Tensor) -> torch.Tensor:
    """float64 -> float32 rounded toward zero."""
    r = x.float()
    over = r.double().abs() > x.abs()
    return torch.where(over, torch.nextafter(r, torch.zeros_like(r)), r)


@contextlib.contextmanager
def one_thread():
    """torch on one thread for the block: the models' operands are small
    (M <= 64 rows a call in the render tests), and on a host that runs
    several test processes at once their thread pools cost several times
    the arithmetic."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def tc_step(a: torch.Tensor, b: torch.Tensor,
            c: torch.Tensor | None) -> torch.Tensor:
    """One k-step of the tensor cores: a (M, 16) and b (16, N) hold bf16
    values (any float dtype), c (M, N) float32 is the running sum or None.
    The 16 products are exact; with e the largest floor(log2 |a_k|) +
    floor(log2 |b_k|) over the nonzero products and floor(log2 |c|), each
    product and c are cut toward zero to a multiple of 2^(e - 25), summed
    exactly, and the sum rounded toward zero to float32."""
    with one_thread():
        return _tc_step(a, b, c)


def _tc_step(a: torch.Tensor, b: torch.Tensor,
             c: torch.Tensor | None) -> torch.Tensor:
    a, b = a.double(), b.double()
    top = (_exponents(a)[:, :, None] + _exponents(b)[None]).amax(1)
    cd = None if c is None else c.double()
    if cd is not None:
        top = torch.maximum(top, _exponents(cd))
    step = torch.ldexp(torch.ones_like(top, dtype=torch.float64),
                       torch.clamp_min(top, -900) - TC_KEEP)
    # bf16 products are exact in float64, and so is their quotient by a
    # power of two in range; 16 cut terms below 2^27 units sum exactly
    units = torch.trunc(a[:, :, None] * b[None] / step[:, None]).sum(1)
    if cd is not None:
        units = units + torch.trunc(cd / step)
    return _to_float32_rz(units * step)


def tc_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (M, K) @ w (K, N) of bf16 values as one wgmma chain of K / 16
    k-steps in k order. float32 (M, N)."""
    out = None
    for k0 in range(0, x.shape[1], TC_K):
        out = tc_step(x[:, k0:k0 + TC_K], w[k0:k0 + TC_K], out)
    return out


def fma_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w by float32 FMAs in k order from 0 (bf16 values: each product
    is exact in float32, so a product and a rounded add are one FMA)."""
    x, w = x.float(), w.float()
    acc = torch.zeros((x.shape[0], w.shape[1]), dtype=torch.float32)
    with one_thread():
        for k in range(x.shape[1]):
            acc = acc + x[:, k:k + 1] * w[k:k + 1]
    return acc


def order_gap(x, w, m) -> float:
    """The largest distance between the tensor cores' sums and the FMA
    order's for x @ w, in units of 2^-24 * m (per row, >= max_k |x_k|) *
    sum_k |w[k][n]| (per column): the kernel's bound is SLACK in those
    units."""
    d = (tc_matmul(x, w) - fma_matmul(x, w)).abs()
    unit = m[:, None] * w.abs().float().sum(0)[None] * 2.0 ** -24
    return float((d / unit.clamp_min(1e-30)).max())


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def _decided(x, w, v, m, relu):
    """The kernel's flag, negated: v - t and v + t round alike, with
    t = SLACK * m (per row) * sum_k |w[k][n]| (per column)."""
    t = m[:, None].double() * (SLACK * w.abs().float().sum(0)).double()
    lo, hi = (v.double() - t).float(), (v.double() + t).float()
    if relu:
        lo, hi = torch.relu(lo), torch.relu(hi)
    return _bf16(lo).view(torch.int32) == _bf16(hi).view(torch.int32)


def kernel_layer(x, w, add=None, relu=True, m=None):
    """One product of the kernel with its epilogue: the tensor cores' sum
    (+ add), and where it is undecided the FMA order's. Returns (bf16
    values as float32 (relu'd if relu), the undecided mask)."""
    v = tc_matmul(x, w)
    if add is not None:
        v = v + add
    if m is None:
        m = x.abs().amax(1)
    keep = _decided(x, w, v, m, relu)
    fix = fma_matmul(x, w)
    if add is not None:
        fix = fix + add
    v = torch.where(keep, v, fix)
    return _bf16(torch.relu(v) if relu else v), ~keep


def kernel_head(w1, w2, w3, round_head: bool):
    """enc, df -> head (M, 4) as render_tc_kernel forms it (bf16 weights);
    the head's ``undecided`` attribute holds the last call's share of
    undecided elements per product."""
    w1f, w2f, w3f = w1.float(), w2.float(), w3[:, :4].float()

    def head(enc, df):
        x = _bf16(enc)
        h, u1 = kernel_layer(x, w1f, m=torch.ones(x.shape[0]))
        h, u2 = kernel_layer(h, w2f, add=df)
        if round_head:
            out, u3 = kernel_layer(h, w3f, relu=False)
        else:
            out, u3 = tc_matmul(h, w3f), torch.zeros(())
        head.undecided = [float(u.float().mean()) for u in (u1, u2, u3)]
        return out
    return head


def fma_head(w1, w2, w3, round_head: bool):
    """``render.float_mlp_head`` with ``fma_matmul`` for its products: the
    library's order on the card, on any device's CPU."""
    w1f, w2f, w3f = w1.float(), w2.float(), w3[:, :4].float()

    def head(enc, df):
        h = _bf16(torch.relu(fma_matmul(_bf16(enc), w1f)))
        h = _bf16(torch.relu(fma_matmul(h, w2f) + df))
        out = fma_matmul(h, w3f)
        return _bf16(out) if round_head else out
    return head
