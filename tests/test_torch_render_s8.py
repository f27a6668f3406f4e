"""The int8 render on the int8 tensor cores (``csrc/render.cu``,
render_s8_kernel): its hidden-unit order and prepared operands, by index
models of the wgmma register layouts and by the kernel's MLP in the
permuted order, against ``int8_mlp_head`` and the JAX package.

The kernel's A fragment of k-step s holds, in register 2 e + h byte i of
lane 4 g + t, row g + 8 h at column 32 s + 16 e + 4 t + i; its m64n128
s32 accumulator register 4 j + 2 h + i holds row g + 8 h at column
8 j + 2 t + i. Its epilogue packs accumulator registers b + 2 h + {0, 1}
and b + 4 + 2 h + {0, 1} (b = 16 s + 8 e) into fragment register 2 e + h
of k-step s. Tolerances: int32 sums exact, the MLP equal to the bit; the
render against the Pallas kernel as ``tests/test_torch_render.py`` holds
it (an encoding or a requantization one step apart: 1e-2 and 3e-2).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spnerf_tpu.kernels import render_pallas as jrp
from spnerf_tpu_torch.kernels import render as trk
from test_torch_render import INT8_TOL, _both, _close, _encoded


def _epilogue_slots():
    """(lane t, k-step s, register 2 e + h, byte i) -> accumulator
    register of render_s8_kernel's epilogue."""
    out = {}
    for s in range(4):
        for e in range(2):
            b = 16 * s + 8 * e
            for h in range(2):
                regs = (b + 2 * h, b + 2 * h + 1, b + 4 + 2 * h, b + 5 + 2 * h)
                for i, r in enumerate(regs):
                    out[(s, 2 * e + h, i)] = r
    return out


def test_hidden_order_permutes_each_group_of_32():
    order = trk.s8_hidden_order()
    assert order.dtype == torch.int64 and order.shape == (128,)
    for s in range(4):
        group = order[32 * s:32 * s + 32]
        assert sorted(group.tolist()) == list(range(32 * s, 32 * s + 32))


@pytest.mark.parametrize("t", range(4))
def test_accumulator_feeds_the_threads_own_fragment_slots(t):
    """Every accumulator register of lane t lands in one slot of the same
    lane's A fragments, in the same row, at a column whose hidden unit
    (``s8_hidden_order``) is the register's column."""
    order = trk.s8_hidden_order().tolist()
    slots = _epilogue_slots()
    assert sorted(slots.values()) == list(range(64))
    for (s, reg, i), r in slots.items():
        e, h = reg // 2, reg % 2
        j, h_acc, i_acc = r // 4, (r % 4) // 2, r % 2
        assert h_acc == h  # row g + 8 h on both sides
        k = 32 * s + 16 * e + 4 * t + i  # the fragment slot's column
        assert order[k] == 8 * j + 2 * t + i_acc


def _unpack_b(w, n):
    """The (128, n) int8 matrix of a ``pack_slabs`` B operand."""
    return w.reshape(n // 8, 8, 8, 16).permute(1, 3, 0, 2).reshape(128, n)


def _qfield(seed=3):
    rng = np.random.default_rng(seed)
    q = {k: rng.integers(-127, 128, (128, 128)).astype(np.int8)
         for k in ("qw1", "qw2", "qw3")}
    q["m1"] = rng.uniform(2e-4, 6e-4, 128).astype(np.float32)
    q["m2"] = rng.uniform(1e-4, 4e-4, 128).astype(np.float32)
    q["r3"] = rng.uniform(1e-5, 5e-5, 128).astype(np.float32)
    q["ia2"] = np.float32(3.7)
    return q


def test_prepared_operands_reorder_rows_only():
    ops = trk.prepare_render_int8(_qfield(), "cpu")
    order = trk.s8_hidden_order()
    q = ops.q
    assert all(w.dtype == torch.int8 and w.is_contiguous()
               for w in (ops.w1b, ops.w2b, ops.w3b))
    assert torch.equal(_unpack_b(ops.w1b, 128), q["qw1"])
    assert torch.equal(_unpack_b(ops.w2b, 128), q["qw2"][order])
    w3 = _unpack_b(ops.w3b, 8)
    assert torch.equal(w3[:, 0::2], q["qw3"][order, :4])
    assert not w3[:, 1::2].any()
    assert torch.equal(ops.r3, q["r3"][:4]) and ops.ia2 == np.float32(3.7)


def test_permuted_operands_give_the_same_int32_sums():
    """h @ qw2 (and the head) from the permuted activations and rows:
    every int32 sum equal."""
    ops = trk.prepare_render_int8(_qfield(), "cpu")
    order = trk.s8_hidden_order()
    h = torch.from_numpy(np.random.default_rng(4).integers(
        0, 128, (96, 128))).to(torch.int64)
    for w, want in ((ops.w2b, ops.q["qw2"]), (ops.w3b, ops.q["qw3"][:, :4])):
        n = w.numel() // 128
        got = h[:, order] @ _unpack_b(w, n).to(torch.int64)
        if n == 8:
            got = got[:, 0::2]
        assert torch.equal(got, h @ want.to(torch.int64))


def _kernel_mlp(ops):
    """The kernel's MLP in float32 ops on the prepared operands: the
    encoding's columns as they are, both hidden layers' activations in
    the permuted order (fragment slots), the epilogues on unpermuted
    units."""
    order = trk.s8_hidden_order()
    w1 = _unpack_b(ops.w1b, 128).float()
    w2 = _unpack_b(ops.w2b, 128).float()
    w3 = _unpack_b(ops.w3b, 8).float()[:, 0::2]

    def head(enc, df):
        e = torch.round(enc * 127.0)
        h = torch.round(torch.clamp(torch.relu(e @ w1) * ops.m1, 0.0, 127.0))
        acc = h[:, order] @ w2
        h = torch.relu(acc * ops.m2 + df * ops.ia2)
        h = torch.round(torch.clamp(h, 0.0, 127.0))
        return (h[:, order] @ w3) * ops.r3
    return head


def test_kernel_mlp_in_the_permuted_order_equals_int8_mlp_head():
    """Through the committed-style quantization of a seeded field: the
    head of every (ray, sample) row equal to ``int8_mlp_head``'s."""
    jcfg, jp, tcfg, tp, o, d = _both(128, 8)
    oe, de, df = _encoded(tcfg, tp, o, d, "torch")
    qf = trk.quantize_field({k: np.asarray(v) for k, v in jp.items()},
                            oe.numpy(), de.numpy(), df.numpy(), n_samples=8,
                            near=2.0, far=6.0)
    ops = trk.prepare_render_int8(qf, "cpu")
    want_fn, got_fn = trk.int8_mlp_head(ops.q), _kernel_mlp(ops)
    for t_s in (2.25, 4.0625, 5.75):
        enc = torch.sin(oe + t_s * de)
        want, got = want_fn(enc, df), got_fn(enc, df)
        assert float(want.abs().max()) > 0
        assert torch.equal(got, want)


@pytest.mark.parametrize("case", ["dense", "flags"])
def test_prepared_render_equals_dict_route_and_pallas(case):
    """``render_fused_int8`` given ``RenderInt8Operands`` equals the dict
    route (the same plain version on the CPU) and the JAX package's
    ``render_fused_int8`` in interpret mode within ``INT8_TOL``."""
    jcfg, jp, tcfg, tp, o, d = _both(128, 8)
    joe, jde, jdf = _encoded(jcfg, jp, o, d, "jax")
    toe, tde, tdf = _encoded(tcfg, tp, o, d, "torch")
    qf = trk.quantize_field({k: np.asarray(v) for k, v in jp.items()},
                            np.asarray(joe), np.asarray(jde), np.asarray(jdf),
                            n_samples=8, near=2.0, far=6.0)
    flags = None
    if case == "flags":
        flags = np.array([[1, 0], [1, 1], [0, 1], [1, 1], [0, 0]], np.int32)
    kw = dict(n_samples=8, near=2.0, far=6.0, block=8, s_chunk=4,
              early_stop_eps=0.0)
    tflags = None if flags is None else torch.from_numpy(flags)
    ops = trk.prepare_render_int8(qf, "cpu")
    got = trk.render_fused_int8(toe, tde, ops, tdf, flags=tflags, **kw)
    by_dict = trk.render_fused_int8(toe, tde, qf, tdf, flags=tflags, **kw)
    assert torch.equal(got[0], by_dict[0]) and torch.equal(got[1], by_dict[1])
    want = jrp.render_fused_int8(
        joe, jde, qf, jdf, interpret=True,
        flags=None if flags is None else jnp.asarray(flags), **kw)
    _close(got, want, *INT8_TOL)
