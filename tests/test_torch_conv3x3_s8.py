"""``conv3x3`` / ``packed_conv3x3`` on operands prepared once
(``prepare_conv3x3``) and the int8 instance on the int8 tensor cores
(``csrc/conv3x3.cu``, conv3x3_s8_kernel): prepared calls against raw
calls and the JAX package's Pallas kernels (interpret mode), the
kernel's A and B addressing by index models, and the serving graph's
per-layer route, which now prepares its operands when it is built.

Tolerances: int8 exact; bf16 outputs within 1 ulp of the JAX kernel
(``tests/test_torch_conv_stack.py``), prepared equal to raw to the bit;
the serving graph against JAX as ``_serving_cases`` bounds it.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _serving_cases as C
from _torch_port import bf16_scaled_ulps, jax_bf16_to_torch
from spnerf_tpu.kernels import conv_stack_pallas as J
from spnerf_tpu_torch.kernels import conv_stack as T

# (wrapper, C_in, C_out, pool): the six instances of the int8 kernel
INSTANCES = {"packed_64-64": ("packed", 64, 64, False),
             "packed_64-64-pool": ("packed", 64, 64, True),
             "packed_64-128": ("packed", 64, 128, False),
             "conv_128-128-pool": ("conv", 128, 128, True),
             "conv_128-128": ("conv", 128, 128, False),
             "conv_128-256": ("conv", 128, 256, False)}
# csrc/conv3x3.cu: the 16 x 16 output tile, its input tile with a
# one-pixel halo in planes of 16 channels, 8 x 8 blocks as M-tiles
OH = OW = 16
IW = OW + 2
PLANE = (OH + 2) * IW * 16


def _jax_conv(op, x, w, m, b, out, pool):
    if op == "packed":
        return J.unpack_pairs(J.packed_conv3x3_pallas(
            J.pack_pairs(x), w, m, b, out_dtype=out, pool=pool))
    return J.conv3x3_pallas(x, w, m, b, out_dtype=out, pool=pool)


@pytest.mark.parametrize("instance", list(INSTANCES))
def test_prepared_int8_equals_raw_and_pallas(instance):
    """At 2 x 8 x 24 (W % 16 == 8): the prepared call equals the raw one
    and the Pallas kernel, ReLU on; the raw call with ReLU off too."""
    op, cin, cout, pool = INSTANCES[instance]
    rng = np.random.default_rng(70 + cin + cout + pool)
    x = rng.integers(0, 128, (2, 8, 24, cin)).astype(np.int8)
    w = rng.integers(-127, 128, (3, 3, cin, cout)).astype(np.int8)
    m = rng.uniform(5e-5, 4e-4, cout).astype(np.float32)
    b = rng.uniform(-20, 20, cout).astype(np.float32)
    fn = T.packed_conv3x3 if op == "packed" else T.conv3x3
    tx, tw, tm, tb = (torch.from_numpy(a) for a in (x, w, m, b))
    ops = T.prepare_conv3x3(tw, tm, tb)
    assert ops.packed is not None and ops.packed.dtype == torch.int8
    got = fn(tx, ops, pool=pool)
    assert torch.equal(got, fn(tx, tw, tm, tb, pool=pool))
    want = _jax_conv(op, jnp.asarray(x), jnp.asarray(w), m, b, jnp.int8, pool)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert 0.05 < float((got != 0).float().mean()) < 0.95
    linear = fn(tx, ops, relu=False, pool=pool)
    assert (linear < 0).any()
    assert torch.equal(linear, T.conv3x3_plain(tx, tw, tm, tb, relu=False,
                                               pool=pool))


@pytest.mark.parametrize("instance", ["packed_64-64-pool", "conv_128-256"])
def test_prepared_bf16_equals_raw_and_pallas(instance):
    op, cin, cout, pool = INSTANCES[instance]
    rng = np.random.default_rng(80 + cout)
    x = rng.uniform(0, 1, (2, 8, 24, cin)).astype(np.float32)
    w = (rng.standard_normal((3, 3, cin, cout)) / np.sqrt(9 * cin)).astype(
        np.float32)
    jx, jw = jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16)
    tx, tw = jax_bf16_to_torch(jx), jax_bf16_to_torch(jw)
    m = np.ones(cout, np.float32)
    b = (rng.standard_normal(cout) * 0.1).astype(np.float32)
    fn = T.packed_conv3x3 if op == "packed" else T.conv3x3
    ops = T.prepare_conv3x3(tw, torch.from_numpy(m), torch.from_numpy(b))
    got = fn(tx, ops, out_dtype=torch.bfloat16, pool=pool)
    raw = fn(tx, tw, torch.from_numpy(m), torch.from_numpy(b),
             out_dtype=torch.bfloat16, pool=pool)
    assert torch.equal(got.view(torch.int16), raw.view(torch.int16))
    want = jax_bf16_to_torch(_jax_conv(op, jx, jw, m, b, jnp.bfloat16, pool))
    assert float(bf16_scaled_ulps(got, want).max()) <= 1


def test_prepare_keeps_only_raw_operands_where_no_kernel_fits():
    w = torch.zeros(3, 3, 24, 64, dtype=torch.int8)  # C_in not of 16
    ops = T.prepare_conv3x3(w, torch.ones(64), torch.zeros(64))
    assert ops.packed is None and ops.m is None
    x = torch.ones(1, 4, 6, 24, dtype=torch.int8)
    assert torch.equal(T.conv3x3(x, ops),
                       T.conv3x3_plain(x, w, torch.ones(64), torch.zeros(64)))


@pytest.mark.parametrize("cin,cout", [(64, 64), (64, 128), (128, 256)])
def test_pass_slabs_are_contiguous_b_operands(cin, cout):
    """The kernel reads tap t's slab of pass p (output channels 128 p ..)
    at t cin cout + 128 p cin, as a K-major B of leading byte offset 128
    and stride byte offset 8 cin: element (k, n) of the pass at ((n // 8)
    (cin // 16) + k // 16) 128 + (n % 8) 16 + k % 16."""
    rng = np.random.default_rng(cin + cout)
    w = torch.from_numpy(rng.integers(-127, 128, (3, 3, cin, cout))
                         .astype(np.int8))
    flat = T.prepare_conv3x3(w, torch.ones(cout), torch.zeros(cout)) \
        .packed.reshape(-1)
    nc = min(cout, 128)
    k, n = torch.meshgrid(torch.arange(cin), torch.arange(nc), indexing="ij")
    for tap in (0, 4, 8):
        for p in range(cout // nc):
            at = tap * cin * cout + p * nc * cin + \
                ((n // 8) * (cin // 16) + k // 16) * 128 + (n % 8) * 16 + k % 16
            assert torch.equal(flat[at],
                               w[tap // 3, tap % 3, :, p * nc:(p + 1) * nc])


@pytest.mark.parametrize("mt", range(4))
def test_block_rows_read_their_tap_pixels(mt):
    """Row 8 i + c of M-tile mt (core matrix i: stride byte offset one
    input-tile row; 16 bytes a row) at tap (dy, dx) reads input-tile pixel
    (8 (mt // 2) + i + dy, 8 (mt % 2) + c + dx), which is output pixel (8
    (mt // 2) + i, 8 (mt % 2) + c)'s tap (the input tile starts one pixel
    up and left), inside plane 0 (the planes of 16 channels lie PLANE
    bytes apart)."""
    a_block = ((mt // 2) * 8 * IW + (mt % 2) * 8) * 16
    for tap in range(9):
        dy, dx = tap // 3, tap % 3
        for i in range(8):
            for c in range(8):
                addr = a_block + (dy * IW + dx) * 16 + i * IW * 16 + c * 16
                p = addr // 16
                assert addr % 16 == 0 and addr < PLANE
                assert divmod(p, IW) == (8 * (mt // 2) + i + dy,
                                         8 * (mt % 2) + c + dx)


@pytest.fixture(scope="module")
def variables():
    return C.jax_variables()


@pytest.mark.parametrize("mode", ["int8", "bf16"])
def test_serving_per_layer_route_prepares_once(variables, mode, monkeypatch):
    """Both flags off, at W 40: the graph prepares every conv the per-layer route
    runs when it is built (blocks 3-8, block 2 in bf16 mode, the heads'
    3x3s), a request hands ``conv3x3`` / ``packed_conv3x3`` those operands
    and re-derives none (no ``_wmb``); the outputs equal the raw
    operands' bit for bit and the JAX package's within ``_serving_cases``'
    bounds."""
    from spnerf_tpu_torch.ops import fast_inference as tfi
    from spnerf_tpu_torch.ops import serving
    from spnerf_tpu_torch.tools.import_jax_weights import serving_from_folded

    ref = C.jax_case(variables, mode, False, False, 40)
    prepared, passed = [], []
    monkeypatch.setattr(serving, "prepare_conv3x3", lambda *a: (
        prepared.append(a[0].dtype), T.prepare_conv3x3(*a))[1])
    wrappers = {name: getattr(serving, name)
                for name in ("conv3x3", "packed_conv3x3")}
    for name, fn in wrappers.items():
        monkeypatch.setattr(serving, name, lambda x, ops, _f=fn, **kw: (
            passed.append(type(ops)), _f(x, ops, **kw))[1])
    sp = serving_from_folded(ref["folded"], ref["scales"], device="cpu",
                             mode=mode, fused_mid=False, fused_tail=False)
    act = torch.int8 if mode == "int8" else torch.bfloat16
    assert prepared == [act] * (6 + (mode == "bf16") + 2)
    monkeypatch.setattr(sp, "_wmb", lambda *a: pytest.fail(
        "a request re-derived a conv's operands"))
    x = torch.from_numpy(ref["x"])
    out = sp(x)
    assert len(prepared) == 6 + (mode == "bf16") + 2
    assert passed == [T.ConvOperands] * (6 + (mode == "bf16") + 2)
    # the same graph on the raw operands (what every call packed before)
    for name, fn in wrappers.items():
        monkeypatch.setattr(serving, name, lambda x, ops, _f=fn, **kw: _f(
            x, ops.w, ops.mult, ops.bias, **kw))
    raw = sp(x)
    for key in out:
        assert torch.equal(out[key].view(torch.int16), raw[key].view(torch.int16))
    n_all = ref["n_all"]
    dets = tfi.detect_from_logits(out["logits"], 8, min_prob=C.THRESH, size=4,
                                  num_candidates=n_all, top_k=n_all)
    C.check_outputs(ref, out)
    C.check_keypoints(ref, dets)
    C.check_descriptors(ref, out)
