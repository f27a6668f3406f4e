"""The probes P1-P4 of the port (``spnerf_tpu_torch/probes/``, kernels
``kernels/probe_conv.py``, ``probe_chain.py``, ``probe_gather.py``)
against the TPU probes under ``benchmarks/``, run in Pallas TPU interpret
mode on the CPU, on the same inputs; and the CUDA kernels' addressing,
modelled by ``tests/_probe_tc.py``, against the plain versions.

The TPU files build their inputs inside and print only rates, so the
jitted callable and its arguments are captured: P1 and P2 through the
module's ``timeit``, P3 through a stand-in for the module's ``pl`` whose
``pallas_call`` records the function it builds, P4 through ``_run``.
Tolerances: int8 results (the conv's wrap modulo 256 included), the int8
chain and the gathers exactly equal; bf16 results within 1 bf16 ulp at
the larger value, floored at 2^-8 of the largest output (the same exact
bf16 products summed in float32 in other orders), and the bf16 chain on
seeded inputs within depth x 2^-9 in norm
(``tools/smoke_probes.py`` states both bounds).
"""

import collections
import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from _probe_tc import chain_hazards, chain_ops, probe_chain_model, probe_conv_model
from spnerf_tpu_torch.kernels.probe_chain import probe_chain, probe_chain_plain
from spnerf_tpu_torch.kernels.probe_conv import (
    kernel_config,
    pack_probe_weights,
    probe_conv,
    probe_conv_plain,
    schedule,
)
from spnerf_tpu_torch.kernels.probe_gather import (
    COL_ROWS,
    SLAB,
    column_hbm_bytes_model,
    column_walk,
    gather_columns_plain,
    gather_in_rows_plain,
    gather_rows_plain,
)
from spnerf_tpu_torch.probes import gather_probe, micro_conv2, micro_conv3, mxu_probe
from spnerf_tpu_torch.tools.smoke_probes import (
    CHAIN_ULP,
    bf16_ulps,
    chain_operands,
    chain_rel_error,
)

ROOT = Path(__file__).resolve().parents[1]


def _tpu_file(name):
    spec = importlib.util.spec_from_file_location(
        f"_tpu_{name}", ROOT / "benchmarks" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _torch(a):
    a = np.array(a)
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _assert_close(got, want):
    if got.dtype == torch.bfloat16:
        assert bf16_ulps(got, want) <= 1.0
    else:
        assert got.dtype == want.dtype and torch.equal(got, want)


# ---- P1, P2: the conv probe ----

CONV_CASES = [("micro_conv2", "acc9", "int8"), ("micro_conv2", "acc9", "bf16"),
              ("micro_conv3", "acc9", "int8"), ("micro_conv3", "acc9", "bf16"),
              ("micro_conv3", "concat", "int8"), ("micro_conv3", "concat", "bf16")]


@pytest.mark.parametrize("file,order,dtype", CONV_CASES)
def test_conv_probe_matches_tpu_kernel(monkeypatch, file, order, dtype):
    """The plain version (and so the kernel's twin) against the TPU body
    on the TPU file's own inputs, C 16, 2 bands of 2 x 16: int8 sums reach
    190,515, so the output bytes show the wrap modulo 256."""
    tpu = _tpu_file(file)
    seen = {}

    def timeit(fn, *args, iters=5):
        seen["fn"], seen["args"] = fn, args
        return 1.0

    monkeypatch.setattr(tpu, "timeit", timeit)
    with pltpu.force_tpu_interpret_mode():
        if file == "micro_conv2":
            tpu.bench_pallas_conv_rate(16, dtype, Hb=2, W=16, n=2)
        else:
            tpu.bench_pallas_conv(16, dtype, Hb=2, W=16, n=2,
                                  concat=order == "concat")
        want = _torch(seen["fn"](*seen["args"]))
    x, w = (_torch(a) for a in seen["args"])
    _assert_close(probe_conv(x, w, order), want)  # CPU tensors: the plain version
    if dtype == "int8":
        wide = sum(x[:, :, t % 3:t % 3 + 16].long() @ w.reshape(9, 16, 16)[t].long()
                   for t in range(9))
        assert int(wide.max()) > 127  # the wrap modulo 256 is exercised


@pytest.mark.parametrize("dtype,order,C", [
    (dt, order, C) for dt in ("int8", "bf16") for order in ("acc9", "concat")
    for C in (64, 128, 256)])
def test_conv_kernel_addressing(dtype, order, C):
    """``csrc/probe_conv.cu``'s tensor-map boxes, input stages, ring slots
    (concat's A slices, the weight parts of a cluster's blocks), resident
    weights, descriptors and 16-byte epilogue (modelled) against the
    plain version: 3 rows of W 70 (two M-tiles a row, the second ragged;
    an item with dead M-tiles), the grid of three clusters walking
    several items each."""
    x, w = micro_conv2.conv_operands(C, dtype, Hb=3, W=70, n=1, device="cpu",
                                     seed=C)
    _assert_close(probe_conv_model(x, w, order), probe_conv_plain(x, w, order))


@pytest.mark.parametrize("order", ["acc9", "concat"])
def test_conv_kernel_schedule(order):
    """The persistent walk (``probe_conv.schedule``) computes every
    (M-tile, N-block) pair exactly once, at every instance's cluster
    size and N-blocks, for grids of one cluster, a few, the SMs of an
    H100 (132) and more blocks than items; R below the SM count, the
    ragged W 70 and the probe files' rows. Every instance's buffers fit
    a block's shared memory."""
    for es, C in ((1, 64), (1, 128), (1, 256), (2, 64), (2, 128), (2, 256)):
        cfg = kernel_config(es, C, order == "concat")
        assert cfg["smem"] <= 232448 and (cfg["ast"] >= 1 or order == "concat")
        for R, W in ((3, 70), (1, 640), (50, 200), (3840, 640)):
            n_mt = R * -(-W // 64)
            for blocks in (cfg["cl"], 3 * cfg["cl"], 132, 4 * n_mt * cfg["cl"]):
                seen = collections.Counter()
                for _, visits in schedule(n_mt, cfg, blocks):
                    seen.update(visits)
                want = {(mt, nb) for mt in range(n_mt) for nb in range(cfg["nb"])}
                assert set(seen) == want and max(seen.values()) == 1, (es, C, R, W, blocks)


def test_conv_kernel_model_grids():
    """The modelled kernel at grids of one cluster and of more blocks than
    items gives the plain version's output (int8, bit for bit)."""
    x, w = micro_conv2.conv_operands(256, "int8", Hb=2, W=70, n=1, device="cpu", seed=9)
    want = probe_conv_plain(x, w, "acc9")
    for blocks in (2, 40):
        assert torch.equal(probe_conv_model(x, w, "acc9", blocks=blocks), want)


def test_pack_probe_weights_layout():
    """Element (tap, k, n) of w lands where the kernel's chunk (block of
    BN output channels, tap, KC input channels) and core matrix put it."""
    rng = np.random.default_rng(0)
    for dtype, C in (("int8", 256), ("bf16", 128), ("int8", 64), ("bf16", 256)):
        _, w = micro_conv2.conv_operands(C, dtype, Hb=1, W=1, n=1, device="cpu", seed=3)
        flat = pack_probe_weights(w, C).reshape(-1)
        e = 16 // w.element_size()
        kc, bn = min(C, 8 * e), min(C, 128)
        for tap, k, n in zip(rng.integers(0, 9, 200), rng.integers(0, C, 200),
                             rng.integers(0, C, 200)):
            y, nn = divmod(int(n), bn)
            q, kk = divmod(int(k), kc)
            chunk = ((y * 9 + int(tap)) * (C // kc) + q) * kc * bn
            at = chunk + ((nn // 8) * (kc // e) + kk // e) * 8 * e + (nn % 8) * e + kk % e
            assert flat[at] == w[tap, k, n]


# ---- P3: the dependent chain ----

def _tpu_chain(dtype, depth, R):
    """The TPU file's ``pallas_chain`` at (R, 128), its built callable
    captured by a stand-in for the module's ``pl``."""
    tpu = _tpu_file("mxu_probe")
    built = []

    class Pallas:
        def __getattr__(self, name):
            return getattr(pl, name)

        def pallas_call(self, *args, **kw):
            built.append(pl.pallas_call(*args, **kw))
            return built[-1]

    tpu.pl = Pallas()
    with pltpu.force_tpu_interpret_mode():
        tpu.pallas_chain(dtype, depth=depth, R=R, iters=1)
    return built[0]


@pytest.mark.parametrize("dtype", ["bf16", "int8"])
def test_chain_probe_matches_tpu_kernel(dtype):
    """The file's all-ones inputs at depth 20 (bf16: inf from layer 19,
    equal bits) and seeded inputs at depth 4, R 128."""
    jdt = {"bf16": jnp.bfloat16, "int8": jnp.int8}[dtype]
    for depth, operands in ((20, "ones"), (4, "seeded")):
        f = _tpu_chain(jdt, depth, 128)
        if operands == "ones":
            x = torch.ones((128, 128), dtype=mxu_probe.DTYPES[dtype])
            w = torch.ones((128, 128), dtype=mxu_probe.DTYPES[dtype])
        else:
            x, w = chain_operands(dtype, R=128, device="cpu")
        xj, wj = (jnp.asarray(t.view(torch.int16).numpy()).view(jnp.bfloat16)
                  if dtype == "bf16" else jnp.asarray(t.numpy()) for t in (x, w))
        with pltpu.force_tpu_interpret_mode():
            want = _torch(f(xj, wj))
        got = probe_chain(x, w, depth)  # CPU tensors: the plain version
        if operands == "ones" or dtype == "int8":
            assert torch.equal(got.view(torch.uint8) if dtype == "bf16" else got,
                               want.view(torch.uint8) if dtype == "bf16" else want)
        else:
            assert chain_rel_error(got, want) <= depth * CHAIN_ULP
    if dtype == "bf16":  # the file's all-ones chain overflows at layer 19
        ones = torch.ones((4, 128), dtype=torch.bfloat16)
        assert torch.isfinite(probe_chain_plain(ones, ones[:1].expand(128, 128), 18)).all()
        assert torch.isinf(probe_chain_plain(ones, ones[:1].expand(128, 128), 19)).all()


@pytest.mark.parametrize("dtype", ["bf16", "int8"])
def test_chain_kernel_addressing(dtype):
    """``csrc/probe_chain.cu``'s staged B halves (int8 rows permuted),
    register fragments (x's columns 0-63 in two sets by the layer's
    parity) and epilogues, run in the kernel's pipelined issue order with
    each product reading its registers when its group completes
    (modelled), against the plain version: R 100 (a second, partial
    block), depth 1 and 3."""
    x, w = chain_operands(dtype, R=100, device="cpu", seed=9)
    for depth in (1, 3):
        got, want = probe_chain_model(x, w, depth), probe_chain_plain(x, w, depth)
        if dtype == "int8":
            assert torch.equal(got, want)
        elif depth == 1:
            assert bf16_ulps(got, want) <= 1.0
        else:
            assert chain_rel_error(got, want) <= depth * CHAIN_ULP


@pytest.mark.parametrize("nk", [8, 4])
def test_chain_kernel_pipeline(nk):
    """The kernel's issue order (bf16 8 k-steps a layer, int8 4) keeps
    every hazard apart at depths 1-9: each product reads the previous
    layer's x, each epilogue and store a whole layer's sums with no group
    pending on them, and no epilogue writes registers a pending group
    reads; the order without the second register set, or with half 1's
    epilogue before the wait for half 1, raises."""
    for depth in range(1, 10):
        ops = chain_ops(depth, nk)
        assert chain_hazards(ops, nk) == [depth, depth]
        issues = [op for op in ops if op[0] == "issue"]
        assert sum(len(op[2]) for op in issues) == 2 * nk * depth
    one_set = [op[:2] + (0,) if op[0] == "epilogue" else
               op[:3] + (0,) if op[0] == "issue" else op for op in chain_ops(4, nk)]
    with pytest.raises(AssertionError):
        chain_hazards(one_set, nk)
    ops = chain_ops(4, nk)
    at = ops.index(("epilogue", 1, 1))
    early = ops[:at - 1] + [ops[at], ops[at - 1]] + ops[at + 1:]
    with pytest.raises(AssertionError):
        chain_hazards(early, nk)


# ---- P4: the gathers ----

PLAINS = {"rows": gather_rows_plain, "columns": gather_columns_plain,
          "in-rows": gather_in_rows_plain}


def test_gather_probe_matches_tpu_kernels(monkeypatch):
    """The three gathers of the TPU file, in interpret mode, against the
    plain versions on the same table and indices: equal bits."""
    tpu = _tpu_file("mosaic_gather_probe")
    real, calls = tpu._run, []

    def run(kern, out_shape, *args):
        out = real(kern, out_shape, *args)
        calls.append((args, out))
        return out

    monkeypatch.setattr(tpu, "_run", run)
    with pltpu.force_tpu_interpret_mode():
        errors = [tpu.probe_take_2d(T=64, N=32), tpu.probe_sublane_taa(T=32),
                  tpu.probe_lane_taa(N=16)]
    assert errors == [0.0, 0.0, 0.0]
    for form, (args, out) in zip(("rows", "columns", "in-rows"), calls):
        src, idx = (_torch(a) for a in args)
        assert torch.equal(PLAINS[form](src, idx), _torch(out))


def test_gather_plain_fills_outside():
    src = torch.arange(12, dtype=torch.float32).reshape(4, 3)
    out = gather_rows_plain(src, torch.tensor([1, 4, -1], dtype=torch.int32))
    assert torch.equal(out[0], src[1]) and bool(torch.isnan(out[1:]).all())
    out = gather_columns_plain(src, torch.tensor([[0, 9, 3]], dtype=torch.int32))
    assert out[0, 0] == 0 and bool(torch.isnan(out[0, 1])) and out[0, 2] == 11
    out = gather_in_rows_plain(src, torch.tensor([[2, 3]] * 4, dtype=torch.int32))
    assert torch.equal(out[:, 0], src[:, 2]) and bool(torch.isnan(out[:, 1]).all())


# ---- the probe modules on the CPU ----

def test_probe_modules_run_on_cpu(capsys):
    """Each module's measurements through the plain versions at toy sizes
    (host-clock times; the card's lines need the card)."""
    assert micro_conv2.bench_conv_rate(16, "int8", Hb=2, W=16, n=2, device="cpu",
                                       iters=1) > 0
    assert micro_conv2.bench_scan_matmul(64, 32, 16, "int8", steps=2,
                                         device="cpu") > 0
    assert micro_conv3.bench_conv(16, "bf16", Hb=2, W=16, n=2, concat=True,
                                  device="cpu", iters=1) > 0
    rate, out = mxu_probe.chain("int8", depth=3, R=64, iters=1, device="cpu")
    assert rate > 0 and torch.equal(out, torch.ones_like(out))
    for name, form, size in gather_probe.PROBES:
        assert gather_probe.probe(form, "cpu", reps=1, name=name, **size)[0] == 0
    text = capsys.readouterr().out
    assert "GMAC/s" in text and "TOP/s" in text and "OK" in text


def test_conv1_forms_agree():
    """``micro_conv3``'s four forms of conv1 compute one function: the
    fused multiply-adds against ``F.conv2d`` within 1 bf16 ulp."""
    gen = torch.Generator().manual_seed(0)
    x = torch.randn((1, 6, 8, 1), generator=gen).to(torch.bfloat16)
    k = torch.randn((3, 3, 1, 64), generator=gen).to(torch.bfloat16)
    ref = micro_conv3.conv1(x, k, "fma")
    for mode in ("conv2d_nhwc", "conv2d_nchw"):
        assert bf16_ulps(micro_conv3.conv1(x, k, mode).contiguous(), ref) <= 1.0
    assert torch.equal(micro_conv3.conv1(x, k, "fma_packed").reshape(ref.shape), ref)


@pytest.mark.parametrize("N,T,F", [(300, 77, 128), (3 * COL_ROWS + 5, 40, 100),
                                   (COL_ROWS - 1, 1000, 7), (2 * COL_ROWS, 9, 16)])
def test_gather_column_walk(N, T, F):
    """The column kernel's slab-major index map (``column_walk``, the
    kernel's expressions) at N != T, F 128, 100 (a ragged last slab) and
    7 (one partial slab), ragged and whole last chunks of rows: every
    (i, j) of the output visited exactly once, block by block all rows
    of a slab before the next slab; a gather through the map reading
    ``idx[i, j]`` once each, indices outside the table among them, equals
    the plain version bit for bit."""
    b, i, j = column_walk(N, F)
    seen = np.zeros((N, F), np.int64)
    np.add.at(seen, (i, j), 1)
    assert (seen == 1).all()
    assert (np.diff(b) >= 0).all() and (np.diff(j // SLAB) >= 0).all()
    rng = np.random.default_rng(N + F)
    table = torch.from_numpy(rng.standard_normal((T, F)).astype(np.float32))
    idx = torch.from_numpy(rng.integers(-3, T + 3, (N, F)).astype(np.int32))
    r = idx.numpy()[i, j]
    out = np.full((N, F), np.inf, np.float32)
    ok = (r >= 0) & (r < T)
    out[i, j] = np.where(ok, table.numpy()[np.clip(r, 0, T - 1), j], np.nan)
    assert torch.equal(torch.from_numpy(out).view(torch.int32),
                       gather_columns_plain(table, idx).view(torch.int32))


def test_gather_column_hbm_model():
    """The HBM bytes counted from the schedules by the model's rule: a
    table whose live lines fit an L2 partition costs each distinct
    sector once in either order; past it (2^18 rows of 128 columns) the
    flat order's live table (all 128 MB) misses on most further touches
    and the slab walk's (one 128-byte line a row, 32 MB) on a quarter of
    them."""
    N, F = 1 << 10, 128
    rng = np.random.default_rng(0)
    for T, hit_flat, hit_slabs in ((1 << 12, 1.0, 1.0), (1 << 18, 25e6 / (1 << 27),
                                                         25e6 / (1 << 25))):
        idx = torch.from_numpy(rng.integers(0, T, (N, F)).astype(np.int32))
        distinct = len({(int(r), c // 8) for r, c in
                        zip(idx.reshape(-1).tolist(), list(range(F)) * N)})
        for order, hit in (("flat", hit_flat), ("slabs", hit_slabs)):
            want = 8 * N * F + 32 * (distinct + round((N * F - distinct) * (1 - hit)))
            assert column_hbm_bytes_model(idx, T, order) == want, (T, order)
    outside = torch.full((4, F), -1, dtype=torch.int32)
    assert column_hbm_bytes_model(outside, 512) == 8 * 4 * F
