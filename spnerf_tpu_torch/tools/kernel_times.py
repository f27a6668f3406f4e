"""Device time of the serving, HA and render kernels apart from their
wrappers' host work, on the card.

    python -m spnerf_tpu_torch.tools.kernel_times [--out PATH] [--routes]
        [--match SUBSTRINGS]

For each case (``conv12_fused`` at batch 64, 480 x 640 and at the HA
export's 80 views of 240 x 320; the HA warp and unwarp of one chunk,
bf16 and int8, each beside ``F.grid_sample`` on the same sources; the
int8 ``double_conv3x3`` of blocks 3-4, 5-6 and 7-8 and the int8 ``head``
(detector with softmax, descriptor) at those two shapes' activations
(HA's detector in logits mode); ``dot_bias_act`` at the shapes of the
per-layer route at batch 8, 480 x 640; ``head`` bf16 at batch 64 and at
HA's 80 views of 30 x 40 cells; the render kernels at the operands of
``chip_smoke.py``'s render drive: the committed sphere fields in bf16 on
131,072 orbit rays x 32 samples, width 128 dense, with the early stop and
with cached occupancy flags and the early stop, widths 64 and 32 and int8
with the early stop, the same widths with float32 weights, and beside
int8 its yardstick, three ``torch._int_mm`` over all (ray, sample) rows;
``conv3x3`` / ``packed_conv3x3`` at the per-layer route's instances,
int8 and bf16, batch 8 at 480 x 640; ``--match conv12,warp`` keeps the
cases whose label holds one of the substrings) it prints, in ms per
call:

* ``wrapper``: CUDA events around one call of the wrapper, median of 20
  (what the ``ms`` of ``chip_smoke.py``'s kernel rows measures);
* ``back_to_back``: events around 20 calls in a row, over 20;
* ``device``: the kernels the profiler (``torch.profiler``, CUDA
  activity) saw in 20 calls, over 20, each by its symbol; the kernel's
  own symbol apart from the padding and packing launches of a raw call.

Raw calls (weights packed on every call) always; calls on operands
prepared once (``prepare_conv12``, ``prepare_double_conv``,
``prepare_dot``, ``prepare_head``, ``prepare_conv3x3``,
``prepare_render_int8``) where the wrappers offer them. Inputs are
seeded; weights random.
``--out`` writes the results as JSON. Without a card it exits non-zero.

``--routes`` times the serving routes end to end instead, through the
public entry points only (``build_inference``, ``ServingSuperPoint``),
so that the same script can time two versions of the package in one
call: ms per request (host clock around a request that ends in a
synchronize, median of 10 after 2 warm-ups) and frames/s at batch 64
(int8, bf16, mixed, fused) and batch 8 (int8 and bf16 per-layer), 480 x
640, full-width SuperPoint from seed 0, det_thresh 0.015, top_k 1024;
and the forwards of HA's int8 and mixed routes, (b) and (d) (MagicPoint,
80 views of 240 x 320, CUDA events, median of 5).
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

REPS = 20


def _events_ms(fn, reps: int, per_call: bool) -> float:
    """Median over ``reps`` single calls (``per_call``), or one span of
    ``reps`` calls in a row over ``reps``; CUDA events."""
    fn()
    torch.cuda.synchronize()
    if not per_call:
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps
    times = []
    for _ in range(reps):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_kernels(fn, reps: int = REPS) -> dict:
    """{kernel symbol: (device ms per call, launches per call seen)} of
    what ``fn`` launches, from ``torch.profiler`` over ``reps`` calls
    (after one warm-up call). The profiler may drop a few of a short
    kernel's records, so a symbol's time per call is its mean time per
    record seen times its whole launches per call (at least one). An
    empty dict if the profiler saw no device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    seen = {}
    for event in prof.key_averages():
        us = getattr(event, "self_device_time_total", None)
        if us is None:
            us = getattr(event, "self_cuda_time_total", 0)
        if us > 0:
            total, n = seen.get(event.key, (0.0, 0))
            seen[event.key] = (total + us / 1e3, n + event.count)
    return {key: (total / n * max(1, round(n / reps)), n / reps)
            for key, (total, n) in seen.items()}


def device_ms(fn, symbol: str | None = None, reps: int = REPS):
    """(device ms per call, how): the profiler's time of the kernels whose
    symbol holds ``symbol`` (all kernels when None), with the launches
    per call it saw of them; where it sees no device time, CUDA events
    around ``reps`` calls in a row."""
    kernels = device_kernels(fn, reps)
    if kernels:
        mine = [v for name, v in kernels.items()
                if symbol is None or symbol in name]
        return (sum(ms for ms, _ in mine),
                f"profiler, {sum(n for _, n in mine):g} launches per call "
                "seen")
    return _events_ms(fn, reps, per_call=False), "events"


def _short(symbol: str) -> str:
    name = symbol.replace("(anonymous namespace)::", "").replace("void ", "")
    return name.split("(")[0][:90]


# HA's warps (``magicpoint_coco_export.yaml``): one chunk of 10 views of
# a batch of 8 at 240 x 320
HA_SHAPE, HA_BATCH, HA_CHUNK = (240, 320), 8, 10
HA_PARAMS = {"translation": True, "rotation": True, "scaling": True,
             "perspective": True, "scaling_amplitude": 0.2,
             "perspective_amplitude_x": 0.2, "perspective_amplitude_y": 0.2,
             "allow_artifacts": True, "patch_ratio": 0.85, "max_angle": 1.57}


def _warp_cases(rng, t):
    """The image warp (8 images -> 80 views) and the probability unwarp
    (80 -> 80) of one HA chunk, bf16 and int8, each with
    ``F.grid_sample`` on the same sources and source coordinates (grid
    built ahead) as its yardstick."""
    import torch.nn.functional as F

    from spnerf_tpu_torch.geometry.homography import HomographyConfig
    from spnerf_tpu_torch.kernels.warp import (
        invert_homographies,
        source_coords,
        warp_by_inverse,
    )
    from spnerf_tpu_torch.ops.homography_adaptation import image_homographies

    h, w = HA_SHAPE
    homs = image_homographies(0, range(HA_BATCH), HA_CHUNK, HA_SHAPE,
                              HomographyConfig.from_dict(HA_PARAMS))
    invs = invert_homographies(homs.cuda().transpose(0, 1))
    h_inv = invs.reshape(-1, 3, 3).contiguous()
    h_inv_inv = invert_homographies(invs).reshape(-1, 3, 3).contiguous()
    n = h_inv.shape[0]
    images = t(rng.uniform(0, 1, (HA_BATCH, h, w, 1)).astype(np.float32))
    probs = t(rng.uniform(0, 1, (n, h, w, 1)).astype(np.float32))
    for label, src, hinv in (("image warp", images, h_inv),
                             ("unwarp", probs, h_inv_inv)):
        for dtype, name in ((torch.bfloat16, "bf16"), (torch.int8, "int8")):
            yield (f"warp[{name}] {label} {src.shape[0]}->{n}x{h}x{w}",
                   lambda src=src, hinv=hinv, dtype=dtype:
                   warp_by_inverse(src, hinv, dtype), None, "warp_")
        rep = src.permute(0, 3, 1, 2).repeat(n // src.shape[0], 1, 1, 1)
        sx, sy = source_coords(hinv, HA_SHAPE)
        grid = torch.stack([sx * (2.0 / (w - 1)) - 1.0,
                            sy * (2.0 / (h - 1)) - 1.0], -1)
        grid = torch.where(torch.isfinite(grid), grid, -2.0)
        yield (f"grid_sample {label} {n}x{h}x{w}",
               lambda rep=rep, grid=grid: F.grid_sample(
                   rep, grid, mode="bilinear", padding_mode="zeros",
                   align_corners=True), None, "")


def _conv12_cases(rng, t, mb):
    """``conv12_fused`` (int8, pooled) at a ``[slice]`` request's batch
    64 x 480 x 640 and at HA's forward of 80 views of 240 x 320."""
    from spnerf_tpu_torch.kernels import conv12_fused as K

    prep = getattr(K, "prepare_conv12", None)
    s1 = np.float32(0.02)
    for B, h, w in ((64, 480, 640), (80, 240, 320)):
        image = t(rng.uniform(0, 1, (B, h, w, 1)).astype(np.float32))
        raw = (t((rng.standard_normal((3, 3, 1, 64)) * 0.3).astype(
                   np.float32)),
               t(np.full((64,), np.float32(1.0) / (np.float32(127.0) * s1))),
               t((rng.standard_normal(64) * 0.1 / s1).astype(np.float32)),
               t(rng.integers(-127, 128, (3, 3, 64, 64)).astype(np.int8)),
               *mb(64, 1e-4, 6e-4))
        ops = prep(*raw) if prep else None
        yield (f"conv12_fused[pool] {B}x{h}x{w}",
               lambda image=image, raw=raw: K.conv12_fused(image, *raw),
               None if ops is None else
               (lambda image=image, ops=ops: K.conv12_fused(image, ops)),
               "conv12_")


def _s8_cases(rng, t, mb):
    """The int8 ``double_conv3x3`` instances and heads of a ``[slice]``
    request (batch 64, 480 x 640) and of HA's forward of 80 views of 240
    x 320 (the detector in logits mode), on seeded activations and
    weights."""
    from spnerf_tpu_torch.kernels import mid_fused as M
    from spnerf_tpu_torch.kernels import tail_fused as T

    prep_dc = getattr(M, "prepare_double_conv", None)
    prep_head = getattr(T, "prepare_head", None)

    def i8(shape, lo=-127):
        return t(rng.integers(lo, 128, shape).astype(np.int8))

    for B, h, w in ((64, 480, 640), (80, 240, 320)):
        for cin, cm, pool, s in ((64, 64, True, 2), (64, 128, True, 4),
                                 (128, 128, False, 8)):
            x = i8((B, h // s, w // s, cin), 0)
            raw = (i8((3, 3, cin, cm)), *mb(cm, 5e-5, 4e-4),
                   i8((3, 3, cm, cm)), *mb(cm, 5e-5, 4e-4))
            ops = prep_dc(*raw) if prep_dc else None
            kw = {"pool": pool}
            yield (f"double_conv3x3[{cin}-{cm}-{cm}{'-pool' if pool else ''}] "
                   f"{B}x{h // s}x{w // s}",
                   lambda x=x, raw=raw, kw=kw: M.double_conv3x3(x, *raw, **kw),
                   None if ops is None else
                   (lambda x=x, ops=ops, kw=kw: M.double_conv3x3(x, ops, **kw)),
                   "double_conv3x3_")
        x = i8((B, h // 8, w // 8, 128), 0)
        for cout, soft in (((65, True), (256, False)) if B == 64
                           else ((65, False),)):
            raw = (i8((3, 3, 128, 256)), *mb(256, 5e-5, 4e-4), i8((256, cout)),
                   *mb(cout))
            ops = prep_head(*raw) if prep_head else None
            kw = {"softmax_lanes": cout} if soft else {}
            yield (f"head[{cout}{'-softmax' if soft else ''}] "
                   f"{B}x{h // 8}x{w // 8}",
                   lambda x=x, raw=raw, kw=kw: T.head(x, *raw, **kw),
                   None if ops is None else
                   (lambda x=x, ops=ops, kw=kw: T.head(x, ops, **kw)), "head_")


# the render drive of chip_smoke.py (bench_nerf.py's protocol): width ->
# (committed field, block, s_chunk), orbit rays, samples
FIELD_DIR = Path(__file__).resolve().parents[2] / "benchmarks" / "data"
RENDER_FIELDS = {128: ("sphere_field.npz", 1024, 16),
                 64: ("sphere_field_w64.npz", 512, 16),
                 32: ("sphere_field_w32.npz", 2048, 8)}
RENDER_RAYS, RENDER_SAMPLES, RENDER_EPS = 131072, 32, 1e-3


def orbit_rays(n_rays: int):
    """A camera's ray bundle, as bench_nerf.py makes it: an orbit pose at
    radius 4 looking at the origin, 60 degrees, int(sqrt(n)) pixels a side,
    padded to ``n_rays`` with its first rays. (origins, directions) on the
    card."""
    from spnerf_tpu_torch.data.nerf_dataset import camera_intrinsics
    from spnerf_tpu_torch.models.nerf import camera_rays
    from spnerf_tpu_torch.tasks.nerf_task import pose_orbit

    side = int(np.sqrt(n_rays))
    K = torch.from_numpy(camera_intrinsics((side, side), 60.0)).cuda()
    pose = torch.from_numpy(pose_orbit(8, radius=4.0, height=0.4)[0]).cuda()
    o, d = camera_rays((side, side), K, pose)
    pad = n_rays - side * side
    return (torch.cat([o, o[:pad]]).contiguous(),
            torch.cat([d, d[:pad]]).contiguous())


def load_field(width: int):
    """A committed sphere field in bf16 with its configuration, encoding
    matrix on the card and bench_nerf.py's block and s_chunk."""
    import types

    from spnerf_tpu_torch.models.fused_tiny_nerf import (
        TinyFieldConfig,
        make_encoding,
    )
    from spnerf_tpu_torch.tools.import_jax_weights import tiny_field_from_jax

    name, block, s_chunk = RENDER_FIELDS[width]
    with np.load(FIELD_DIR / name) as data:
        params = tiny_field_from_jax({k: data[k] for k in data.files},
                                     "cuda", torch.bfloat16)
    cfg = TinyFieldConfig(n_samples=RENDER_SAMPLES, width=width)
    A, c = (torch.from_numpy(t).cuda() for t in make_encoding(cfg))
    return types.SimpleNamespace(width=width, params=params, cfg=cfg, A=A,
                                 c=c, block=block, s_chunk=s_chunk)


def render_drive():
    """The operands of the render drive: (orbit origins, directions), and
    per width ``load_field``'s namespace with the bf16 weights ``ws``, the
    encodings (oe, de, df) of those rays and the render keywords ``kw``
    (early stop on)."""
    from spnerf_tpu_torch.models.fused_tiny_nerf import (
        direction_features,
        encode_rays,
    )

    o, d = orbit_rays(RENDER_RAYS)
    fields = {}
    for width in RENDER_FIELDS:
        f = load_field(width)
        f.ws = [f.params[k] for k in ("w1", "w2", "w3")]
        f.oe, f.de = encode_rays(o, d, f.A, f.c)
        f.df = direction_features(f.params, d, f.A, f.c)
        f.kw = dict(jitter=0.5, n_samples=RENDER_SAMPLES, near=f.cfg.near,
                    far=f.cfg.far, block=f.block, s_chunk=f.s_chunk,
                    early_stop_eps=RENDER_EPS)
        fields[width] = f
    return o, d, fields


def _render_cases():
    """The render kernels at the drive's operands (after every other
    case, so that the seeded draws of those stay as they were)."""
    from spnerf_tpu_torch.kernels import render as R
    from spnerf_tpu_torch.ops.occupancy import (
        chunk_flags,
        field_integral_volume,
    )

    o, d, fields = render_drive()
    n = f"{RENDER_RAYS}x{RENDER_SAMPLES}"
    for width in (64, 32):
        f = fields[width]
        yield (f"render[w{width}] early stop {n}",
               lambda f=f, width=width: R.render_fused_packed(
                   f.oe, f.de, *f.ws, f.df, width=width, **f.kw),
               None, "render")
    f = fields[128]
    ivol = field_integral_volume(
        {k: v.float() for k, v in f.params.items()}, f.cfg)
    flags = chunk_flags(o, d, ivol, block=f.kw["block"],
                        n_samples=RENDER_SAMPLES, s_chunk=f.kw["s_chunk"],
                        near=f.cfg.near, far=f.cfg.far, extent=float(f.cfg.far))
    for label, extra in (("dense", dict(early_stop_eps=0.0)),
                         ("early stop", {}),
                         ("cached flags + early stop", dict(flags=flags))):
        kw = {**f.kw, **extra}
        yield (f"render[bf16] {label} {n}",
               lambda kw=kw: R.render_fused(f.oe, f.de, *f.ws, f.df, **kw),
               None, "render")
    calib = 4096
    qf = R.qfield_to(R.quantize_field(
        {k: v.float().cpu().numpy() for k, v in f.params.items()},
        f.oe[:calib].cpu().numpy(), f.de[:calib].cpu().numpy(),
        f.df[:calib].cpu().numpy(), n_samples=RENDER_SAMPLES,
        near=f.cfg.near, far=f.cfg.far), "cuda")
    prep = getattr(R, "prepare_render_int8", None)
    qops = prep(qf) if prep else None
    yield (f"render[int8] early stop {n}",
           lambda: R.render_fused_int8(f.oe, f.de, qf, f.df, **f.kw),
           None if qops is None else
           (lambda: R.render_fused_int8(f.oe, f.de, qops, f.df, **f.kw)),
           "render")
    # row 13's yardstick: its three products alone, int8 on the tensor
    # cores over every (ray, sample) row, int32 out (the head padded to N
    # 8, _int_mm's B column-major)
    x = torch.zeros((RENDER_RAYS * RENDER_SAMPLES, 128), dtype=torch.int8,
                    device="cuda")
    wq = [w.t().contiguous().t()
          for w in (qf["qw1"], qf["qw2"], qf["qw3"][:, :8])]
    yield (f"render[int8] yardstick: three torch._int_mm {n}",
           lambda x=x: [torch._int_mm(x, w) for w in wq], None, "")
    del x
    for width in (128, 64, 32):  # the float32 instances (render_kernel)
        f = fields[width]
        ws = [w.float() for w in f.ws]
        if width == 128:
            call = (lambda f=f, ws=ws: R.render_fused(f.oe, f.de, *ws, f.df,
                                                       **f.kw))
        else:
            call = (lambda f=f, ws=ws, width=width: R.render_fused_packed(
                f.oe, f.de, *ws, f.df, width=width, **f.kw))
        yield (f"render[f32{'' if width == 128 else f'-w{width}'}] early stop "
               f"{n}", call, None, "render")


# the per-layer route's 3x3 convs at batch 8, 480 x 640: (wrapper, C_in,
# C_out, pool, H, W); int8 runs block 2 in conv12_fused
LAYER_CONVS = [("packed_conv3x3", 64, 64, False, 240, 320),
               ("packed_conv3x3", 64, 64, True, 240, 320),
               ("packed_conv3x3", 64, 128, False, 120, 160),
               ("conv3x3", 128, 128, True, 120, 160),
               ("conv3x3", 128, 128, False, 60, 80),
               ("conv3x3", 128, 256, False, 60, 80)]
BF16_BLOCK2 = ("packed_conv3x3", 64, 64, True, 480, 640)


def _conv3x3_cases(rng, t, mb):
    """``conv3x3`` / ``packed_conv3x3`` at the instances of
    ``[slice-unfused]`` (batch 8, 480 x 640), int8 and bf16, on seeded
    activations and weights."""
    from spnerf_tpu_torch.kernels import conv_stack as S

    prep = getattr(S, "prepare_conv3x3", None)
    for dtype, name in ((torch.int8, "int8"), (torch.bfloat16, "bf16")):
        for op, cin, cout, pool, h, w in LAYER_CONVS + (
                [BF16_BLOCK2] if name == "bf16" else []):
            if dtype == torch.int8:
                x = t(rng.integers(0, 128, (8, h, w, cin)).astype(np.int8))
                raw = (t(rng.integers(-127, 128, (3, 3, cin, cout))
                         .astype(np.int8)), *mb(cout, 5e-5, 4e-4))
            else:
                x = t(rng.uniform(0, 1, (8, h, w, cin)).astype(np.float32),
                      dtype)
                raw = (t((rng.standard_normal((3, 3, cin, cout))
                          / np.sqrt(9 * cin)).astype(np.float32), dtype),
                       torch.ones(cout, device="cuda"), mb(cout)[1])
            fn = getattr(S, op)
            kw = {"out_dtype": dtype, "pool": pool}
            ops = prep(*raw) if prep else None
            yield (f"{op}[{name}-{cin}-{cout}{'-pool' if pool else ''}] "
                   f"8x{h}x{w}",
                   lambda x=x, raw=raw, fn=fn, kw=kw: fn(x, *raw, **kw),
                   None if ops is None else
                   (lambda x=x, ops=ops, fn=fn, kw=kw: fn(x, ops, **kw)),
                   "conv3x3")


def _cases(gen_seed: int = 0):
    """(label, raw call, prepared call or None, kernel symbol)."""
    from spnerf_tpu_torch.kernels import conv_stack as S
    from spnerf_tpu_torch.kernels import tail_fused as T

    rng = np.random.default_rng(gen_seed)

    def t(a, dtype=None):
        x = torch.from_numpy(np.ascontiguousarray(a)).cuda()
        return x if dtype is None else x.to(dtype)

    def act(shape, dtype):
        if dtype == torch.int8:
            return t(rng.integers(-127, 128, shape).astype(np.int8))
        return t(rng.uniform(0, 1, shape).astype(np.float32), dtype)

    def weights(shape, dtype):
        if dtype == torch.int8:
            return t(rng.integers(-127, 128, shape).astype(np.int8))
        return t((rng.standard_normal(shape) / np.sqrt(np.prod(shape[:-1])))
                 .astype(np.float32), dtype)

    def mb(c, lo=2e-5, hi=1e-4):
        return (t(rng.uniform(lo, hi, c).astype(np.float32)),
                t(rng.uniform(-1, 1, c).astype(np.float32)))

    yield from _conv12_cases(rng, t, mb)
    yield from _s8_cases(rng, t, mb)
    yield from _warp_cases(rng, t)

    prep_dot = getattr(S, "prepare_dot", None)
    prep_conv1 = getattr(S, "prepare_conv1", None)
    prep_head = getattr(T, "prepare_head", None)
    M = 8 * 60 * 80
    for dtype, name in ((torch.int8, "int8"), (torch.bfloat16, "bf16")):
        for cout in (65, 256):
            x, w = act((M, 256), dtype), weights((256, cout), dtype)
            m, b = mb(cout)
            ops = prep_dot(w, m, b) if prep_dot else None
            yield (f"dot_bias_act[{name}-256-{cout}] M {M}",
                   lambda x=x, w=w, m=m, b=b: S.dot_bias_act(x, w, m, b),
                   None if ops is None else
                   (lambda x=x, ops=ops: S.dot_bias_act(x, ops)), "dot")
    image = t(rng.uniform(0, 1, (8, 480, 640, 1)).astype(np.float32))
    w1 = t((rng.standard_normal((3, 3, 1, 64)) / 3).astype(np.float32))
    ones, b1 = torch.ones(64, device="cuda"), mb(64)[1]
    ops1 = prep_conv1(w1, ones, b1) if prep_conv1 else None
    kw = {"out_dtype": torch.bfloat16}
    yield ("conv1_packed[f32-9-64-relu] M 2457600",
           lambda: S.conv1_packed(image, w1, ones, b1, **kw),
           None if ops1 is None else
           (lambda: S.conv1_packed(image, ops1, **kw)), "dot")
    for (B, Hc, Wc), cout, soft in (((64, 60, 80), 65, True),
                                    ((64, 60, 80), 256, False),
                                    ((80, 30, 40), 65, False)):
        x = act((B, Hc, Wc, 128), torch.bfloat16)
        w3 = weights((3, 3, 128, 256), torch.bfloat16)
        wh = weights((256, cout), torch.bfloat16)
        ones3, b3 = torch.ones(256, device="cuda"), mb(256)[1]
        onesh, bh = torch.ones(cout, device="cuda"), mb(cout)[1]
        raw = (w3, ones3, b3, wh, onesh, bh)
        kw = {"softmax_lanes": cout} if soft else {}
        ops = prep_head(*raw) if prep_head else None
        label = (f"head[bf16-{cout}{'-softmax' if soft else ''}] "
                 f"{B}x{Hc}x{Wc}")
        yield (label, lambda x=x, raw=raw, kw=kw: T.head(x, *raw, **kw),
               None if ops is None else
               (lambda x=x, ops=ops, kw=kw: T.head(x, ops, **kw)), "head")
    yield from _conv3x3_cases(rng, t, mb)
    yield from _render_cases()


ROUTES = [  # label, mode, fused, batch
    ("slice", "int8", True, 64), ("slice-bf16", "bf16", True, 64),
    ("slice-mixed", "mixed", True, 64), ("slice-unfused", "int8", False, 8),
    ("slice-unfused", "bf16", False, 8)]


def route_times() -> list:
    """ms per request of each route of ROUTES, and HA's mixed forward."""
    import time

    from spnerf_tpu_torch.kernels import _build
    from spnerf_tpu_torch.models.superpoint import (
        SuperPointConfig,
        init_superpoint,
    )
    from spnerf_tpu_torch.ops.fast_inference import build_inference
    from spnerf_tpu_torch.ops.serving import ServingSuperPoint

    _build.build_all(["conv12_fused", "double_conv3x3", "head", "conv3x3",
                      "dot_bias_act"])
    gen = torch.Generator(device="cuda").manual_seed(1)
    cfg = SuperPointConfig(det_thresh=0.015)
    model = init_superpoint(0, cfg, device="cuda")
    images = torch.rand((64, 480, 640, 1), generator=gen, device="cuda")
    rows = []
    for label, mode, fused, batch in ROUTES:
        infer = build_inference(cfg, model, images[:8], mode=mode,
                                fused_mid=fused, fused_tail=fused,
                                device="cuda", top_k=1024)
        x = images[:batch].contiguous()
        times = []
        for i in range(12):
            t0 = time.perf_counter()
            infer(x)
            torch.cuda.synchronize()
            if i >= 2:
                times.append((time.perf_counter() - t0) * 1e3)
        ms = statistics.median(times)
        rows.append({"route": label, "mode": mode, "batch": batch,
                     "ms_per_request": ms, "frames_per_s": batch / ms * 1e3,
                     "ms_all": times})
        print(json.dumps(rows[-1]), flush=True)
        del infer
    mp_cfg = SuperPointConfig(model_name="magicpoint")
    mp = init_superpoint(3, mp_cfg, device="cuda")
    views = torch.rand((80, 240, 320, 1), generator=gen, device="cuda")
    for mode in ("int8", "mixed"):  # HA routes (b) and (d)
        sp = ServingSuperPoint.build(mp_cfg, mp, views[:8], mode=mode,
                                     device="cuda")
        with torch.no_grad():
            fwd = [_events_ms(lambda: sp(views), 1, per_call=True)
                   for _ in range(5)]
        rows.append({"route": f"ha-{mode}-forward", "mode": mode,
                     "batch": 80, "ms_per_forward": statistics.median(fwd),
                     "ms_all": fwd})
        print(json.dumps(rows[-1]), flush=True)
        del sp
    return rows


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out", help="write the results here as JSON")
    parser.add_argument("--routes", action="store_true",
                        help="time the serving routes end to end")
    parser.add_argument("--match", default="",
                        help="comma-separated substrings: time only the "
                             "cases whose label holds one of them")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("kernel_times: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(card, flush=True)
    if args.routes:
        results = route_times()
        if args.out:
            with open(args.out, "w") as f:
                json.dump({"card": card, "routes": results}, f, indent=1)
        return 0
    from spnerf_tpu_torch.kernels import _build

    _build.build_all(["conv12_fused", "double_conv3x3", "head", "dot_bias_act",
                      "warp", "render", "conv3x3"])
    match = [m for m in args.match.split(",") if m]
    results = []
    for label, raw, prepared, symbol in _cases():
        if match and not any(m in label for m in match):
            continue
        for kind, fn in (("raw", raw), ("prepared", prepared)):
            if fn is None:
                continue
            kernels = device_kernels(fn)
            own = sum(ms for k, (ms, _) in kernels.items() if symbol in k)
            row = {"case": label, "call": kind,
                   "wrapper_ms": _events_ms(fn, REPS, per_call=True),
                   "back_to_back_ms": _events_ms(fn, REPS, per_call=False),
                   "device_ms": own if kernels else None,
                   "device_all_ms": (sum(ms for ms, _ in kernels.values())
                                     if kernels else None),
                   "kernels": {_short(k): v for k, v in kernels.items()}}
            results.append(row)
            print(json.dumps(row), flush=True)
        torch.cuda.empty_cache()
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": card, "results": results}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
