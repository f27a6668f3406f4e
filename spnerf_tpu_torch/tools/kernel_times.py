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
with the early stop, the same widths with float32 weights (with their
bounds: on the float32 CUDA cores and as three TF32 passes), and beside
int8 its yardstick, three ``torch._int_mm`` over all (ray, sample) rows,
beside each float32 width three float32 ``torch.matmul`` (TF32 off);
``conv3x3`` / ``packed_conv3x3`` at the per-layer route's instances,
int8 and bf16, batch 8 at 480 x 640; the descriptor loss's forward
sums and its two gradients, dA and dB, each alone, at the training
step's shape (B 2, N = M = 1,200, C 256) and at 480 x 640 (N 4,800), on
``hinge_operands``' seeded descriptors and pair homographies, and at
480 x 640 on ``nerf_hinge_operands``' depth-reprojected cells with 64
non-finite and 64 far-off ones (``--match desc_loss``); the fused
descriptor sampler (row 8) at a request's sampling operands, batch 64, a
60 x 80 x 256 map and K 1,024 seeded points spread as a request's
candidates or 1,000 spread evenly, bf16 and float32, and a 480 x 960
frame's bf16 map at batch 8 (``--match desc_sample``);
``--match conv12,warp`` keeps the cases whose label holds one of the
substrings; ``--match probe_conv`` times the conv probe apart, below)
it prints, in ms per call:

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

``--match probe_conv [--parent DIR ...]`` times ``kernels/probe_conv.py``
at P1's and P2's shapes (every instance at the first probe shape that
runs it, 480 bands; acc9 also at P2's concat shapes; the three
instances the probes never run at P1's) and, with ``--parent``, the same
function from other trees of the repository (each ``DIR`` e.g. ``git
archive`` of an earlier commit, or a copy with a design variant,
unpacked under ``build/``; rows name it by the directory's name),
imported as a module of its own and built into ``DIR/build``, on the
same operands, in turns (the parents, change, change, the parents in
reverse; device ms by the profiler), each one's output held against the
change's (int8 bit-equal, bf16 within 1 ulp). The change's output is
also held against the plain version; a tree whose wrapper refuses an
instance (``ValueError``) is left out of its row. Each row carries the bound, the share of it, the
grid, the weight bytes the schedule asks of L2 (``weight_l2_bytes_model``:
counted from the schedule, not measured), and the host time of a call
(the tensor map's encoding included). ``--match probe_chain`` and
``--match probe_gather`` (comma-joined with the others in one call) do
the same for the chain probe (P3: bf16 and int8 at the probe's all-ones
R 8,192, depth 32 and depth 1, bit-equal to the plain version) and the
three gathers (P4: rows, columns, in-rows at the TPU file's sizes and
past the L2, the column form also with 2^18 x 128 indices into tables of
2^12 and 2^17 rows; bit-equal), each row with its bound and share; a column
row also carries the HBM bytes each traversal's schedule asks for, flat
and slab by slab (``probe_gather.column_hbm_bytes_model``: counted under
its stated rule, not measured).

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


# superpoint_coco_train.yaml's pair homography (chip_smoke.TRAIN_CONFIG
# takes it from here): the warp between the two views of a training pair
PAIR_HOMOGRAPHY = {"translation": True, "rotation": True, "scaling": True,
                   "perspective": True, "scaling_amplitude": 0.2,
                   "n_scales": 5, "n_angles": 25,
                   "perspective_amplitude_x": 0.2,
                   "perspective_amplitude_y": 0.2, "patch_ratio": 0.85,
                   "max_angle": 1.57, "allow_artifacts": True,
                   "translation_overflow": 0.0}
# the descriptor loss at the training step's shape (batch 2 at 240 x 320:
# 30 x 40 cells) and at 480 x 640, C 256
HINGE_SHAPES = ((2, 30, 40, 256), (2, 60, 80, 256))


def hinge_operands(B, Hc, Wc, C, seed, device="cuda"):
    """Operands of ``descriptor_hinge_sums`` as a training step at
    (Hc * 8) x (Wc * 8) makes them, from seeded descriptors (scaled like
    the trained head's raw output, so that dots straddle both margins)
    and sampled pair homographies: (A, Bm, wcells, cells, mask, lambda_d,
    pos_margin, neg_margin, radius)."""
    from spnerf_tpu_torch.geometry.homography import (
        HomographyConfig,
        sample_homographies,
        warp_points,
    )
    from spnerf_tpu_torch.ops.image_warp import compute_valid_mask
    from spnerf_tpu_torch.train.losses import _cell_mask, cell_grid_coords

    gen = torch.Generator(device=device).manual_seed(seed)
    N = Hc * Wc
    A, Bm = (0.08 * torch.randn((B, N, C), generator=gen, device=device)
             for _ in range(2))
    homs = sample_homographies(torch.Generator().manual_seed(seed), B,
                               (Hc * 8, Wc * 8),
                               HomographyConfig.from_dict(PAIR_HOMOGRAPHY))
    homs = homs.to(device)
    cells = cell_grid_coords(Hc, Wc, 8, device=device)
    mask = _cell_mask(compute_valid_mask((Hc * 8, Wc * 8), homs, 3),
                      8).reshape(B, N)
    return (A, Bm, warp_points(cells, homs), cells, mask, 250.0, 1.0, 0.2,
            8.0)


def plant_bad_cells(wcells: torch.Tensor, n_bad: int, seed: int):
    """A copy of (B, N, 2) warped cells with ``n_bad`` rows of each sample
    non-finite (NaN, +inf, -inf in turn, in one coordinate or both) and
    ``n_bad`` far off the image (1e4 to 1e7 px either side): what a depth
    reprojection gives for a point of depth 0 or one behind the target
    camera, which the reference does not mask either."""
    rng = np.random.default_rng(seed)
    out = wcells.clone()
    B, N, _ = out.shape
    bad = [float("nan"), float("inf"), float("-inf")]
    for b in range(B):
        rows = torch.from_numpy(rng.permutation(N)[:2 * n_bad])
        for k, r in enumerate(rows[:n_bad].tolist()):
            value = bad[k % 3]
            out[b, r, k % 2] = value
            if k % 4 < 2:
                out[b, r, 1 - k % 2] = value
        far = (rng.choice([-1.0, 1.0], (n_bad, 2))
               * 10.0 ** rng.uniform(4, 7, (n_bad, 2)))
        out[b, rows[n_bad:]] = torch.from_numpy(far).float().to(out.device)
    return out


def nerf_geometry(n: int, H: int, W: int, seed: int, device="cuda"):
    """n seeded cameras before a slanted wall with a box in front, float32
    on ``device``: (along-ray depth (n, H, W), intrinsics (n, 3, 3) at fov
    44, rotations (n, 3, 3) about the vertical within 0.12 rad,
    translations (n, 3, 1) of about 0.1)."""
    from spnerf_tpu_torch.geometry.reprojection import intrinsics_from_fov

    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.linspace(0, 1, H), np.linspace(0, 1, W),
                         indexing="ij")
    depth = 3.0 + 0.8 * xx + 0.3 * yy + rng.uniform(0, 0.2, (n, 1, 1))
    depth[:, H // 3:H // 2, W // 4:W // 2] -= 1.2
    angles = rng.uniform(-0.12, 0.12, n)
    rot = np.stack([[[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                     [-np.sin(a), 0, np.cos(a)]] for a in angles])
    t = lambda a: torch.from_numpy(a).float().to(device)  # noqa: E731
    K = intrinsics_from_fov((H, W), 44.0, device=device).expand(n, 3, 3)
    return t(depth), K.contiguous(), t(rot), t(rng.normal(0, 0.1, (n, 3, 1)))


def nerf_hinge_operands(B, Hc, Wc, C, seed, device="cuda", n_bad=64):
    """Operands of ``descriptor_hinge_sums`` as a NeRF step makes them:
    the cell centres reprojected by ``warp_points_nerf`` through
    ``nerf_geometry``'s first B depth maps and cameras into its last B
    cameras, valid masks of ones, descriptors as ``hinge_operands``'; with
    ``n_bad`` > 0 ``plant_bad_cells`` on top."""
    from spnerf_tpu_torch.geometry.reprojection import warp_points_nerf
    from spnerf_tpu_torch.train.losses import cell_grid_coords

    depth, K, R, t = nerf_geometry(2 * B, Hc * 8, Wc * 8, seed, device)
    cells = cell_grid_coords(Hc, Wc, 8, device=device)
    wcells = warp_points_nerf(cells, depth[:B], K[:B], R[:B], t[:B], R[B:],
                              t[B:])
    if n_bad:
        wcells = plant_bad_cells(wcells, n_bad, seed)
    gen = torch.Generator(device=device).manual_seed(seed)
    A, Bm = (0.08 * torch.randn((B, Hc * Wc, C), generator=gen, device=device)
             for _ in range(2))
    mask = torch.ones((B, Hc * Wc), dtype=torch.float32, device=device)
    return (A, Bm, wcells.contiguous(), cells, mask, 250.0, 1.0, 0.2, 8.0)


def _desc_loss_cases():
    """The descriptor loss's three calls at ``HINGE_SHAPES``: the forward
    sums, and the gradient with respect to A (dA) and to Bm (dB) alone,
    each from one forward kept for the timed backward calls."""
    from spnerf_tpu_torch.kernels import descriptor_loss as dl

    shapes = [(s, "", hinge_operands) for s in HINGE_SHAPES]
    shapes.append((HINGE_SHAPES[1], " nerf", nerf_hinge_operands))
    for (B, Hc, Wc, C), kind, operands in shapes:
        A, Bm, wcells, cells, mask, *params = operands(B, Hc, Wc, C, 0)
        N = Hc * Wc
        g = torch.linspace(0.5, 1.5, B, device="cuda")
        yield (f"desc_loss[fwd] B {B} N {N} C {C}{kind}",
               lambda A=A, Bm=Bm, wcells=wcells, cells=cells, mask=mask,
               params=params: dl.descriptor_hinge_sums(
                   A, Bm, wcells, cells, mask, *params), None, "hinge_")
        for key, wrt in (("dA", 0), ("dB", 1)):
            ops = [A, Bm]
            ops[wrt] = ops[wrt].clone().requires_grad_()
            s_pair = dl.descriptor_hinge_sums(*ops, wcells, cells, mask,
                                              *params)[0]
            yield (f"desc_loss[{key}] B {B} N {N} C {C}{kind}",
                   lambda s=s_pair, x=ops[wrt], g=g: torch.autograd.grad(
                       (s * g).sum(), x, retain_graph=True), None, "hinge_")


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
    for width in (128, 64, 32):  # the float32 instances (render_f32_kernel)
        f = fields[width]
        ws = [w.float() for w in f.ws]
        if width == 128:
            call = (lambda f=f, ws=ws: R.render_fused(f.oe, f.de, *ws, f.df,
                                                       **f.kw))
        else:
            call = (lambda f=f, ws=ws, width=width: R.render_fused_packed(
                f.oe, f.de, *ws, f.df, width=width, **f.kw))
        yield (f"render[f32{'' if width == 128 else f'-w{width}'}] early stop "
               f"{n}", call, None, "render", f32_render_bounds(f, ws))
        # its yardstick: the three products alone in float32 (TF32 off)
        # over every (ray, sample) row
        x = torch.zeros((RENDER_RAYS * RENDER_SAMPLES, ws[0].shape[0]),
                        device="cuda")
        yield (f"render[f32{'' if width == 128 else f'-w{width}'}] yardstick: "
               f"three float32 torch.matmul {n}",
               lambda x=x, ws=ws: _matmuls_f32(x, ws), None, "")
        del x


# an H100 SXM's data-sheet rates: float32 on the CUDA cores, TF32 dense
F32_RATE, TF32_RATE = 67e12, 494.5e12


def f32_render_bounds(f, ws) -> dict:
    """The float32 render's bounds at a drive field's operands, from the
    (ray, sample) pairs its early stop leaves (the plain version's count):
    2 (2 W^2 + 4 W) FLOP a pair on the float32 CUDA cores, and the same
    float32-grade work as three TF32 passes on the tensor cores (rows
    10-11's two yardsticks), in ms."""
    from spnerf_tpu_torch.kernels import render as R

    W, packed = ws[0].shape[0], ws[0].shape[0] != 128
    kw = dict(f.kw)
    chunk = kw.pop("s_chunk") * (128 // W if packed else 1)
    pairs = R.render_plain_counted(
        f.oe, f.de, f.df, R.float_mlp_head(*ws, packed), width=W, chunk=chunk,
        flags=None, packed=packed, **kw)[2]
    flop = 2 * pairs * (2 * W * W + 4 * W)
    return {"pairs": pairs, "bound_f32_ms": flop / F32_RATE * 1e3,
            "bound_tf32_ms": 3 * flop / TF32_RATE * 1e3}


def _matmuls_f32(x, ws):
    """x @ w1 @ w2 @ w3 in float32 with TF32 off."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for w in ws:
            x = x @ w
        return x
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


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
    yield from _desc_loss_cases()
    yield from _desc_sample_cases()


# row 8 at a [slice] request's sampling operands (batch 64, 480 x 640: a
# 60 x 80 x 256 map, 1,024 candidates) and micro_desc_sample.py's K 1,000
DESC_SAMPLE_SHAPE, DESC_SAMPLE_KS = (64, 60, 80, 256), (1024, 1000)
HBM_RATE = 3.35e12  # an H100 SXM's data-sheet bytes/s


def desc_sample_points(rng, B, Hc, Wc, K, spread):
    """(B, K, 2) float32 (y, x) pixels over frames of Hc x Wc cells of 8
    px: ``uniform``, as ``micro_desc_sample.py`` draws them, or
    ``request``, crowded into blobs of rows as a [slice] request's
    candidates are (``chip_smoke.py``'s ``[desc-sample]`` prints how
    unevenly they fill two equal bands): a point's cell row is drawn with
    weights of a gamma(1) draw per 6 rows times a gamma(2) draw per row,
    its pixels within the row and across the width uniformly."""
    h, w = Hc * 8 - 1, Wc * 8 - 1
    if spread == "uniform":
        y = rng.uniform(0, h, (B, K))
    else:
        weight = (np.repeat(rng.gamma(1.0, size=(B, -(-Hc // 6))), 6, 1)[:, :Hc]
                  * rng.gamma(2.0, size=(B, Hc)))
        rows = np.stack([rng.choice(Hc, K, p=p / p.sum()) for p in weight])
        y = np.clip(8 * rows + rng.uniform(3.5, 11.5, (B, K)), 0, h)
    return np.stack([y, rng.uniform(0, w, (B, K))], -1).astype(np.float32)


def _desc_sample_cases():
    """Row 8 (``sample_descriptors_fused``, normalized) on seeded maps: the
    bf16 map at K 1,024 with points spread as a request's candidates and
    at K 1,000 spread evenly, the same map in float32, and a 480 x 960
    frame's bf16 map (rows too wide for the ring: the gather instance),
    each with its bound (map, points and float32 output moved once at
    3.35 TB/s)."""
    from spnerf_tpu_torch.kernels import desc_sample as ds

    rng = np.random.default_rng(17)
    B, Hc, Wc, C = DESC_SAMPLE_SHAPE
    cases = [("bf16", Wc, DESC_SAMPLE_KS[0], "request"),
             ("bf16", Wc, DESC_SAMPLE_KS[1], "uniform"),
             ("f32", Wc, DESC_SAMPLE_KS[0], "request"),
             ("bf16 480x960", 2 * Wc, DESC_SAMPLE_KS[0], "request")]
    for kind, wc, K, spread in cases:
        b = 8 if wc != Wc else B
        desc = torch.from_numpy(rng.standard_normal(
            (b, Hc, wc, C)).astype(np.float32)).cuda().to(
                torch.float32 if kind == "f32" else torch.bfloat16)
        pts = torch.from_numpy(desc_sample_points(rng, b, Hc, wc, K, spread)).cuda()
        moved = (desc.numel() * desc.element_size() + pts.numel() * 4
                 + b * K * C * 4)
        yield (f"desc_sample {kind} {b}x{Hc}x{wc}x{C} K {K} {spread}",
               lambda desc=desc, pts=pts: ds.sample_descriptors_fused(desc, pts),
               None, "desc_sample",
               {"bytes": moved, "bound_ms": moved / HBM_RATE * 1e3})


PEAK_OPS = {"int8": 1979e12, "bf16": 989e12}  # an H100 SXM's dense tensor-core rates
# acc9 at P2's concat shapes where P1's differ (the tap-order ratio at
# equal shapes), and the instances the probe files never run, at P1's
PROBE_CONV_EXTRA = [("bf16", "acc9", 128, 16, 640), ("int8", "acc9", 256, 16, 320),
                    ("int8", "concat", 64, 8, 640), ("bf16", "concat", 64, 8, 640),
                    ("bf16", "concat", 256, 8, 320)]


def _load_parent(root: Path, names: list) -> dict:
    """``kernels/<name>.py`` of the tree at ``root`` for each name, as
    modules of their own over one copy of that tree's ``_build`` (its
    libraries built under ``root/build``); {name: module}."""
    import importlib.util

    from spnerf_tpu_torch import kernels as pkg

    def load(name, path):
        spec = importlib.util.spec_from_file_location(name, path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module

    kernels = root / "spnerf_tpu_torch" / "kernels"
    build = load("parent_probe_build", kernels / "_build.py")
    own = pkg._build
    pkg._build = build  # the parent's `from spnerf_tpu_torch.kernels import _build`
    try:
        return {name: load(f"parent_{name}", kernels / f"{name}.py") for name in names}
    finally:
        pkg._build = own


def _host_us(fn, reps: int = 50) -> float:
    """Host microseconds a call (enqueue only), median of ``reps``."""
    import time

    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e6)
    torch.cuda.synchronize()
    return statistics.median(times)


def _parent_trees(parents: list, name: str) -> dict:
    """{tree's directory name: its module ``name``}, every tree's library
    and this tree's built at once."""
    import threading

    from spnerf_tpu_torch.kernels import _build

    trees = {Path(p).name: _load_parent(Path(p), [name])[name] for p in parents}
    builds = [threading.Thread(target=b.build_all, args=([name],))
              for b in [_build] + [m._build for m in trees.values()]]
    for b in builds:
        b.start()
    for b in builds:
        b.join()
    return trees


def _ab_turns(row: dict, new_fn, others: list, symbol: str) -> dict:
    """Time the parents, change, change, the parents in reverse on the
    same operands: device ms of the kernels whose symbol holds
    ``symbol`` (profiler), ms around a call (events), host us a call; the
    share of ``row["bound_ms"]`` at the change's best device time."""
    turns = others + [("change", new_fn), ("change", new_fn)] + others[::-1]
    for kind, fn in turns:
        kernels = device_kernels(fn)
        dev = sum(ms for k, (ms, _) in kernels.items() if symbol in k)
        row.setdefault(f"{kind}_device_ms", []).append(dev if kernels else None)
        row.setdefault(f"{kind}_wrapper_ms", []).append(_events_ms(fn, REPS, per_call=True))
        row.setdefault(f"{kind}_host_us", []).append(_host_us(fn))
    seen = [v for v in row["change_device_ms"] if v is not None]
    row["share_of_bound"] = row["bound_ms"] / min(seen) if seen and min(seen) else None
    print(json.dumps(row), flush=True)
    return row


def _others(trees: dict, label: str, call, got, check) -> list:
    """[(tree, fn)] of the trees whose wrapper takes the case, each one's
    output held against the change's by ``check``."""
    others = []
    for name, mod in trees.items():
        fn = lambda m=mod: call(m)  # noqa: E731
        try:
            old = fn()
        except ValueError:  # no such instance in that tree
            continue
        check(f"{name} {label}", old, got)
        others.append((name, fn))
    return others


def probe_conv_ab(parents: list) -> list:
    """The conv probe at P1's and P2's shapes, and the parent trees' on
    the same operands (module docstring)."""
    from spnerf_tpu_torch.kernels import probe_conv as P
    from spnerf_tpu_torch.probes.micro_conv2 import conv_operands
    from spnerf_tpu_torch.tools.smoke_probes import check, conv_cases

    trees = _parent_trees(parents, "probe_conv")
    rows = []
    for dtype, order, C, Hb, W in conv_cases() + PROBE_CONV_EXTRA:
        n = 480
        x, w9 = conv_operands(C, dtype, Hb, W, n)
        w = w9.reshape(9 * C, C) if order == "concat" else w9
        label = f"{P.launch_key(x, order)} {n}x{Hb}x{W + 2}"
        new_fn = lambda x=x, w=w, order=order: P.probe_conv(x, w, order)  # noqa: E731
        got = new_fn()
        es = x.element_size()
        cfg = P.kernel_config(es, C, order == "concat")
        grid = P.launch_grid(x, order)
        ops = 2 * n * Hb * W * 9 * C * C
        moved = (x.numel() + w.numel() + got.numel()) * es
        bound = max(ops / PEAK_OPS[dtype], moved / HBM_RATE) * 1e3
        check(f"plain {label}", got, P.probe_conv_plain(x, w, order))
        others = _others(trees, label, lambda m, x=x, w=w, order=order: m.probe_conv(x, w, order),
                         got, check)
        row = {"case": label, "dtype": dtype, "order": order, "C": C,
               "shape": [n, Hb, W + 2, C], "bound_ms": bound,
               "bound_by": "operations" if ops / PEAK_OPS[dtype] >= moved / HBM_RATE
               else "bytes", "grid": grid, "weight_l2_bytes_model":
               P.weight_l2_bytes_model(n * Hb * -(-W // 64), cfg, grid),
               "resident_weights": cfg["res"], "cluster": cfg["cl"]}
        rows.append(_ab_turns(row, new_fn, others, "probe_conv_kernel"))
        del x, w, w9, got
        torch.cuda.empty_cache()
    return rows


def probe_chain_ab(parents: list) -> list:
    """The chain probe (P3) at ``mxu_probe.chain``'s operands (all ones,
    R 8,192) at depth 32 and at depth 1 (the fixed cost: w staged, x
    read, the last layer written), bf16 and int8, beside the parent
    trees'; every output bit-equal to the change's and to the plain
    version's."""
    from spnerf_tpu_torch.kernels import probe_chain as P
    from spnerf_tpu_torch.probes.mxu_probe import DTYPES
    from spnerf_tpu_torch.tools.smoke_probes import CHAIN_ROWS, check_equal_bits

    trees = _parent_trees(parents, "probe_chain")
    rows = []
    for dtype in ("bf16", "int8"):
        for depth in (32, 1):
            x = torch.ones((CHAIN_ROWS, P.K), dtype=DTYPES[dtype], device="cuda")
            w = torch.ones((P.K, P.K), dtype=DTYPES[dtype], device="cuda")
            label = f"{P.launch_key(x)} R {CHAIN_ROWS} depth {depth}"
            new_fn = lambda x=x, w=w, depth=depth: P.probe_chain(x, w, depth)  # noqa: E731
            got = new_fn()
            check_equal_bits(f"plain {label}", got, P.probe_chain_plain(x, w, depth))
            others = _others(trees, label, lambda m, x=x, w=w, depth=depth:
                             m.probe_chain(x, w, depth), got, check_equal_bits)
            ops = 2 * CHAIN_ROWS * P.K * P.K * depth
            moved = (2 * x.numel() + w.numel()) * x.element_size()
            t_ops, t_bytes = ops / PEAK_OPS[dtype] * 1e3, moved / HBM_RATE * 1e3
            row = {"case": label, "dtype": dtype, "rows": CHAIN_ROWS, "depth": depth,
                   "bound_ms": max(t_ops, t_bytes),
                   "bound_by": "operations" if t_ops >= t_bytes else "bytes"}
            rows.append(_ab_turns(row, new_fn, others, "probe_chain_kernel"))
    return rows


# tables of 2^12 rows (2 MB: all of it in L2) and 2^17 (64 MB) for the
# column gather's 2^18 x 128 indices, beside the probe's 2^18 rows
COLUMN_TABLES = (1 << 12, 1 << 17)


def column_operands(T: int, N: int = 1 << 18, F: int = 128):
    """``gather_probe.operands``' column table (T, F) with (N, F) indices
    from ``np.random.default_rng(0)``."""
    table = (torch.arange(T * F, device="cuda") % 997).float().reshape(T, F)
    idx = np.random.default_rng(0).integers(0, T, (N, F)).astype(np.int32)
    return table, torch.from_numpy(idx).cuda()


def probe_gather_ab(parents: list) -> list:
    """The three gathers (P4) at ``gather_probe``'s operands, the TPU
    file's sizes and past the L2, and the column form at the
    ``COLUMN_TABLES``, beside the parent trees'; every output bit-equal
    to the change's and to the plain version's. The column rows also
    carry the HBM bytes each traversal's schedule asks for
    (``column_hbm_bytes_model``: counted, not measured)."""
    from spnerf_tpu_torch.kernels import probe_gather as P
    from spnerf_tpu_torch.probes import gather_probe
    from spnerf_tpu_torch.tools.smoke_probes import PLAIN_GATHERS, check_equal_bits

    trees = _parent_trees(parents, "probe_gather")
    calls = {"rows": "gather_rows", "columns": "gather_columns", "in-rows": "gather_in_rows"}
    cases = [(name, form, where, lambda f=form, sh=shape: gather_probe.operands(f, "cuda", **sh))
             for name, form, size in gather_probe.PROBES
             for where, shape in (("file", size), ("past L2", gather_probe.PAST_L2[form]))]
    cases += [("take_along_axis sublane", "columns", f"table {T}", lambda T=T: column_operands(T))
              for T in COLUMN_TABLES]
    rows = []
    for name, form, where, make in cases:
        src, idx = make()
        label = f"{P.launch_key(form)} {where} {tuple(src.shape)} x {tuple(idx.shape)}"
        new_fn = lambda f=getattr(P, calls[form]), s=src, i=idx: f(s, i)  # noqa: E731
        got = new_fn()
        check_equal_bits(f"plain {label}", got, PLAIN_GATHERS[form](src, idx))
        others = _others(trees, label, lambda m, c=calls[form], s=src, i=idx:
                         getattr(m, c)(s, i), got, check_equal_bits)
        moved = gather_probe.moved_bytes(form, src, idx)
        row = {"case": label, "form": form, "probe": name, "moved_bytes": moved,
               "bound_ms": moved / HBM_RATE * 1e3, "bound_by": "bytes"}
        if form == "columns":
            row["hbm_bytes_model"] = {order: P.column_hbm_bytes_model(idx, src.shape[0], order)
                                      for order in ("flat", "slabs")}
        rows.append(_ab_turns(row, new_fn, others, "gather_"))
        del src, idx, got, new_fn, others
        torch.cuda.empty_cache()
    return rows


PROBE_ABS = {"probe_conv": probe_conv_ab, "probe_chain": probe_chain_ab,
             "probe_gather": probe_gather_ab}


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
    parser.add_argument("--parent", action="append", default=[],
                        help="with --match probe_conv, probe_chain or "
                        "probe_gather: the root of another "
                        "tree of the repository to time beside this one "
                        "(may be given more than once)")
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
    match = [m for m in args.match.split(",") if m]
    probes = {m: PROBE_ABS[m](args.parent) for m in match if m in PROBE_ABS}
    if probes:
        if args.out:
            with open(args.out, "w") as f:
                json.dump({"card": card, **probes}, f, indent=1)
        match = [m for m in match if m not in PROBE_ABS]
        if not match:
            return 0
    from spnerf_tpu_torch.kernels import _build

    _build.build_all(["conv12_fused", "double_conv3x3", "head", "dot_bias_act",
                      "warp", "render", "conv3x3", "descriptor_loss",
                      "desc_sample"])
    results = []
    for label, raw, prepared, symbol, *extra in _cases():
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
                   "kernels": {_short(k): v for k, v in kernels.items()},
                   **(extra[0] if extra else {})}
            results.append(row)
            print(json.dumps(row), flush=True)
        torch.cuda.empty_cache()
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": card, "results": results}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
