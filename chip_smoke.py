"""Smoke run of the PyTorch/CUDA port (spnerf_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (nothing is caught):

1. build the CUDA kernels from ``spnerf_tpu_torch/kernels/csrc`` with
   nvcc (one process per source, all at once) into ``build/``;
2. print the card's name and power limit (nvidia-smi);
3. run the int8 SuperPoint serving path once at 480 x 640, batch 64,
   recording the operands of every kernel call, then call each kernel
   on those operands and hold it against its plain PyTorch version
   (int8 exactly equal, bf16 within 1 ulp), timing the kernel, the plain
   version and the least time the card could take;
4. answer 5 requests of batch 64 through ``build_inference`` (seeded
   full-width SuperPoint, calibrated on 8 images, det_thresh 0.015,
   top_k = num_candidates = 1024) with the launch counters set to 0 just
   before, check the outputs and that every kernel launched 5 times,
   then time the serving graph apart from detection + sampling;
5. hold the CUDA graph against the plain path on the CPU on a small
   input.

The second-to-last line is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``. Without a CUDA device the script
exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import json
import statistics
import subprocess
import sys
import time

import torch
import torch.nn.functional as F

from spnerf_tpu_torch.kernels import _build
from spnerf_tpu_torch.kernels.conv12_fused import conv12_fused_plain
from spnerf_tpu_torch.kernels.mid_fused import double_conv3x3_plain
from spnerf_tpu_torch.kernels.tail_fused import head_plain
from spnerf_tpu_torch.models.superpoint import SuperPointConfig, init_superpoint
from spnerf_tpu_torch.ops import serving
from spnerf_tpu_torch.ops.fast_inference import (
    build_inference,
    detect_from_probs_padded,
    make_infer,
    sample_descriptors_onehot,
)

H, W = 480, 640
BATCH = 64
REQUESTS = 5
TOP_K = 1024
SEED = 0

# (dense int8 operations/s, memory bytes/s) from NVIDIA's data sheets;
# the first name found in the card's name applies
PEAKS = {
    "H100 PCIe": (1513e12, 2.0e12),
    "H100 NVL": (1671e12, 3.9e12),
    "H100": (1979e12, 3.35e12),
    "H200": (1979e12, 4.8e12),
}

# serving-module name of each wrapper -> (plain version, CUDA source,
# TPU kernel it replaces)
WRAPPERS = {
    "conv12_fused": (conv12_fused_plain,
                     "spnerf_tpu_torch/kernels/csrc/conv12_fused.cu",
                     "spnerf_tpu/kernels/conv12_fused_pallas.py:173"),
    "double_packed_conv3x3": (double_conv3x3_plain,
                              "spnerf_tpu_torch/kernels/csrc/double_conv3x3.cu",
                              "spnerf_tpu/kernels/mid_fused_pallas.py:133"),
    "double_conv3x3": (double_conv3x3_plain,
                       "spnerf_tpu_torch/kernels/csrc/double_conv3x3.cu",
                       "spnerf_tpu/kernels/tail_fused_pallas.py:99"),
    "head": (head_plain, "spnerf_tpu_torch/kernels/csrc/head.cu",
             "spnerf_tpu/kernels/tail_fused_pallas.py:179"),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def card_peaks(name: str):
    for key, peaks in PEAKS.items():
        if key in name:
            return peaks
    raise RuntimeError(f"chip_smoke: no data-sheet peaks for {name!r}")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def work(name, args, kw, out):
    """(int8 multiply-accumulates, bytes read once + written once) of one
    kernel call, from its operands' shapes."""
    if name == "conv12_fused":
        image, k1, _, _, w2 = args[:5]
        B, h, w, _ = image.shape
        macs = B * h * w * 9 * (1 + 64) * 64
    elif name in ("double_packed_conv3x3", "double_conv3x3"):
        x, w_a, _, _, w_b = args[:5]
        B, h, w, cin = x.shape
        macs = B * h * w * 9 * (cin * w_a.shape[-1]
                                + w_a.shape[-1] * w_b.shape[-1])
    else:  # head
        x, w3, _, _, w1 = args[:5]
        B, h, w, cin = x.shape
        macs = B * h * w * (9 * cin * w3.shape[-1] + w1.numel())
    return macs, nbytes(*args, out)


@contextlib.contextmanager
def recorded_calls(calls: list):
    """Record (wrapper name, args, kwargs) of every kernel call the
    serving graph makes."""
    saved = {name: getattr(serving, name) for name in WRAPPERS}

    def recorder(name, fn):
        def call(*args, **kw):
            calls.append((name, args, kw))
            return fn(*args, **kw)
        return call

    for name, fn in saved.items():
        setattr(serving, name, recorder(name, fn))
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(serving, name, fn)


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Median device time of ``fn()`` in ms over ``reps`` runs."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bf16_ulps(a: torch.Tensor, b: torch.Tensor) -> int:
    def ordered(t):
        bits = t.contiguous().view(torch.int16).to(torch.int32)
        return torch.where(bits >= 0, bits, -(bits & 0x7FFF))
    return int((ordered(a) - ordered(b)).abs().max())


def compare(name, got, want):
    """(max |got - want|, share of values that differ); raises unless
    int8 results are equal and bf16 results are within 1 ulp."""
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{name}: {tuple(got.shape)} {got.dtype} vs "
                             f"{tuple(want.shape)} {want.dtype}")
    err = float((got.float() - want.float()).abs().max())
    if got.dtype == torch.int8 and err != 0:
        n = int((got != want).sum())
        raise AssertionError(f"{name}: {n} int8 values differ (max {err})")
    if got.dtype == torch.bfloat16 and bf16_ulps(got, want) > 1:
        raise AssertionError(f"{name}: bf16 differs by "
                             f"{bf16_ulps(got, want)} ulps")
    return err, float((got != want).float().mean())


def synthetic_images(n: int, gen: torch.Generator) -> torch.Tensor:
    """(n, H, W, 1) float32 in [0, 1] on the card: smooth blobs from
    upsampled coarse noise plus fine grain, so that the backbone sees
    edges and corners rather than white noise."""
    coarse = torch.rand((n, 1, H // 16, W // 16), generator=gen, device="cuda")
    img = F.interpolate(coarse, size=(H, W), mode="bilinear",
                        align_corners=False)
    img = img + 0.05 * torch.rand((n, 1, H, W), generator=gen, device="cuda")
    return img.clamp(0, 1).permute(0, 2, 3, 1).contiguous()


def phase_build():
    t0 = time.perf_counter()
    reports = _build.build_all()
    log(f"[build] {len(reports)} CUDA sources built in "
        f"{time.perf_counter() - t0:.2f} s")
    for name, text in reports.items():
        for line in text.splitlines():
            if "Compiling entry" in line or "Used" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")


def phase_card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(out, flush=True)
    return out


def phase_kernels(calls, peaks):
    """Each recorded call: kernel against plain version on the same
    operands, with times and the bound."""
    int8_rate, mem_rate = peaks
    rows = []
    for name, args, kw in calls:
        plain, source, replaces = WRAPPERS[name]
        kernel = getattr(serving, name)
        before = _build.launch_counts.copy()
        got = kernel(*args, **kw)
        key, = (_build.launch_counts - before).keys()
        want = plain(*args, **kw)
        err, share = compare(key, got, want)
        ms = cuda_ms(lambda: kernel(*args, **kw), reps=20, warmup=3)
        plain_ms = cuda_ms(lambda: plain(*args, **kw), reps=3)
        macs, moved = work(name, args, kw, got)
        t_ops, t_bytes = 2 * macs / int8_rate * 1e3, moved / mem_rate * 1e3
        rows.append({
            "name": key, "route": "cuda", "source": source,
            "replaces": replaces, "launches": None, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            # no single PyTorch call computes a fused int8 conv chain with
            # its requantization (F.conv2d takes no int8 CUDA tensors)
            "library_ms": None,
        })
        log(f"[kernel] {key}: in {tuple(args[0].shape)} -> out "
            f"{tuple(got.shape)} {got.dtype}, max_abs_err {err} "
            f"({share:.3e} of values differ), kernel "
            f"{ms:.4f} ms (median of 20), plain {plain_ms:.4f} ms, bound "
            f"{rows[-1]['bound_ms']:.4f} ms ({rows[-1]['bound_by']}, "
            f"{2 * macs / 1e9:.2f} GOP, {moved / 1e6:.1f} MB)")
        del got, want
        torch.cuda.empty_cache()
    return rows


def check_outputs(pts, scores, valid, desc):
    expect = {"pts": (BATCH, TOP_K, 2), "scores": (BATCH, TOP_K),
              "valid": (BATCH, TOP_K), "desc": (BATCH, TOP_K, 256)}
    for key, t in zip(expect, (pts, scores, valid, desc)):
        if tuple(t.shape) != expect[key]:
            raise AssertionError(f"{key}: shape {tuple(t.shape)}")
    if not (torch.isfinite(pts).all() and torch.isfinite(scores).all()
            and torch.isfinite(desc).all()):
        raise AssertionError("non-finite outputs")
    if not valid.any(dim=1).all():
        raise AssertionError("an image has no valid keypoint")
    norms = desc[valid].norm(dim=-1)
    if float((norms - 1).abs().max()) > 1e-3:
        raise AssertionError("descriptors at valid points are not unit norm")


def phase_split(infer, images, cfg):
    """Device time of the serving graph and of detection + sampling, one
    request each, apart."""
    out = infer.serving(images, softmax=True)

    def post():
        pts, _, _ = detect_from_probs_padded(
            out["probs"], cfg.grid_size, min_prob=cfg.det_thresh,
            size=cfg.nms, top_k=TOP_K, num_candidates=TOP_K, compact=False)
        sample_descriptors_onehot(out["desc_raw"], pts, cfg.grid_size)

    graph_ms = cuda_ms(lambda: infer.serving(images, softmax=True), reps=5)
    post_ms = cuda_ms(post, reps=5)
    log(f"[split] batch {BATCH}: serving graph {graph_ms:.4f} ms, detect + "
        f"descriptor sampling {post_ms:.4f} ms (medians of 5)")


def phase_slice(infer, requests):
    """Answer the requests with every launch counter at 0 before."""
    infer(requests[0])  # warm-up: library handles, allocator pools
    torch.cuda.synchronize()
    _build.launch_counts.clear()
    times, outs = [], None
    t_all = time.perf_counter()
    for images in requests:
        t0 = time.perf_counter()
        outs = infer(images)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    total = time.perf_counter() - t_all
    counts = dict(_build.launch_counts)
    check_outputs(*outs)
    n_valid = int(outs[2].sum())
    log(f"[slice] {len(requests)} requests of batch {BATCH} at {H}x{W}: "
        f"{total:.4f} s, {len(requests) * BATCH / total:.2f} frames/s; "
        f"per request (s): {', '.join(f'{t:.4f}' for t in times)}; "
        f"median {statistics.median(times) * 1e3:.3f} ms; "
        f"{n_valid} valid keypoints in the last request")
    log(f"[slice] launches: {json.dumps(counts, sort_keys=True)}")
    per_family = {"conv12_fused": 1, "double_conv3x3": 3, "head": 2}
    for family, per_request in per_family.items():
        n = sum(v for k, v in counts.items() if k.startswith(family))
        if n != per_request * len(requests):
            raise AssertionError(f"{family}: {n} launches, expected "
                                 f"{per_request} per request")
    return counts


def phase_small_reference(sp_cuda, cfg):
    """The CUDA graph against the plain path on the CPU (same weights and
    scales) on 2 images of 64 x 128."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    x = synthetic_images(2, gen)[:, :64, :128].contiguous()
    sp_cpu = serving.ServingSuperPoint(
        {k: {n: t.cpu() for n, t in v.items()} for k, v in sp_cuda.params.items()},
        {k: v.cpu() for k, v in sp_cuda.act_scales.items()},
        sp_cuda.has_descriptor, device="cpu")
    got, want = sp_cuda(x, softmax=True), sp_cpu(x.cpu(), softmax=True)
    for key in ("probs", "desc_raw"):
        ulps = bf16_ulps(got[key].cpu(), want[key])
        if ulps > 1:
            raise AssertionError(f"small input: {key} differs by {ulps} ulps")
    n_all = 8 * 16 * 64  # every pixel a candidate: sets independent of ties
    sets = []
    for probs in (got["probs"], got["probs"].cpu()):
        pts, _, valid = detect_from_probs_padded(
            probs, cfg.grid_size, min_prob=cfg.det_thresh, size=cfg.nms,
            num_candidates=n_all, top_k=n_all, compact=False)
        sets.append({tuple(p) for p in pts[valid].cpu().tolist()})
    if sets[0] != sets[1] or not sets[0]:
        raise AssertionError("small input: keypoint sets differ")
    pts = pts.cpu()
    d_cuda = sample_descriptors_onehot(got["desc_raw"], pts.cuda()).cpu()
    d_cpu = sample_descriptors_onehot(got["desc_raw"].cpu(), pts)
    cos = float((d_cuda * d_cpu).sum(-1).min())
    if cos < 0.999:
        raise AssertionError(f"small input: descriptor cosine {cos}")
    # the whole CPU path, once, as a user would call it
    make_infer(sp_cpu, cfg, TOP_K)(x.cpu())
    log(f"[small] 2x64x128: probs/desc_raw within 1 bf16 ulp of the CPU "
        f"plain path, {len(sets[0])} keypoints equal, min descriptor "
        f"cosine {cos:.6f}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    phase_build()
    card = phase_card()
    peaks = card_peaks(torch.cuda.get_device_name(0))
    log(f"[card] peaks used for bounds: {peaks[0] / 1e12:.0f} int8 TOP/s, "
        f"{peaks[1] / 1e12:.2f} TB/s ({card})")

    cfg = SuperPointConfig(det_thresh=0.015)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    model = init_superpoint(SEED, cfg, device="cuda")
    requests = [synthetic_images(BATCH, gen) for _ in range(REQUESTS)]
    t0 = time.perf_counter()
    infer = build_inference(cfg, model, requests[0][:8], device="cuda",
                            top_k=TOP_K)
    log(f"[setup] built and calibrated on 8 images in "
        f"{time.perf_counter() - t0:.3f} s")

    calls = []
    with recorded_calls(calls):
        infer.serving(requests[0], softmax=True)
    torch.cuda.synchronize()
    rows = phase_kernels(calls, peaks)

    counts = phase_slice(infer, requests)
    phase_split(infer, requests[1], cfg)
    for row in rows:
        row["launches"] = counts.get(row["name"], 0)
        if row["launches"] == 0:
            raise AssertionError(f"{row['name']} never launched on the path")
    phase_small_reference(infer.serving, cfg)

    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
