"""Fused volume render of the tiny NeRF field (the serving renderer).

``render_fused``, ``render_fused_int8`` and ``render_fused_packed``
replace the three Pallas kernels of ``spnerf_tpu/kernels/
render_pallas.py`` (``render_fused`` :150, ``_render_fused_int8`` :425,
``render_fused_packed`` :726) with the CUDA kernels of ``csrc/render.cu``
(see its header for the bound and the design). Per ray and sample s::

    t_s  = near + (s + jitter) * dt,          dt = (far - near) / n_samples
    enc  = sin(oe + t_s * de)
    h    = relu(enc @ w1);  h = relu(h @ w2 + df);  head = h @ w3
    sigma, rgb = head[0], sigmoid(head[1:4])
    alpha = 1 - exp(-relu(sigma) * dt);  w = T * alpha;  T *= 1 - alpha
    rgb_out += w * rgb;  depth_out += w * t_s

``enc`` and both hidden activations are rounded to the weights' dtype
(float32: nothing is rounded; bf16) before each product, sums are float32.
The int8 variant quantizes them instead (``quantize_field``); the packed
variant (widths 64 and 32) also rounds the head and takes its weights from
``exp(-tau) - exp(-(tau + sigma dt))`` with the optical depth tau carried.
The sine is taken directly on each sample's argument, where the TPU kernel
rotates by the angle-addition recurrence; the two agree to the rounding of
the argument (tests/test_torch_render.py states the gap).

Skipping. ``flags`` (int32, (ceil(N / block), n_samples / chunk)) covers
``block`` consecutive rays and one chunk of samples: a ray whose flag is 0
does not composite that chunk. The early stop (``early_stop_eps`` > 0)
works on a tile of ``tile_rays(width)`` consecutive rays (64 at width 128,
128 at 64, 256 at 32; the TPU kernel's tile is ``block``): after the first
chunk, a chunk is computed only while some ray of the tile whose flag is
set has transmittance above eps (output error at most eps per channel).
Rays past N are not padded and rendered, so they never keep a tile open.

Each wrapper launches its kernel on CUDA tensors (or raises) and runs its
plain version, which repeats the kernel's arithmetic, roundings, flags and
early stop in PyTorch ops, on CPU tensors. ``pack_field_params`` and the
selection matrices of the packed TPU kernel are lane layout for the MXU
and have no counterpart here.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from spnerf_tpu_torch.kernels import _build

ENC = 128  # width of render_fused and render_fused_int8
_TILE_ELEMS = 8192  # csrc/render.cu kTileElems


def tile_rays(width: int) -> int:
    """Rays of one CUDA block's tile, the early stop's granularity."""
    return _TILE_ELEMS // width


def _round_to(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return x if dtype == torch.float32 else x.to(dtype).float()


def _f32(v) -> float:
    return float(np.float32(v))


def _sample_t(s: int, jitter: float, near: float, dt: float) -> float:
    """t_s in the kernel's order of float32 operations."""
    return float(np.float32(near)
                 + (np.float32(s) + np.float32(jitter)) * np.float32(dt))


def _check_rays(name, oe, de, df, width, n_samples, chunk, block, flags):
    N = oe.shape[0]
    for key, t in (("oe", oe), ("de", de), ("df", df)):
        if tuple(t.shape) != (N, width) or t.dtype != torch.float32:
            raise ValueError(f"{name}: {key} must be float32 ({N}, {width}), "
                             f"got {t.dtype} {tuple(t.shape)}")
    if N == 0:
        raise ValueError(f"{name}: no rays")
    if n_samples % chunk:
        raise ValueError(f"n_samples={n_samples} % chunk={chunk} != 0")
    if flags is not None:
        want = (-(-N // block), n_samples // chunk)
        if tuple(flags.shape) != want or flags.dtype != torch.int32:
            raise ValueError(f"{name}: flags must be int32 {want}, got "
                             f"{flags.dtype} {tuple(flags.shape)}")


def _check_weights(name, ws, width):
    dtype = ws[0].dtype
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{name}: weights must be float32 or bfloat16, got "
                         f"{dtype}")
    for w in ws:
        if tuple(w.shape) != (width, width) or w.dtype != dtype:
            raise ValueError(f"{name}: weights must be {dtype} "
                             f"({width}, {width}), got {w.dtype} "
                             f"{tuple(w.shape)}")
    return dtype


def float_mlp_head(w1, w2, w3, round_head: bool):
    """enc, df -> head (M, 4): the float MLP with the kernel's roundings."""
    dtype = w1.dtype
    w1f, w2f, w3f = w1.float(), w2.float(), w3[:, :4].float()

    def head(enc, df):
        h = _round_to(torch.relu(_round_to(enc, dtype) @ w1f), dtype)
        h = _round_to(torch.relu(h @ w2f + df), dtype)
        out = h @ w3f
        return _round_to(out, dtype) if round_head else out
    return head


def int8_mlp_head(q):
    """The int8 MLP in float32 ops: every int32 sum is below 2^24, so the
    float32 products are exact."""
    w1f, w2f, w3f = (q[k].float() for k in ("qw1", "qw2", "qw3"))
    w3f, r3 = w3f[:, :4], q["r3"][:4]

    def head(enc, df):
        e = torch.round(enc * 127.0)
        h = torch.round(torch.clamp(torch.relu(e @ w1f) * q["m1"], 0.0, 127.0))
        h = torch.relu((h @ w2f) * q["m2"] + df * q["ia2"])
        h = torch.round(torch.clamp(h, 0.0, 127.0))
        return (h @ w3f) * r3
    return head


def render_plain_counted(oe, de, df, head_fn, *, width, n_samples, chunk,
                         near, far, jitter, block, flags, early_stop_eps,
                         packed):
    """The render in PyTorch ops, on any device, skipping what the CUDA
    kernel skips. ``head_fn(enc, df) -> (M, 4)`` is the MLP. Returns
    (rgb (N, 3), depth (N,), the number of (ray, sample) pairs composited,
    which is the work this run's flags and early stop leave)."""
    N, dev = oe.shape[0], oe.device
    dt = _f32((far - near) / n_samples)
    tile = tile_rays(width)
    n_tiles = -(-N // tile)
    rgb = torch.zeros((N, 3), dtype=torch.float32, device=dev)
    depth = torch.zeros((N,), dtype=torch.float32, device=dev)
    # transmittance, or (packed) the optical depth at the chunk's start
    state = (torch.zeros if packed else torch.ones)(
        (N,), dtype=torch.float32, device=dev)
    cut = _f32(-np.log(early_stop_eps)) if packed and early_stop_eps > 0 \
        else _f32(early_stop_eps)
    ray_block = torch.arange(N, device=dev) // block
    composited = 0
    for ci in range(n_samples // chunk):
        mine = torch.ones((N,), dtype=torch.bool, device=dev) if flags is None \
            else flags[ray_block, ci] != 0
        want = mine
        if early_stop_eps > 0 and ci > 0:
            want = mine & (state < cut if packed else state > cut)
        padded = torch.zeros((n_tiles * tile,), dtype=torch.bool, device=dev)
        padded[:N] = want
        go = padded.reshape(n_tiles, tile).any(1).repeat_interleave(tile)[:N]
        idx = (mine & go).nonzero().squeeze(1)
        if idx.numel() == 0:
            continue
        composited += idx.numel() * chunk
        o, d, f = oe[idx], de[idx], df[idx]
        c_rgb, c_depth, c_state = rgb[idx], depth[idx], state[idx]
        csum = torch.zeros_like(c_state)
        for s in range(ci * chunk, (ci + 1) * chunk):
            t_s = _sample_t(s, jitter, near, dt)
            head = head_fn(torch.sin(o + t_s * d), f)
            sigma = torch.relu(head[:, 0])
            if packed:
                sig = sigma * dt
                e1 = torch.exp(-(csum + c_state))
                w = e1 - e1 * torch.exp(-sig)
                csum = csum + sig
            else:
                alpha = 1.0 - torch.exp(-sigma * dt)
                w = c_state * alpha
                c_state = c_state * (1.0 - alpha)
            c_rgb = c_rgb + w[:, None] * torch.sigmoid(head[:, 1:4])
            c_depth = c_depth + w * t_s
        if packed:
            c_state = c_state + csum
        rgb[idx], depth[idx], state[idx] = c_rgb, c_depth, c_state
    return rgb, depth, composited


def _zeros_like_if_none(df, oe):
    return torch.zeros_like(oe) if df is None else df


def _launch_float(name, oe, de, w1, w2, w3, df, jitter, width, n_samples,
                  near, far, block, chunk, flags, early_stop_eps, packed):
    dtype = _check_weights(name, (w1, w2, w3), width)
    N = oe.shape[0]
    oe, de, df = oe.contiguous(), de.contiguous(), df.contiguous()
    w1, w2 = w1.contiguous(), w2.contiguous()
    w3 = w3[:, :4].contiguous()
    flags = None if flags is None else flags.contiguous()
    rgb = torch.empty((N, 3), dtype=torch.float32, device=oe.device)
    depth = torch.empty((N,), dtype=torch.float32, device=oe.device)
    tensors = dict(oe=oe, de=de, df=df, w1=w1, w2=w2, w3=w3, rgb=rgb,
                   depth=depth)
    if flags is not None:
        tensors["flags"] = flags
    _build.check_cuda(name, **tensors)
    early = early_stop_eps > 0
    cut = 0.0 if not early else (
        float(-np.log(early_stop_eps)) if packed else float(early_stop_eps))
    _build.launch("render", "render_launch", oe, de, df, w1, w2, w3, flags,
                  rgb, depth, N, width, int(dtype == torch.bfloat16),
                  n_samples, chunk, block, int(early), float(jitter),
                  float(near), (far - near) / n_samples, cut)
    return rgb, depth


def render_fused_plain(oe, de, w1, w2, w3, df=None, jitter=0.5, n_samples=32,
                       near=2.0, far=6.0, block=512, s_chunk=16, flags=None,
                       early_stop_eps=1e-3):
    """Plain version of ``render_fused``, on any device."""
    df = _zeros_like_if_none(df, oe)
    _check_rays("render_fused", oe, de, df, ENC, n_samples, s_chunk, block,
                flags)
    _check_weights("render_fused", (w1, w2, w3), ENC)
    return render_plain_counted(
        oe, de, df, float_mlp_head(w1, w2, w3, False), width=ENC,
        n_samples=n_samples, chunk=s_chunk, near=near, far=far, jitter=jitter,
        block=block, flags=flags, early_stop_eps=early_stop_eps,
        packed=False)[:2]


def render_fused(oe, de, w1, w2, w3, df=None, jitter=0.5, n_samples=32,
                 near=2.0, far=6.0, block=512, s_chunk=16, flags=None,
                 early_stop_eps=1e-3):
    """Render (N, 128)-encoded rays -> (rgb (N, 3), depth (N,)) float32.

    oe, de: the rays' encodings (``models.fused_tiny_nerf.encode_rays``);
    df: per-ray view features added before the second ReLU (None: zeros);
    w1, w2, w3: (128, 128) float32 or bf16 (biases ride a constant-one
    lane); ``flags``: int32 (ceil(N / block), n_samples // s_chunk) from
    ``ops.occupancy.chunk_flags`` built with the same ``block`` and
    ``s_chunk``, None renders every chunk; ``early_stop_eps`` 0 turns the
    early stop off. CPU tensors take the plain version.
    """
    if not oe.is_cuda:
        return render_fused_plain(oe, de, w1, w2, w3, df, jitter, n_samples,
                                  near, far, block, s_chunk, flags,
                                  early_stop_eps)
    df = _zeros_like_if_none(df, oe)
    _check_rays("render_fused", oe, de, df, ENC, n_samples, s_chunk, block,
                flags)
    out = _launch_float("render_fused", oe, de, w1, w2, w3, df, jitter, ENC,
                        n_samples, near, far, block, s_chunk, flags,
                        early_stop_eps, packed=False)
    _build.launch_counts[
        "render[bf16]" if w1.dtype == torch.bfloat16 else "render[f32]"] += 1
    return out


def _check_packed(oe, width, n_samples, s_chunk):
    """The samples of one chunk: ``s_chunk`` packed rows of 128 // width."""
    if width not in (64, 32):
        raise ValueError(f"unsupported pack width {width}")
    if oe.shape[1] != width:
        raise ValueError(f"oe width {oe.shape[1]} != field width {width}")
    pack = 128 // width
    if n_samples % (pack * s_chunk):
        raise ValueError(f"n_samples={n_samples} not divisible by "
                         f"pack*s_chunk={pack * s_chunk}")
    return pack * s_chunk


def render_fused_packed_plain(oe, de, w1, w2, w3, df=None, jitter=0.5, *,
                              width, n_samples=32, near=2.0, far=6.0,
                              block=512, s_chunk=8, flags=None,
                              early_stop_eps=1e-3):
    """Plain version of ``render_fused_packed``, on any device."""
    chunk = _check_packed(oe, width, n_samples, s_chunk)
    df = _zeros_like_if_none(df, oe)
    _check_rays("render_fused_packed", oe, de, df, width, n_samples, chunk,
                block, flags)
    _check_weights("render_fused_packed", (w1, w2, w3), width)
    return render_plain_counted(
        oe, de, df, float_mlp_head(w1, w2, w3, True), width=width,
        n_samples=n_samples, chunk=chunk, near=near, far=far, jitter=jitter,
        block=block, flags=flags, early_stop_eps=early_stop_eps,
        packed=True)[:2]


def render_fused_packed(oe, de, w1, w2, w3, df=None, jitter=0.5, *, width,
                        n_samples=32, near=2.0, far=6.0, block=512, s_chunk=8,
                        flags=None, early_stop_eps=1e-3):
    """Render width-W rays (oe, de, df (N, W), weights (W, W), W 64 or 32)
    -> (rgb (N, 3), depth (N,)). ``s_chunk`` counts the reference's packed
    rows of 128 // W samples, so a chunk (and a flag) covers
    ``s_chunk * 128 // W`` samples. The head is rounded to the weights'
    dtype before sigma and rgb are read."""
    if not oe.is_cuda:
        return render_fused_packed_plain(
            oe, de, w1, w2, w3, df, jitter, width=width, n_samples=n_samples,
            near=near, far=far, block=block, s_chunk=s_chunk, flags=flags,
            early_stop_eps=early_stop_eps)
    chunk = _check_packed(oe, width, n_samples, s_chunk)
    df = _zeros_like_if_none(df, oe)
    _check_rays("render_fused_packed", oe, de, df, width, n_samples, chunk,
                block, flags)
    out = _launch_float("render_fused_packed", oe, de, w1, w2, w3, df, jitter,
                        width, n_samples, near, far, block, chunk, flags,
                        early_stop_eps, packed=True)
    _build.launch_counts[f"render[w{width}]"] += 1
    return out


def quantize_field(params, calib_oe, calib_de, calib_df, *, n_samples=32,
                   near=2.0, far=6.0, jitter=0.5):
    """Quantize the tiny field's MLP weights to int8 for
    ``render_fused_int8`` (numpy; the same numbers as the reference's
    ``quantize_field``): symmetric int8 with per-column weight scales, and
    the two hidden activations' scales calibrated as the largest value over
    the calibration rays at every sample depth, through the quantized
    weights. Returns int8 ``qw1``-``qw3`` and the float32 rescales::

        layer 1: qh  = round(clip(relu(acc1) * m1, 0, 127))
        layer 2: qh2 = round(clip(relu(acc2 * m2 + df * ia2), 0, 127))
        layer 3: head = acc3 * r3
    """
    w1 = np.asarray(params["w1"], np.float32)
    w2 = np.asarray(params["w2"], np.float32)
    w3 = np.asarray(params["w3"], np.float32)

    def colscale(w):
        s = np.abs(w).max(axis=0) / 127.0
        return np.where(s > 0, s, 1.0).astype(np.float32)

    s1, s2, s3 = colscale(w1), colscale(w2), colscale(w3)
    qw1 = np.clip(np.rint(w1 / s1), -127, 127).astype(np.int8)
    qw2 = np.clip(np.rint(w2 / s2), -127, 127).astype(np.int8)
    qw3 = np.clip(np.rint(w3 / s3), -127, 127).astype(np.int8)

    oe = np.asarray(calib_oe, np.float32)
    de = np.asarray(calib_de, np.float32)
    df = np.asarray(calib_df, np.float32)
    dt = (far - near) / n_samples
    dq1 = qw1.astype(np.float32) * s1 / 127.0  # the encoding's scale 1/127
    dq2 = qw2.astype(np.float32) * s2
    h_max = 1e-6
    for s in range(n_samples):
        t_s = near + (s + jitter) * dt
        enc = np.rint(np.sin(oe + t_s * de) * 127.0)
        h_max = max(h_max, float(np.maximum(enc @ dq1, 0.0).max()))
    a1 = h_max / 127.0
    h2_max = 1e-6  # through the final layer-1 quantizer
    for s in range(n_samples):
        t_s = near + (s + jitter) * dt
        enc = np.rint(np.sin(oe + t_s * de) * 127.0)
        qh = np.clip(np.rint(np.maximum(enc @ dq1, 0.0) / a1), 0, 127)
        h2 = np.maximum(qh @ dq2 * a1 + df, 0.0)
        h2_max = max(h2_max, float(h2.max()))
    a2 = h2_max / 127.0
    return {
        "qw1": qw1, "qw2": qw2, "qw3": qw3,
        "m1": (s1 / (127.0 * a1)).astype(np.float32),
        "m2": (s2 * (a1 / a2)).astype(np.float32),
        "ia2": np.float32(1.0 / a2),
        "r3": (s3 * a2).astype(np.float32),
        "a1": np.float32(a1), "a2": np.float32(a2),
    }


def qfield_to(qfield: dict, device) -> dict:
    """``quantize_field``'s numpy dict as tensors on ``device`` (``ia2`` a
    float); a dict that already holds tensors there is returned as it is."""
    out = {k: torch.as_tensor(qfield[k], device=device)
           for k in ("qw1", "qw2", "qw3", "m1", "m2", "r3")}
    out["ia2"] = _f32(qfield["ia2"])
    return out


def s8_hidden_order() -> torch.Tensor:
    """(128,) int64: the hidden unit that column k of the int8 kernel's A
    operand holds (``csrc/render.cu``, render_s8_kernel). In k-step s,
    column 32 s + 16 e + 4 t + i carries unit 32 s + 8 (2 e + i // 2) +
    2 t + i % 2: the units a thread's s32 accumulator holds (columns 8 j +
    2 t + {0, 1}) in the slots of its m64k32 A fragment (columns 16 e +
    4 t + {0..3}). B's rows are permuted by it, so the sums are the same."""
    k = torch.arange(ENC)
    s, c = k // 32, k % 32
    e, t, i = c // 16, (c % 16) // 4, c % 4
    return 32 * s + 8 * (2 * e + i // 2) + 2 * t + i % 2


@dataclasses.dataclass(frozen=True)
class RenderInt8Operands:
    """``render_fused_int8``'s operands prepared once by
    ``prepare_render_int8``: ``q``, the ``quantize_field`` tensors the
    plain version reads (``ia2`` a float), and the kernel's: ``w1b``, the
    K-major B operand of qw1 (``_build.pack_slabs``' int8 core matrices);
    ``w2b``, ``w3b`` the same of qw2 and of qw3's four head columns at n =
    0, 2, 4, 6 of 8, their rows permuted by ``s8_hidden_order``; ``m1``,
    ``m2`` (128,) and ``r3`` (4,) float32."""

    q: dict
    w1b: torch.Tensor
    w2b: torch.Tensor
    w3b: torch.Tensor
    m1: torch.Tensor
    m2: torch.Tensor
    r3: torch.Tensor

    @property
    def ia2(self) -> float:
        return self.q["ia2"]


def prepare_render_int8(qfield, device=None) -> RenderInt8Operands:
    """Lay out ``quantize_field``'s operands (numpy or tensors) for the
    int8 render kernel once, on ``device`` (by default the device of
    tensors given, else the card)."""
    if device is None:
        qw1 = qfield["qw1"]
        device = qw1.device if isinstance(qw1, torch.Tensor) else "cuda"
    q = qfield_to(qfield, device)
    _check_int8(q)
    order = s8_hidden_order().to(q["qw2"].device)
    w3 = torch.zeros((ENC, 8), dtype=torch.int8, device=q["qw3"].device)
    w3[:, 0:8:2] = q["qw3"][:, :4]
    return RenderInt8Operands(
        q=q, w1b=_build.pack_slabs(q["qw1"]),
        w2b=_build.pack_slabs(q["qw2"][order]), w3b=_build.pack_slabs(w3[order]),
        m1=q["m1"].contiguous(), m2=q["m2"].contiguous(),
        r3=q["r3"][:4].contiguous())


def _check_int8(q):
    for k in ("qw1", "qw2", "qw3"):
        if tuple(q[k].shape) != (ENC, ENC) or q[k].dtype != torch.int8:
            raise ValueError(f"render_fused_int8: {k} must be int8 "
                             f"({ENC}, {ENC})")
    for k in ("m1", "m2", "r3"):
        if tuple(q[k].shape) != (ENC,) or q[k].dtype != torch.float32:
            raise ValueError(f"render_fused_int8: {k} must be float32 "
                             f"({ENC},)")


def render_fused_int8_plain(oe, de, qfield, df=None, jitter=0.5, n_samples=32,
                            near=2.0, far=6.0, block=512, s_chunk=16,
                            flags=None, early_stop_eps=1e-3):
    """Plain version of ``render_fused_int8``, on any device."""
    df = _zeros_like_if_none(df, oe)
    _check_rays("render_fused_int8", oe, de, df, ENC, n_samples, s_chunk,
                block, flags)
    if isinstance(qfield, RenderInt8Operands):
        qfield = qfield.q
    q = qfield_to(qfield, oe.device)
    _check_int8(q)
    return render_plain_counted(
        oe, de, df, int8_mlp_head(q), width=ENC, n_samples=n_samples,
        chunk=s_chunk, near=near, far=far, jitter=jitter, block=block,
        flags=flags, early_stop_eps=early_stop_eps, packed=False)[:2]


def render_fused_int8(oe, de, qfield, df=None, jitter=0.5, n_samples=32,
                      near=2.0, far=6.0, block=512, s_chunk=16, flags=None,
                      early_stop_eps=1e-3):
    """``render_fused`` through the int8-quantized field ``qfield``: the
    dict of ``quantize_field`` (numpy or tensors, laid out on this call)
    or ``RenderInt8Operands`` from ``prepare_render_int8``. enc =
    round(127 sin) as int8, int32 dots, the hidden activations
    requantized, the head and the compositing in float32."""
    if not oe.is_cuda:
        return render_fused_int8_plain(oe, de, qfield, df, jitter, n_samples,
                                       near, far, block, s_chunk, flags,
                                       early_stop_eps)
    df = _zeros_like_if_none(df, oe)
    _check_rays("render_fused_int8", oe, de, df, ENC, n_samples, s_chunk,
                block, flags)
    ops = qfield if isinstance(qfield, RenderInt8Operands) \
        else prepare_render_int8(qfield, oe.device)
    N = oe.shape[0]
    oe, de, df = oe.contiguous(), de.contiguous(), df.contiguous()
    flags = None if flags is None else flags.contiguous()
    rgb = torch.empty((N, 3), dtype=torch.float32, device=oe.device)
    depth = torch.empty((N,), dtype=torch.float32, device=oe.device)
    tensors = dict(oe=oe, de=de, df=df, w1b=ops.w1b, w2b=ops.w2b, w3b=ops.w3b,
                   m1=ops.m1, m2=ops.m2, r3=ops.r3, rgb=rgb, depth=depth)
    if flags is not None:
        tensors["flags"] = flags
    _build.check_cuda("render_fused_int8", **tensors)
    early = early_stop_eps > 0
    _build.launch("render", "render_int8_launch", oe, de, df, ops.w1b,
                  ops.w2b, ops.w3b, ops.m1, ops.m2, ops.r3, flags, rgb, depth,
                  N, n_samples, s_chunk, block, int(early), float(jitter),
                  float(near), (far - near) / n_samples,
                  float(early_stop_eps) if early else 0.0, ops.ia2)
    _build.launch_counts["render[int8]"] += 1
    return rgb, depth
