"""Bilinear homography warp of single-channel images.

``warp_image_fused`` replaces ``spnerf_tpu/kernels/warp_pallas.py:
warp_image_fused`` with the CUDA kernel ``csrc/warp.cu`` (see its header
for the bound and the design). Like the reference's kernel, the CUDA
kernel takes H^-1: ``warp_by_inverse`` launches it on inverses the caller
holds (homographic adaptation has them for its masks), and
``warp_image_fused`` inverts H with ``invert_homographies`` first. For
output pixel (x, y) and the inverse homography h = H^-1::

    d  = h6 x + h7 y + h8
    sx = (h0 x + h1 y + h2) / d,   sy = (h3 x + h4 y + h5) / d
    out = sum_y' relu(1 - |sy - y'|) * sum_x' img[y', x'] relu(1 - |sx - x'|)

with f32 sums and zero outside the source. Only the taps x' = floor(sx),
floor(sx) + 1 (and likewise in y) are non-zero; they are built as
``1 - |s - x'|`` exactly as the reference's dense hat matrices are, and
summed in the reference's order, so that the results agree to the bit.
Rounding follows the reference: ``bfloat16`` rounds the image and the x
weights to bf16 (their products are exact in f32), ``int8`` quantizes
both to 7-bit fixed point (``round(clip(img, 0, 1) * 127)``,
``round(wx * 127)``, int32 sums times ``1 / (127 * 127)``); the y weights
stay f32. Where sx or sy is not finite (d = 0) the output is 0.

The image batch may be shorter than the homography batch: homography n
warps image ``n % B`` (an index, no copy), which is how homographic adaptation warps the
same B images by chunk * B homographies without copying them.
"""

from __future__ import annotations

import torch

from spnerf_tpu_torch.kernels import _build

_MODES = {torch.bfloat16: ("bf16", 0), torch.int8: ("int8", 1)}


def _hat(s, t):
    return torch.clamp_min(1.0 - (s - t).abs(), 0.0)


def invert_homographies(h: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) inverses, float32: the adjugate over the determinant in
    float64, rounded once. Elementwise IEEE operations give the same bits
    on the card and on the CPU (a LAPACK or cuSOLVER solve does not), and
    nothing waits on the host; a singular matrix gives inf or nan, as the
    reference's ``jnp.linalg.inv`` does."""
    m = h.double()
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, k, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    A, B, C = e * i - f * k, f * g - d * i, d * k - e * g
    det = a * A + b * B + c * C
    adj = torch.stack([
        torch.stack([A, c * k - b * i, b * f - c * e], -1),
        torch.stack([B, a * i - c * g, c * d - a * f], -1),
        torch.stack([C, b * g - a * k, a * e - b * d], -1)], -2)
    return (adj / det[..., None, None]).float()


def source_coords(hinv, out_shape):
    """(sx, sy), each (N, Ho, Wo) float32: where the inverse homographies
    ``hinv`` (N, 3, 3) send output pixel (x, y), in the kernel's order of
    float32 operations."""
    N = hinv.shape[0]
    Ho, Wo = out_shape
    h = hinv.reshape(N, 9, 1, 1).float()
    ys = torch.arange(Ho, dtype=torch.float32, device=hinv.device)[:, None]
    xs = torch.arange(Wo, dtype=torch.float32, device=hinv.device)[None, :]
    d = h[:, 6] * xs + h[:, 7] * ys + h[:, 8]
    sx = (h[:, 0] * xs + h[:, 1] * ys + h[:, 2]) / d
    sy = (h[:, 3] * xs + h[:, 4] * ys + h[:, 5]) / d
    return sx, sy


def warp_taps(image, hinv, out_shape=None, compute_dtype=torch.bfloat16):
    """The 4-tap warp in PyTorch ops, on any device: (B, Hi, Wi, 1) images
    by (N, 3, 3) inverse homographies (N a multiple of B, homography n on
    image n % B) -> (N, Ho, Wo, 1) float32. ``compute_dtype`` float32
    rounds nothing."""
    B, Hi, Wi, _ = image.shape
    N = hinv.shape[0]
    Ho, Wo = out_shape if out_shape is not None else (Hi, Wi)
    dev = image.device
    sx, sy = source_coords(hinv.to(dev), (Ho, Wo))
    # range test before any cast: d = 0 gives inf or nan
    inside = (sx > -1.0) & (sx < Wi) & (sy > -1.0) & (sy < Hi)
    sx, sy = torch.where(inside, sx, 0.0), torch.where(inside, sy, 0.0)
    x0, y0 = torch.floor(sx), torch.floor(sy)

    img = image[..., 0].float()
    int8 = compute_dtype == torch.int8
    if int8:
        img = torch.round(img.clamp(0.0, 1.0) * 127.0).to(torch.int32)
    elif compute_dtype == torch.bfloat16:
        img = img.to(torch.bfloat16).float()
    src = img.reshape(B, Hi * Wi)[torch.arange(N, device=dev) % B]
    wx = [_hat(sx, x0), _hat(sx, x0 + 1.0)]
    if int8:
        wx = [torch.round(w * 127.0).to(torch.int32) for w in wx]
    elif compute_dtype == torch.bfloat16:
        wx = [w.to(torch.bfloat16).float() for w in wx]
    x0i, y0i = x0.long(), y0.long()

    out = torch.zeros((N, Ho, Wo), dtype=torch.float32, device=dev)
    for ky in (0, 1):
        yk = y0i + ky
        ok_y = inside & (yk >= 0) & (yk < Hi)
        t = torch.zeros_like(wx[0])
        for kx in (0, 1):
            xk = x0i + kx
            ok = ok_y & (xk >= 0) & (xk < Wi)
            idx = yk.clamp(0, Hi - 1) * Wi + xk.clamp(0, Wi - 1)
            v = torch.gather(src, 1, idx.reshape(N, -1)).reshape(N, Ho, Wo)
            t = t + torch.where(ok, v * wx[kx], 0)
        if int8:
            t = t.float() * (1.0 / (127.0 * 127.0))
        out = out + torch.where(ok_y, _hat(sy, y0 + float(ky)) * t, 0.0)
    return out[..., None]


def _check(image, homography, compute_dtype):
    B, _, _, C = image.shape
    N = homography.shape[0]
    if C != 1:
        raise ValueError(f"warp_image_fused: C={C}, needs single-channel "
                         "images")
    if N % B != 0 or homography.shape[1:] != (3, 3):
        raise ValueError(f"warp_image_fused: homographies "
                         f"{tuple(homography.shape)} for {B} images")
    if compute_dtype not in _MODES:
        raise ValueError(f"warp_image_fused: compute_dtype={compute_dtype} "
                         "(bfloat16 or int8; float32 is warp_image_matmul)")


def warp_by_inverse_plain(image, hinv, compute_dtype=torch.bfloat16):
    """Plain version of ``warp_by_inverse``, on any device."""
    _check(image, hinv, compute_dtype)
    return warp_taps(image, hinv, None, compute_dtype)


def warp_by_inverse(image, hinv, compute_dtype=torch.bfloat16):
    """Warp (B, H, W, 1) images by (N, 3, 3) inverse homographies H^-1,
    N = k * B (H^-1 n warps image n % B): dst(x, y) = src(H^-1 (x, y, 1)),
    bilinear, zero outside -> (N, H, W, 1) float32.

    The kernel reads the float32 image and rounds it to ``compute_dtype``
    as it loads. CPU tensors take the plain version.
    """
    if not image.is_cuda:
        return warp_by_inverse_plain(image, hinv, compute_dtype)
    _check(image, hinv, compute_dtype)
    B, H, W, _ = image.shape
    N = hinv.shape[0]
    name, mode = _MODES[compute_dtype]
    img = image.float().contiguous()
    h = hinv.float().reshape(N, 9).contiguous()
    out = torch.empty((N, H, W, 1), dtype=torch.float32, device=img.device)
    _build.check_cuda("warp_by_inverse", image=img, hinv=h, out=out)
    _build.launch("warp", "warp_launch", img, h, out, N, B, H, W, mode)
    _build.launch_counts[f"warp[{name}]"] += 1
    return out


def warp_image_fused_plain(image, homography, compute_dtype=torch.bfloat16):
    """Plain version of ``warp_image_fused``, on any device."""
    _check(image, homography, compute_dtype)
    return warp_by_inverse_plain(image, invert_homographies(homography),
                                 compute_dtype)


def warp_image_fused(image, homography, compute_dtype=torch.bfloat16):
    """``warp_by_inverse`` given the homographies H (N, 3, 3) themselves:
    they are inverted by ``invert_homographies`` before the launch."""
    _check(image, homography, compute_dtype)
    return warp_by_inverse(image, invert_homographies(homography),
                           compute_dtype)
