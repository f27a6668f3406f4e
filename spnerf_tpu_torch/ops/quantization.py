"""Post-training int8 quantization of the inference conv stack
(``spnerf_tpu/ops/quantization.py``):

- weights: per-output-channel symmetric int8 of the BN-folded kernels;
- activations: per-tensor symmetric int8, scales calibrated by max-abs
  on a batch of representative images;
- each 3x3 conv an int8 x int8 -> int32 product, dequantized in float32
  with its bias, then ReLU;
- the detector and descriptor 1x1 output layers in bf16.

The reference writes the int8 convs as ``lax.conv_general_dilated``
with int32 accumulation, outside any Pallas kernel. The port builds the
int8 im2col (NHWC, SAME padding) and takes the product with
``torch._int_mm``, as a plain matmul would be; the arithmetic is exact
either way, so the int32 sums equal the reference's.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from spnerf_tpu_torch.device import resolve_device

# images per im2col: block 2's columns of 8 images at 480 x 640 take 1.4 GB
_IM2COL_BYTES = 2 << 30


def quantize_weights(kernel: torch.Tensor):
    """(kh, kw, cin, cout) float kernel -> (int8 kernel, (cout,) f32
    scales): scale = (absmax + 1e-12) / 127, round half to even, clip to
    +-127."""
    kernel = kernel.float()
    absmax = kernel.abs().amax(dim=(0, 1, 2)) + 1e-12
    scale = absmax / 127.0
    q = torch.clamp(torch.round(kernel / scale), -127, 127).to(torch.int8)
    return q, scale


def quantize_activations(x: torch.Tensor, scale: torch.Tensor):
    """x / scale rounded half to even and clipped to +-127, as int8."""
    return torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)


def im2col(x_q: torch.Tensor, kh: int, kw: int) -> torch.Tensor:
    """(B, H, W, C) -> (B H W, kh kw C) columns of the SAME-padded
    stride-1 window, in the (h, w, c) order of an HWIO kernel."""
    B, H, W, C = x_q.shape
    if (kh, kw) == (1, 1):
        return x_q.reshape(B * H * W, C)
    top, left = (kh - 1) // 2, (kw - 1) // 2
    xp = F.pad(x_q, (0, 0, left, kw - 1 - left, top, kh - 1 - top))
    cols = torch.stack([xp[:, dy:dy + H, dx:dx + W] for dy in range(kh)
                        for dx in range(kw)], dim=3)
    return cols.reshape(B * H * W, kh * kw * C)


def conv_int32(x_q: torch.Tensor, kernel_q: torch.Tensor) -> torch.Tensor:
    """(B, H, W, cin) int8 x (kh, kw, cin, cout) int8 -> (B, H, W, cout)
    int32 sums of the SAME-padded conv, by ``torch._int_mm`` over the
    im2col (K padded to a multiple of 8, images in chunks that keep the
    columns under 2 GB)."""
    B, H, W, _ = x_q.shape
    kh, kw, cin, cout = kernel_q.shape
    k = kh * kw * cin
    k_pad = -(-k // 8) * 8
    n_pad = -(-cout // 8) * 8
    w = F.pad(kernel_q.reshape(k, cout), (0, n_pad - cout, 0, k_pad - k))
    w = w.t().contiguous().t()  # column-major, as cuBLAS takes it
    per = max(1, _IM2COL_BYTES // max(1, H * W * k_pad))
    out = []
    for start in range(0, B, per):
        cols = F.pad(im2col(x_q[start:start + per], kh, kw), (0, k_pad - k))
        rows = cols.shape[0]
        cols = F.pad(cols, (0, 0, 0, max(0, 17 - rows)))  # _int_mm: M > 16
        out.append(torch._int_mm(cols, w)[:rows, :cout])
    acc = torch.cat(out)
    return acc.reshape(B, H, W, cout)


def conv_int8(x_q, kernel_q, x_scale, w_scale, bias):
    """int8 x int8 -> int32 conv (NHWC, HWIO, SAME), dequantized to
    float32 in the reference's order: acc * (x_scale * w_scale) + bias."""
    acc = conv_int32(x_q, kernel_q)
    return acc.float() * (x_scale * w_scale) + bias


def max_pool_2x2(x: torch.Tensor) -> torch.Tensor:
    """2 x 2 stride-2 max pool of an NHWC tensor (odd edges dropped)."""
    B, H, W, C = x.shape
    x = x[:, :H // 2 * 2, :W // 2 * 2]
    return x.reshape(B, H // 2, 2, W // 2, 2, C).amax(dim=(2, 4))


class QuantizedSuperPoint(nn.Module):
    """BN-folded, int8-conv SuperPoint inference graph, built from a
    trained model:

        q = QuantizedSuperPoint.build(model.config, model, calib_images)
        out = q(images)   # {"logits", "desc_raw"}, NHWC float32

    It runs on ``device``: the card unless asked for the CPU.
    """

    # blocks in execution order: (path, pooled_after)
    BACKBONE = [("block1", False), ("block2", True), ("block3", False),
                ("block4", True), ("block5", False), ("block6", True),
                ("block7", False), ("block8", False)]

    def __init__(self, folded: dict, act_scales, has_descriptor: bool,
                 device="cuda"):
        super().__init__()
        self.device = resolve_device(device)
        self.params = {path: {k: v.to(self.device) for k, v in p.items()}
                       for path, p in folded.items()}
        self.has_descriptor = has_descriptor
        self.act_scales = act_scales
        self.weights_q = {name: quantize_weights(self.params[name]["kernel"])
                          for name in self._conv_names()}

    def _conv_names(self):
        names = [f"backbone/{b}" for b, _ in self.BACKBONE]
        names += ["detector/convPa"]
        if self.has_descriptor:
            names += ["descriptor/convDa"]
        return names

    @classmethod
    @torch.no_grad()
    def build(cls, model_config, model, calib_images, eps: float = 1e-5,
              act_scales: dict | None = None, device="cuda"):
        """Fold ``model``'s BatchNorm, quantize the weights and calibrate
        the activation scales on ``calib_images`` (B, H, W, 1) in float32
        with TF32 off: max |x| / 127 + 1e-12 at each int8 conv's input.
        ``act_scales`` ({path: scale}) replaces the calibration."""
        from spnerf_tpu_torch.models.superpoint import fold_batch_norm

        q = cls(fold_batch_norm(model, eps), None,
                model_config.has_descriptor, device)
        if act_scales is None:
            scales = {}

            def record(name, x):
                scales[name] = float(x.abs().max()) / 127.0 + 1e-12

            q._forward(torch.as_tensor(calib_images).to(q.device),
                       record=record)
            act_scales = scales
        q.act_scales = {k: torch.tensor(float(v), dtype=torch.float32,
                                        device=q.device)
                        for k, v in act_scales.items()}
        return q

    def _conv_block(self, x, name, relu=True, record=None):
        node = self.params[name]
        if record is not None:  # float calibration path
            record(name, x)
            w = node["kernel"].permute(3, 2, 0, 1)
            with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
                out = F.conv2d(x.permute(0, 3, 1, 2), w, node["bias"],
                               padding=w.shape[-1] // 2).permute(0, 2, 3, 1)
        else:
            kq, wscale = self.weights_q[name]
            scale = self.act_scales[name]
            out = conv_int8(quantize_activations(x, scale), kq, scale, wscale,
                            node["bias"])
        return torch.relu(out) if relu else out

    def _head_1x1(self, x, name):
        """Output 1x1 convs in bf16: operands rounded to bf16, their exact
        products summed in float32 (TF32 off), the sum rounded to bf16,
        then the float32 bias."""
        node = self.params[name]
        w = node["kernel"].to(torch.bfloat16).float().permute(3, 2, 0, 1)
        x = x.to(torch.bfloat16).float().permute(0, 3, 1, 2)
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            out = F.conv2d(x, w).permute(0, 2, 3, 1)
        return out.to(torch.bfloat16).float() + node["bias"]

    def _forward(self, image, record=None):
        x = image.float()
        for block, pool_after in self.BACKBONE:
            x = self._conv_block(x, f"backbone/{block}", record=record)
            if pool_after:
                x = max_pool_2x2(x)
        det = self._conv_block(x, "detector/convPa", record=record)
        out = {"logits": self._head_1x1(det, "detector/convPb")}
        if self.has_descriptor:
            desc = self._conv_block(x, "descriptor/convDa", record=record)
            out["desc_raw"] = self._head_1x1(desc, "descriptor/convDb")
        return out

    @torch.no_grad()
    def forward(self, image):
        return self._forward(image.to(self.device))
