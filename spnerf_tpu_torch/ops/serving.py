"""int8 SuperPoint serving graph on the port's fused kernels.

Counterpart of ``spnerf_tpu/ops/serving.ServingSuperPoint`` in
``mode="int8"`` with ``fused_mid=True`` and ``fused_tail=True``::

    conv12_fused       image -> blocks 1-2 -> pool    (B, H/2, W/2, 64)
    double_conv3x3     blocks 3-4 -> pool             (B, H/4, W/4, 64)
    double_conv3x3     blocks 5-6 -> pool             (B, H/8, W/8, 128)
    double_conv3x3     blocks 7-8                     (B, H/8, W/8, 128)
    head               convPa -> convPb [-> softmax]  bf16 probs / logits
    head               convDa -> convDb               bf16 desc_raw

int8 scheme: per-output-channel symmetric weights, per-tensor symmetric
activations calibrated as each conv's float max-abs, int32 accumulation,
requantization ``acc * (s_in * w_scale / s_out) + bias / s_out`` fused
into each kernel. All scalar algebra is float32 tensor arithmetic in the
reference's order, so multipliers match it to the bit.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from spnerf_tpu_torch.device import resolve_device
from spnerf_tpu_torch.kernels.conv12_fused import conv12_fused
from spnerf_tpu_torch.kernels.mid_fused import double_packed_conv3x3
from spnerf_tpu_torch.kernels.requant import maxpool2x2
from spnerf_tpu_torch.kernels.tail_fused import double_conv3x3, head
from spnerf_tpu_torch.models.superpoint import fold_batch_norm
from spnerf_tpu_torch.ops.quantization import quantize_weights

# execution order after block1: (name, pool after?)
_BACKBONE = [
    ("backbone/block2", True),
    ("backbone/block3", False),
    ("backbone/block4", True),
    ("backbone/block5", False),
    ("backbone/block6", True),
    ("backbone/block7", False),
    ("backbone/block8", False),
]


class ServingSuperPoint:
    """BN-folded int8 inference graph.

    Usage::

        sp = ServingSuperPoint.build(config, model, calib_images)
        out = sp(images, softmax=True)   # {"probs", "desc_raw"} bf16

    ``model`` is the ``use_bn=True`` SuperPoint (or the folded dict of
    ``fold_batch_norm``); calibration runs one float forward on the
    serving device. Images are (B, H, W, 1) float32 in [0, 1].
    """

    CONVS = (["backbone/block1"] + [name for name, _ in _BACKBONE]
             + ["detector/convPa", "detector/convPb"])
    DESC_CONVS = ["descriptor/convDa", "descriptor/convDb"]

    def __init__(self, folded, act_scales, has_descriptor, mode="int8",
                 fused_tail=True, fused_mid=True, device="cuda"):
        self._check_supported(mode, fused_tail, fused_mid)
        self.device = resolve_device(device)
        self.has_descriptor = has_descriptor
        self.params = {name: {k: v.to(self.device, torch.float32)
                              for k, v in folded[name].items()}
                       for name in self.conv_names(has_descriptor)}
        # {conv name: f32 scale of its OUTPUT}, 0-dim tensors
        self.act_scales = {k: v.to(self.device, torch.float32)
                           for k, v in act_scales.items()}
        self.weights_q = {name: quantize_weights(self.params[name]["kernel"])
                          for name in self.conv_names(has_descriptor)
                          if name != "backbone/block1"}

    @classmethod
    def conv_names(cls, has_descriptor):
        return cls.CONVS + (cls.DESC_CONVS if has_descriptor else [])

    @staticmethod
    def _check_supported(mode, fused_tail, fused_mid):
        if mode != "int8":
            raise NotImplementedError(
                f"mode={mode!r}: only int8 is ported; see ROADMAP Queue 1, "
                "'bf16 and mixed serving modes'")
        if not (fused_tail and fused_mid):
            raise NotImplementedError(
                "fused_mid=False / fused_tail=False need the unfused "
                "fallback kernels; see ROADMAP Queue 2, 'Unfused fallbacks'")

    # ------------------------------------------------------------ building

    @classmethod
    def build(cls, config, model, calib_images=None, mode="int8",
              eps: float = 1e-5, fused_tail: bool = True,
              fused_mid: bool = True, device="cuda"):
        cls._check_supported(mode, fused_tail, fused_mid)
        device = resolve_device(device)
        folded = model if isinstance(model, dict) else fold_batch_norm(model, eps)
        folded = {k: {n: t.to(device) for n, t in v.items()}
                  for k, v in folded.items()}
        if calib_images is None:
            raise ValueError(f"{mode} mode needs calibration images")
        scales = cls._calibrate(folded, config.has_descriptor,
                                calib_images.to(device))
        return cls(folded, scales, config.has_descriptor, mode,
                   fused_tail=fused_tail, fused_mid=fused_mid, device=device)

    @staticmethod
    @torch.no_grad()
    def _calibrate(folded, has_descriptor, images):
        """Float forward with folded weights, recording each conv's
        post-activation max-abs -> per-tensor symmetric scales. TF32 is
        off so the card's convs run in full float32."""
        scales = {}

        def conv(x, name, relu=True):
            node = folded[name]
            w = node["kernel"].permute(3, 2, 0, 1)
            y = F.conv2d(x.permute(0, 3, 1, 2), w,
                         padding=w.shape[-1] // 2).permute(0, 2, 3, 1)
            y = y + node["bias"]
            if relu:
                y = torch.clamp_min(y, 0.0)
            scales[name] = y.abs().amax() / 127.0 + 1e-12
            return y

        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            x = conv(images.float(), "backbone/block1")
            for name, pool in _BACKBONE:
                x = conv(x, name)
                if pool:
                    x = maxpool2x2(x)
            conv(conv(x, "detector/convPa"), "detector/convPb", relu=False)
            if has_descriptor:
                conv(conv(x, "descriptor/convDa"), "descriptor/convDb",
                     relu=False)
        return scales

    # ------------------------------------------------------------- weights

    def _wmb(self, name, s_in):
        """Kernel operands (w, mult, bias, s_out) for conv ``name`` given
        its input scale ``s_in``."""
        bias = self.params[name]["bias"]
        s_out = self.act_scales[name]
        wq, ws = self.weights_q[name]
        mult = s_in * ws / s_out
        return wq, mult, bias / s_out, s_out

    def _head_wmb(self, name, s_in):
        """1x1 head dot dequantizing to float: (w (Cm, Cout), mult, bias)."""
        wq, ws = self.weights_q[name]
        return wq[0, 0], s_in * ws, self.params[name]["bias"]

    # ------------------------------------------------------------- forward

    @torch.no_grad()
    def __call__(self, image, softmax: bool = False):
        """Forward pass on (B, H, W, 1) images. ``softmax=True`` returns
        ``probs`` (B, Hc, Wc, 64) bf16 cell probabilities (dustbin
        dropped) instead of ``logits`` (B, Hc, Wc, 65)."""
        _, H, W, _ = image.shape
        if H % 16 != 0 or W % 16 != 0:
            # conv12 pools in 2x2 and the fused mid pair pools twice more
            # on a grid the reference packs in W pairs: it needs W % 16
            raise ValueError(
                f"ServingSuperPoint: input {H}x{W} must have H % 16 == 0 "
                f"and W % 16 == 0 (pad the image before serving)")
        image = image.to(self.device, torch.float32)
        s1 = self.act_scales["backbone/block1"]
        w2q, ws2 = self.weights_q["backbone/block2"]
        s2 = self.act_scales["backbone/block2"]
        n1, b2 = self.params["backbone/block1"], self.params["backbone/block2"]["bias"]
        mult1 = (1.0 / (127.0 * s1)).expand(64)
        x = conv12_fused(image, n1["kernel"], mult1, n1["bias"] / s1,
                         w2q, s1 * ws2 / s2, b2 / s2, pool=True)
        s_prev = s2
        for a, b in (("backbone/block3", "backbone/block4"),
                     ("backbone/block5", "backbone/block6")):
            wa, ma, ba, sa = self._wmb(a, s_prev)
            wb, mb, bb, s_prev = self._wmb(b, sa)
            x = double_packed_conv3x3(x, wa, ma, ba, wb, mb, bb, pool=True)
        w7, m7, b7, s7 = self._wmb("backbone/block7", s_prev)
        w8, m8, b8, s_prev = self._wmb("backbone/block8", s7)
        x = double_conv3x3(x, w7, m7, b7, w8, m8, b8)

        w, mult, bias, s_pa = self._wmb("detector/convPa", s_prev)
        wh, mh, bh = self._head_wmb("detector/convPb", s_pa)
        if softmax:
            out = {"probs": head(x, w, mult, bias, wh, mh, bh,
                                 softmax_lanes=wh.shape[-1])}
        else:
            out = {"logits": head(x, w, mult, bias, wh, mh, bh)}
        if self.has_descriptor:
            w, mult, bias, s_da = self._wmb("descriptor/convDa", s_prev)
            wh, mh, bh = self._head_wmb("descriptor/convDb", s_da)
            out["desc_raw"] = head(x, w, mult, bias, wh, mh, bh)
        return out
