"""SuperPoint serving graph on the port's kernels: int8, bf16 or mixed.

Counterpart of ``spnerf_tpu/ops/serving.ServingSuperPoint``. With the
fused mid and tail (the default)::

    conv12_fused       image -> blocks 1-2 -> pool    (int8, mixed)
    conv1_packed       image -> block 1               (bf16, batch <= 8;
                       larger batches: a plain float32 conv)
    packed_conv3x3     block 2 -> pool                (bf16)
    double_conv3x3     blocks 3-4 -> pool, 5-6 -> pool, 7-8
    head               convPa -> convPb [-> softmax]  bf16 probs / logits
    head               convDa -> convDb               bf16 desc_raw

``fused_mid=False`` (forced when W % 16 != 0, as in the reference) runs
blocks 3-6 as single convs (``packed_conv3x3`` for C_in 64, ``conv3x3``
for block 6); ``fused_tail=False`` runs blocks 7-8 and convPa / convDa
through ``conv3x3`` and convPb / convDb through ``dot_bias_act``.

int8 scheme: per-output-channel symmetric weights, per-tensor symmetric
activations calibrated as each conv's float max-abs, int32 accumulation,
requantization ``acc * (s_in * w_scale / s_out) + bias / s_out`` fused
into each kernel. All scalar algebra is float32 tensor arithmetic in the
reference's order, so multipliers match it to the bit. bf16 mode: bf16
weights and activations, float32 sums, mult 1, no calibration. mixed:
the int8 backbone, dequantized once (``x.bf16 * s.bf16``) in front of
bf16 heads.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from spnerf_tpu_torch.device import resolve_device
from spnerf_tpu_torch.kernels.conv12_fused import conv12_fused, prepare_conv12
from spnerf_tpu_torch.kernels.conv_stack import (
    conv1_packed,
    conv3x3,
    dot_bias_act,
    packed_conv3x3,
    prepare_conv1,
    prepare_dot,
)
from spnerf_tpu_torch.kernels.mid_fused import (
    double_packed_conv3x3,
    prepare_double_conv,
)
from spnerf_tpu_torch.kernels.requant import affine, cast_out, maxpool2x2
from spnerf_tpu_torch.kernels.tail_fused import (
    double_conv3x3,
    head,
    prepare_head,
)
from spnerf_tpu_torch.models.superpoint import fold_batch_norm
from spnerf_tpu_torch.ops.quantization import quantize_weights

# execution order after block1: (name, C_in 64?, pool after?)
_BACKBONE = [
    ("backbone/block2", True, True),
    ("backbone/block3", True, False),
    ("backbone/block4", True, True),
    ("backbone/block5", True, False),
    ("backbone/block6", False, True),
    ("backbone/block7", False, False),
    ("backbone/block8", False, False),
]

MODES = ("int8", "bf16", "mixed")
# batches above this run conv1 as a plain conv in chunks of this size
CONV1_KERNEL_MAX_BATCH = 8


class ServingSuperPoint:
    """BN-folded inference graph (int8, bf16 or mixed).

    Usage::

        sp = ServingSuperPoint.build(config, model, calib_images)
        out = sp(images, softmax=True)   # {"probs", "desc_raw"} bf16

    ``model`` is the ``use_bn=True`` SuperPoint (or the folded dict of
    ``fold_batch_norm``); calibration (int8 and mixed) runs one float
    forward on the serving device. Images are (B, H, W, 1) float32 in
    [0, 1] with H % 16 == 0 and W % 8 == 0.
    """

    CONVS = (["backbone/block1"] + [name for name, _, _ in _BACKBONE]
             + ["detector/convPa", "detector/convPb"])
    DESC_CONVS = ["descriptor/convDa", "descriptor/convDb"]
    # in mixed mode the heads run bf16 behind the int8 backbone
    _HEAD_NAMES = frozenset({"detector/convPa", "detector/convPb",
                             "descriptor/convDa", "descriptor/convDb"})

    def __init__(self, folded, act_scales, has_descriptor, mode="int8",
                 fused_tail=True, fused_mid=True, device="cuda"):
        if mode not in MODES:
            raise ValueError(f"ServingSuperPoint: mode {mode!r} is not one "
                             f"of {MODES}")
        if mode != "bf16" and act_scales is None:
            raise ValueError(f"{mode} mode needs activation scales")
        self.mode = mode
        self.fused_tail = fused_tail
        self.fused_mid = fused_mid
        self.device = resolve_device(device)
        self.has_descriptor = has_descriptor
        self.params = {name: {k: v.to(self.device, torch.float32)
                              for k, v in folded[name].items()}
                       for name in self.conv_names(has_descriptor)}
        # {conv name: f32 scale of its OUTPUT}, 0-dim tensors
        self.act_scales = None if act_scales is None else {
            k: v.to(self.device, torch.float32) for k, v in act_scales.items()}
        self.weights_q = {}
        if mode != "bf16":
            self.weights_q = {
                name: quantize_weights(self.params[name]["kernel"])
                for name in self.conv_names(has_descriptor)
                if name != "backbone/block1" and not self._head_is_bf16(name)}
        self._prepare()

    @classmethod
    def conv_names(cls, has_descriptor):
        return cls.CONVS + (cls.DESC_CONVS if has_descriptor else [])

    def _head_is_bf16(self, name):
        return self.mode == "mixed" and name in self._HEAD_NAMES

    def _heads(self):
        """(conv_a, conv_b, output key) of each head."""
        heads = [("detector/convPa", "detector/convPb", "logits")]
        if self.has_descriptor:
            heads.append(("descriptor/convDa", "descriptor/convDb",
                          "desc_raw"))
        return heads

    def _prepare(self):
        """Pack the kernels' operands once per model (after calibration):
        the fused mid's and tail's ``double_conv3x3`` operands (blocks 3-4,
        5-6, 7-8); the fused tail's ``head`` operands, or the per-layer
        route's 3x3 operands and 1x1 ``dot_bias_act`` operands; in bf16
        mode conv1's patch product, else ``conv12_fused``'s (blocks 1-2).
        Each block's input scale is its predecessor's output scale (none
        in bf16 mode); the heads' is block 8's in int8 mode (the chain's
        last), none in bf16 and mixed (the dequantized bf16 input)."""
        s = self._scale("backbone/block2")
        pairs = []
        for a, b in (("backbone/block3", "backbone/block4"),
                     ("backbone/block5", "backbone/block6"),
                     ("backbone/block7", "backbone/block8")):
            wa, ma, ba, sa = self._wmb(a, s)
            wb, mb, bb, s = self._wmb(b, sa)
            pairs.append((wa, ma, ba, wb, mb, bb))
        self.mid_ops = ([prepare_double_conv(*p) for p in pairs[:2]]
                        if self.fused_mid else None)
        self.tail_ops = (prepare_double_conv(*pairs[2]) if self.fused_tail
                         else None)
        s_in = (self.act_scales["backbone/block8"] if self.mode == "int8"
                else None)
        self.head_ops = {}
        for conv_a, conv_b, key in self._heads():
            w, mult, bias, s_a = self._wmb(conv_a, s_in)
            wh, mh, bh = self._head_wmb(conv_b, s_a)
            self.head_ops[key] = (
                prepare_head(w, mult, bias, wh, mh, bh) if self.fused_tail
                else ((w, mult, bias), prepare_dot(wh, mh, bh)))
        self.conv1_ops = self.conv12_ops = None
        if self.mode == "bf16":
            node = self.params["backbone/block1"]
            self.conv1_ops = prepare_conv1(
                node["kernel"], torch.ones_like(node["bias"]), node["bias"])
        else:
            s1 = self.act_scales["backbone/block1"]
            w2q, ws2 = self.weights_q["backbone/block2"]
            s2 = self.act_scales["backbone/block2"]
            n1 = self.params["backbone/block1"]
            b2 = self.params["backbone/block2"]["bias"]
            mult1 = (1.0 / (127.0 * s1)).expand(64)
            self.conv12_ops = prepare_conv12(n1["kernel"], mult1,
                                             n1["bias"] / s1, w2q,
                                             s1 * ws2 / s2, b2 / s2)

    # ------------------------------------------------------------ building

    @classmethod
    def build(cls, config, model, calib_images=None, mode="int8",
              eps: float = 1e-5, fused_tail: bool = True,
              fused_mid: bool = True, device="cuda"):
        device = resolve_device(device)
        folded = model if isinstance(model, dict) else fold_batch_norm(model, eps)
        folded = {k: {n: t.to(device) for n, t in v.items()}
                  for k, v in folded.items()}
        scales = None
        if mode != "bf16":
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
            for name, _, pool in _BACKBONE:
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
        its input scale ``s_in`` (None: a bf16 conv, mult 1)."""
        bias = self.params[name]["bias"]
        if self.mode == "bf16" or self._head_is_bf16(name):
            w = self.params[name]["kernel"].to(torch.bfloat16)
            return w, torch.ones_like(bias), bias, None
        s_out = self.act_scales[name]
        wq, ws = self.weights_q[name]
        mult = s_in * ws / s_out
        return wq, mult, bias / s_out, s_out

    def _scale(self, name):
        """The output scale of conv ``name`` (None in bf16 mode)."""
        return None if self.mode == "bf16" else self.act_scales[name]

    def _head_wmb(self, name, s_in):
        """1x1 head dot scaling to float: (w (Cm, Cout), mult, bias). The
        kernels pad Cout (convPb's 65 logits) inside."""
        bias = self.params[name]["bias"]
        if self.mode == "bf16" or self._head_is_bf16(name):
            w = self.params[name]["kernel"][0, 0].to(torch.bfloat16)
            return w, torch.ones_like(bias), bias
        wq, ws = self.weights_q[name]
        return wq[0, 0], s_in * ws, bias

    # ------------------------------------------------------------- forward

    def _conv1(self, image):
        """First VGG block of the bf16 stack -> (B, H, W, 64) bf16.

        Up to ``CONV1_KERNEL_MAX_BATCH`` images: the patch-product kernel
        (``conv1_packed``). Larger batches: a plain float32 conv of the
        bf16-rounded image and kernel (TF32 off) in chunks of that size,
        then the affine, ReLU and cast, as the reference computes this
        branch outside any kernel."""
        if image.shape[0] <= CONV1_KERNEL_MAX_BATCH:
            return conv1_packed(image, self.conv1_ops,
                                out_dtype=torch.bfloat16)
        node = self.params["backbone/block1"]
        mult, bias = torch.ones_like(node["bias"]), node["bias"]
        kernel = node["kernel"].to(torch.bfloat16).float().permute(3, 2, 0, 1)
        chunks = []
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            for img in image.split(CONV1_KERNEL_MAX_BATCH):
                img = img.to(torch.bfloat16).float().permute(0, 3, 1, 2)
                y = F.conv2d(img, kernel, padding=1).permute(0, 2, 3, 1)
                chunks.append(cast_out(affine(y, mult, bias, True),
                                       torch.bfloat16))
        return torch.cat(chunks)

    @torch.no_grad()
    def __call__(self, image, softmax: bool = False):
        """Forward pass on (B, H, W, 1) images. With the fused tail,
        ``softmax=True`` returns ``probs`` (B, Hc, Wc, 64) bf16 cell
        probabilities (dustbin dropped) instead of ``logits``
        (B, Hc, Wc, 65); ``desc_raw`` is (B, Hc, Wc, 256) bf16."""
        _, H, W, _ = image.shape
        if H % 16 != 0 or W % 8 != 0:
            # conv12 pools in 2x2 and the stack pools twice more: the
            # stride-8 cell grid needs W % 8 (and the reference's 16-row
            # bands H % 16)
            raise ValueError(
                f"ServingSuperPoint: input {H}x{W} must have H % 16 == 0 "
                f"and W % 8 == 0 (pad the image before serving)")
        if softmax and not self.fused_tail:
            raise ValueError("softmax=True requires fused_tail=True")
        image = image.to(self.device, torch.float32)
        act = torch.bfloat16 if self.mode == "bf16" else torch.int8
        act_head = torch.int8 if self.mode == "int8" else torch.bfloat16
        backbone = _BACKBONE
        if self.mode == "bf16":
            x, s_prev = self._conv1(image), None
        else:
            # image -> conv1 -> conv2 -> pool in one kernel
            x = conv12_fused(image, self.conv12_ops, pool=True)
            s_prev = self.act_scales["backbone/block2"]
            backbone = _BACKBONE[1:]
        if self.fused_tail:
            backbone = backbone[:-2]  # blocks 7-8 run in the fused tail

        # the reference's fused mid pools W-pair-packed W/8 pairs, which
        # needs W % 16; narrower grids take the per-layer kernels there too
        fused_mid = self.fused_mid and W % 16 == 0
        i = 0
        while i < len(backbone):
            name, c64, pool = backbone[i]
            if fused_mid and name == "backbone/block3":
                for ops in self.mid_ops:  # blocks 3-4, 5-6
                    x = double_packed_conv3x3(x, ops, pool=True)
                s_prev = self._scale("backbone/block6")
                i += 4
                continue
            w, mult, bias, s_prev = self._wmb(name, s_prev)
            conv = packed_conv3x3 if c64 else conv3x3
            x = conv(x, w, mult, bias, out_dtype=act, pool=pool)
            i += 1

        if self.fused_tail:
            x = double_conv3x3(x, self.tail_ops)  # blocks 7-8
            s_prev = self._scale("backbone/block8")
        if self.mode == "mixed":
            # dequantize once in front of the bf16 heads, rounded as the
            # reference rounds it: a bf16 product of bf16 operands
            x = x.to(torch.bfloat16) * s_prev.to(torch.bfloat16)
            s_prev = None

        out = {}
        for _, _, key in self._heads():
            if not self.fused_tail:
                (w, mult, bias), dot_ops = self.head_ops[key]
                mid = conv3x3(x, w, mult, bias, out_dtype=act_head)
                out[key] = dot_bias_act(mid, dot_ops, relu=False,
                                        out_dtype=torch.bfloat16)
            elif softmax and key == "logits":
                ops = self.head_ops[key]
                out["probs"] = head(x, ops, softmax_lanes=ops.w1.shape[-1])
            else:
                out[key] = head(x, self.head_ops[key])
        return out
