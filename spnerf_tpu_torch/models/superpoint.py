"""SuperPoint / MagicPoint as a torch ``nn.Module``, NHWC at the surface.

Counterpart of ``spnerf_tpu/models/superpoint.py``: a shared VGG encoder
of 8x [conv3x3 -> BN -> ReLU] with 2x2 max-pools after blocks 2/4/6,
a detector head (conv3x3 -> BN -> ReLU, conv1x1 -> 65 logits + BN) and a
descriptor head (conv3x3 -> BN -> ReLU, conv1x1 -> 256 + BN). Module
paths keep the flax names (``backbone.block1.Conv_0``,
``detector.convPa.BatchNorm_0``, ...) so weights map one to one.
"""

from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn

from spnerf_tpu_torch.device import resolve_device
from spnerf_tpu_torch.ops.detector_decode import decode_detector_logits
from spnerf_tpu_torch.ops.nms import box_nms
from spnerf_tpu_torch.ops.upsample import upsample_bicubic
from spnerf_tpu_torch.parallel.mesh import active_mesh, psum


@dataclasses.dataclass(frozen=True)
class SuperPointConfig:
    model_name: str = "superpoint"  # "magicpoint" -> no descriptor head
    vgg_cn: tuple[int, ...] = (64, 64, 64, 64, 128, 128, 128, 128)
    detector_dim: tuple[int, int] = (128, 256)
    descriptor_dim: tuple[int, int] = (128, 256)
    grid_size: int = 8
    nms: int = 4
    det_thresh: float = 0.001
    top_k: int = 0
    use_bn: bool = True  # False = BN-folded inference variant

    @property
    def has_descriptor(self) -> bool:
        return self.model_name == "superpoint"

    @classmethod
    def from_dict(cls, model_cfg: dict) -> "SuperPointConfig":
        det = model_cfg.get("detector_head", {})
        desc = model_cfg.get("descriptor_head", {})
        return cls(
            model_name=model_cfg.get("model_name", "superpoint"),
            vgg_cn=tuple(model_cfg.get("vgg_cn", (64, 64, 64, 64, 128, 128, 128, 128))),
            detector_dim=tuple(det.get("detector_dim", (128, 256))),
            descriptor_dim=tuple(desc.get("descriptor_dim", (128, 256))),
            grid_size=det.get("grid_size", 8),
            nms=det.get("nms", 4),
            det_thresh=det.get("det_thresh", 0.001),
            top_k=det.get("top_k", 0),
        )


class BatchNorm(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` whose training forward is flax's
    ``nn.BatchNorm(momentum=0.9, epsilon=1e-5)``: the batch variance is
    E[x^2] - E[x]^2 clamped at 0, and the running variance takes that
    biased variance (``nn.BatchNorm2d`` would take the unbiased one, n /
    (n - 1) times larger). The running statistics are updated in place, once
    per training forward. The eval forward is ``nn.BatchNorm2d``'s.

    Inside a data-parallel step (``parallel.mesh.data_parallel``) the sums
    of x and x^2 are taken over the global batch, every rank holding an
    equal share of it, as flax's under a sharded jit: the running
    statistics then agree on every rank."""

    def forward(self, x):
        if not self.training:
            return super().forward(x)
        mesh = active_mesh()
        count = x.numel() // x.shape[1] * (1 if mesh is None else mesh.size)
        sums = psum(torch.stack([x.sum(dim=(0, 2, 3)),
                                 (x * x).sum(dim=(0, 2, 3))]), mesh)
        mean, mean_sq = sums[0] / count, sums[1] / count
        var = torch.clamp_min(mean_sq - mean * mean, 0.0)
        with torch.no_grad():
            keep = 1.0 - self.momentum
            self.running_mean.mul_(keep).add_(self.momentum * mean)
            self.running_var.mul_(keep).add_(self.momentum * var)
        mul = torch.rsqrt(var + self.eps) * self.weight
        return ((x - mean[:, None, None]) * mul[:, None, None]
                + self.bias[:, None, None])


class VGGBlock(nn.Module):
    """conv -> BatchNorm -> (ReLU), NCHW inside the model."""

    def __init__(self, cin: int, cout: int, kernel: int = 3,
                 activation: bool = True, use_bn: bool = True):
        super().__init__()
        self.activation = activation
        self.Conv_0 = nn.Conv2d(cin, cout, kernel, padding=kernel // 2)
        # flax momentum 0.9 on the running average == torch momentum 0.1
        self.BatchNorm_0 = (BatchNorm(cout, eps=1e-5, momentum=0.1)
                            if use_bn else None)

    def forward(self, x):
        x = self.Conv_0(x)
        if self.BatchNorm_0 is not None:
            x = self.BatchNorm_0(x)
        return torch.relu(x) if self.activation else x


class SuperPoint(nn.Module):
    """(B, H, W, 1) image -> {"logits": (B, Hc, Wc, 65)[, "desc_raw":
    (B, Hc, Wc, 256)]}, NHWC like the flax model."""

    def __init__(self, config: SuperPointConfig = SuperPointConfig()):
        super().__init__()
        self.config = cfg = config
        chans = (1,) + tuple(cfg.vgg_cn)
        self.backbone = nn.ModuleDict({
            f"block{i + 1}": VGGBlock(chans[i], chans[i + 1], use_bn=cfg.use_bn)
            for i in range(len(cfg.vgg_cn))})
        feat = cfg.vgg_cn[-1]
        self.detector = nn.ModuleDict({
            "convPa": VGGBlock(feat, cfg.detector_dim[1], use_bn=cfg.use_bn),
            "convPb": VGGBlock(cfg.detector_dim[1], cfg.grid_size ** 2 + 1,
                               kernel=1, activation=False, use_bn=cfg.use_bn),
        })
        if cfg.has_descriptor:
            self.descriptor = nn.ModuleDict({
                "convDa": VGGBlock(feat, cfg.descriptor_dim[1],
                                   use_bn=cfg.use_bn),
                "convDb": VGGBlock(cfg.descriptor_dim[1],
                                   cfg.descriptor_dim[1], kernel=1,
                                   activation=False, use_bn=cfg.use_bn),
            })

    def forward(self, image):
        x = image.permute(0, 3, 1, 2)
        for i, block in enumerate(self.backbone.values()):
            x = block(x)
            if i in (1, 3, 5):  # maxpool after blocks 2, 4, 6 -> stride 8
                x = nn.functional.max_pool2d(x, 2, 2)
        det = self.detector["convPb"](self.detector["convPa"](x))
        out = {"logits": det.permute(0, 2, 3, 1)}
        if self.config.has_descriptor:
            desc = self.descriptor["convDb"](self.descriptor["convDa"](x))
            out["desc_raw"] = desc.permute(0, 2, 3, 1)
        return out


def conv_blocks(model: SuperPoint) -> dict:
    """{"backbone/block1": VGGBlock, ...} in flax path naming."""
    blocks = {}
    for head in ("backbone", "detector", "descriptor"):
        if hasattr(model, head):
            for name, block in getattr(model, head).items():
                blocks[f"{head}/{name}"] = block
    return blocks


@torch.no_grad()
def fold_batch_norm(model: SuperPoint, eps: float = 1e-5) -> dict:
    """Fold BatchNorm running stats into the conv weights for inference.

    Returns {path: {"kernel": (kh, kw, cin, cout) HWIO f32, "bias":
    (cout,)}} with kernel' = kernel * g and bias' = beta + (bias - mean)
    * g, g = gamma / sqrt(var + eps): the reference's float32 formula and
    order (spnerf_tpu/models/superpoint.fold_batch_norm).
    """
    folded = {}
    for path, block in conv_blocks(model).items():
        conv, bn = block.Conv_0, block.BatchNorm_0
        kernel = conv.weight.detach().float().permute(2, 3, 1, 0)
        bias = conv.bias.detach().float()
        if bn is not None:
            g = bn.weight.float() / torch.sqrt(bn.running_var.float() + eps)
            kernel = kernel * g
            bias = bn.bias.float() + (bias - bn.running_mean.float()) * g
        folded[path] = {"kernel": kernel.contiguous(), "bias": bias}
    return folded


@torch.no_grad()
def folded_superpoint(folded: dict, config: SuperPointConfig,
                      dtype=torch.bfloat16) -> SuperPoint:
    """The ``use_bn=False`` SuperPoint holding ``fold_batch_norm``'s
    weights, cast to ``dtype``, in eval mode on the weights' device: the
    reference's BN-folded bf16 export forward (its ``make_prob_fn(...,
    fast=True)``)."""
    device = next(iter(folded.values()))["kernel"].device
    model = SuperPoint(dataclasses.replace(config, use_bn=False))
    for path, block in conv_blocks(model).items():
        block.Conv_0.weight.copy_(folded[path]["kernel"].permute(3, 2, 0, 1))
        block.Conv_0.bias.copy_(folded[path]["bias"])
    return model.to(device, dtype).eval()


def init_superpoint(seed: int, config: SuperPointConfig = SuperPointConfig(),
                    device="cuda") -> SuperPoint:
    """A SuperPoint in eval mode with weights drawn from ``seed``.

    Conv kernels are LeCun-normal (std 1/sqrt(fan_in), the flax default's
    scale), biases zero, BatchNorm at its identity init. The numbers
    differ from the flax init of the same seed; tests carry flax weights
    across with tools/import_jax_weights instead.
    """
    gen = torch.Generator().manual_seed(seed)
    model = SuperPoint(config)
    with torch.no_grad():
        for block in conv_blocks(model).values():
            w = block.Conv_0.weight
            fan_in = w.shape[1] * w.shape[2] * w.shape[3]
            w.copy_(torch.randn(w.shape, generator=gen) / math.sqrt(fan_in))
            block.Conv_0.bias.zero_()
    return model.to(resolve_device(device)).eval()


@torch.no_grad()
def superpoint_inference(model: SuperPoint, image: torch.Tensor,
                         with_nms: bool | None = None) -> dict:
    """The parity inference path (``spnerf_tpu/models/superpoint.py``
    ``superpoint_inference``): the float32 forward with cuDNN's TF32 off,
    then "logits", "prob_heatmap" (B, H, W), "prob_heatmap_nms" (with
    NMS: ``box_nms`` at the config's size, det_thresh and top_k),
    "pred_pts" (int32 mask of the heatmap at or above det_thresh) and,
    with a descriptor head, "desc_raw" and "desc": the dense bicubic x8
    upsample, L2-normalized with 1e-12 (B, H, W, C). ``model`` is used in
    its current mode (eval for inference)."""
    cfg = model.config
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        out = dict(model(image.float()))
    prob = decode_detector_logits(out["logits"], cfg.grid_size)
    out["prob_heatmap"] = prob
    if cfg.nms if with_nms is None else with_nms:
        prob = box_nms(prob, size=cfg.nms, iou=0.1, min_prob=cfg.det_thresh,
                       keep_top_k=cfg.top_k)
        out["prob_heatmap_nms"] = prob
    out["pred_pts"] = (prob >= cfg.det_thresh).to(torch.int32)
    if "desc_raw" in out:
        desc = upsample_bicubic(out["desc_raw"], cfg.grid_size)
        out["desc"] = desc / (torch.linalg.norm(desc, dim=-1, keepdim=True)
                              + 1e-12)
    return out
