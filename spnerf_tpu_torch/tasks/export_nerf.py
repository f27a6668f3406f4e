"""export_NeRF_labels task (``spnerf_tpu/tasks/export_nerf.py``).

Batches of frames per scene: ONE forward and one NMS per frame, then
every target frame's labels fused from a random 75% subset of the
batch's other frames by batched depth reprojection
(``ops/nerf_label_fusion``), NMS'd and thresholded. Artifacts:
EXPER_PATH/outputs/<experiment>/<split>/<name>.npy, int64 (N, 2) (y, x),
the HA export's layout; frames whose file exists are skipped. The
subsets come from ``np.random.default_rng(seed)`` in the reference's
order, so both packages fuse the same frames.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from spnerf_tpu_torch import settings
from spnerf_tpu_torch.data.loader import DataLoader
from spnerf_tpu_torch.data.nerf_dataset import NeRFDataset
from spnerf_tpu_torch.device import resolve_device
from spnerf_tpu_torch.models.superpoint import SuperPoint
from spnerf_tpu_torch.ops.fast_inference import topk_lowest_index
from spnerf_tpu_torch.ops.nerf_label_fusion import fuse_nerf_labels
from spnerf_tpu_torch.ops.nms import box_nms
from spnerf_tpu_torch.tasks.export import _nms_threshold_points, make_prob_fn

MAX_DETECTIONS = 1024


def _nms(prob, det_cfg: dict):
    return box_nms(prob, size=det_cfg["nms"], iou=0.1,
                   min_prob=det_cfg["det_thresh"],
                   keep_top_k=det_cfg.get("top_k", 0) or 0)


def detections(probs: torch.Tensor, det_cfg: dict):
    """(F, H, W) heatmaps -> (points (F, 1024, 2) int32 (y, x), valid (F,
    1024)): the best 1,024 pixels of each NMS'd heatmap, ties to the
    lowest raster index, valid at or above ``det_thresh``."""
    nms = _nms(probs, det_cfg)
    F, H, W = nms.shape
    scores, idx = topk_lowest_index(nms.reshape(F, H * W),
                                    min(MAX_DETECTIONS, H * W))
    pts = torch.stack([idx // W, idx % W], dim=-1).to(torch.int32)
    return pts, scores >= det_cfg["det_thresh"]


def fuse_and_nms(probs, pts, valid, depths, Ks, Rs, ts, target: int,
                 selected, det_cfg: dict) -> torch.Tensor:
    """The NMS'd fused (H, W) heatmap of frame ``target``."""
    fused = fuse_nerf_labels(probs, pts, valid, depths, Ks, Rs, ts, target,
                             selected)
    return _nms(fused, det_cfg)


def fusion_subset(rng: np.random.Generator, F: int, target: int) -> np.ndarray:
    """(F,) bool: the source frames fused into ``target``, a random
    max(1, int(0.75 (F - 1))) of the others."""
    others = [k for k in range(F) if k != target]
    chosen = rng.choice(
        others, size=max(1, int(0.75 * len(others))), replace=False
    ) if others else []
    selected = np.zeros(F, bool)
    selected[list(chosen)] = True
    return selected


@torch.no_grad()
def export_nerf_labels(config: dict, model: SuperPoint, seed: int = 0,
                       split: str = "training", device="cuda") -> Path:
    """Write the fused labels of every frame of the config's scenes
    (``data.all_data_dirs``, else ``data.data_dir``) and ``split``, on the
    card unless ``device="cpu"``; the float32 model (cuDNN's TF32 off).
    Returns the output directory."""
    device = resolve_device(device)
    exper = config["data"]["experiment_name"]
    out_dir = Path(settings.EXPER_PATH, "outputs", exper, split)
    out_dir.mkdir(parents=True, exist_ok=True)
    det_cfg = config["model"]["detector_head"]
    prob_fn = make_prob_fn(model.to(device).eval(), fast=False)

    data_cfg = dict(config["data"])
    scenes = data_cfg.get("all_data_dirs") or [data_cfg.get("data_dir")]
    rng = np.random.default_rng(seed)
    for scene in scenes:
        scene_cfg = dict(data_cfg, data_dir=scene, has_labels=False,
                         warped_pair=False)
        loader = DataLoader(NeRFDataset(scene_cfg, split),
                            batch_size=data_cfg.get("batch_size", 8),
                            shuffle=False, drop_last=False)
        for batch in loader:
            names = [str(n) for n in batch["name"]]
            if all((out_dir / f"{n}.npy").exists() for n in names):
                continue
            on = lambda key: torch.from_numpy(batch[key]).to(device)  # noqa: E731
            probs = prob_fn(on("image"))
            pts, valid = detections(probs, det_cfg)
            geometry = [on(k) for k in ("depth", "intrinsics", "rotation",
                                        "translation")]
            for j, name in enumerate(names):
                save_path = out_dir / f"{name}.npy"
                if save_path.exists():
                    continue
                selected = fusion_subset(rng, len(names), j)
                nms_prob = fuse_and_nms(probs, pts, valid, *geometry, j,
                                        selected, det_cfg)
                np.save(save_path, _nms_threshold_points(
                    nms_prob.cpu().numpy(), det_cfg["det_thresh"]))
    return out_dir
