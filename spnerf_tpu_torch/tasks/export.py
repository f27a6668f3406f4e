"""Homographic-adaptation pseudo-label export and HPatches bundles
(``spnerf_tpu/tasks/export.py``).

Artifact layout as in the reference: EXPER_PATH/outputs/<experiment>/
<split>/<name>.npy holds int64 (N, 2) (y, x) keypoints; the pseudo-label
export is resumable: images that already have a file are skipped.
``export_hpatches`` writes EXPER_PATH/{repeatability|descriptors}/
<experiment>/<name>.npz through the parity inference path.

Each image batch goes to the card as uint8, is padded to one fixed batch
shape, adapted over its random views, NMS'd and cut to its top ``k_cap``
points on the card; only those points come back. A 1-deep pipeline
overlaps the host's file writes of batch i-1 with the card's work on
batch i: batch i-1's points are copied into pinned host buffers without
blocking and an event is recorded right after, and the host waits on
that event, not on the stream (which by then holds batch i as well).

With a ``mesh`` (``parallel.mesh.make_mesh``) every rank reads the same
batches and adapts its contiguous rows of each, padded to a multiple of
the ranks; the files equal the single-process export's byte for byte.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from spnerf_tpu_torch.device import resolve_device
from spnerf_tpu_torch.models.superpoint import (
    SuperPoint,
    fold_batch_norm,
    folded_superpoint,
    superpoint_inference,
)
from spnerf_tpu_torch.ops.detector_decode import decode_detector_logits
from spnerf_tpu_torch.ops.homography_adaptation import (
    HAConfig,
    homography_adaptation,
    image_homographies,
)
from spnerf_tpu_torch.ops.nms import box_nms
from spnerf_tpu_torch.ops.serving import ServingSuperPoint
from spnerf_tpu_torch.parallel.mesh import (
    Mesh,
    barrier,
    broadcast,
    make_mesh,
    replicate,
)
from spnerf_tpu_torch.settings import EXPER_PATH


def _nms_threshold_points(prob_nms: np.ndarray,
                          det_thresh: float) -> np.ndarray:
    """NMS'd heatmap -> int64 (N, 2) (y, x) of the pixels at or above
    ``det_thresh``, in raster order."""
    return np.argwhere(prob_nms >= det_thresh).astype(np.int64)


def make_prob_fn(model: SuperPoint, fast: bool = False, serving=None):
    """(B, H, W, 1) -> (B, H, W) decoded probability heatmap.

    ``fast=False``: the float32 model, with cuDNN's TF32 off. ``fast=True``:
    BatchNorm folded into the convs, the forward in bf16 (the export
    default); the decode stays float32. ``serving``: a built
    ``ServingSuperPoint`` (int8, bf16 or mixed), whose detector head
    returns logits (no in-kernel softmax).
    """
    grid = model.config.grid_size
    if serving is not None:
        @torch.no_grad()
        def prob_fn(image):
            logits = serving(image)["logits"]
            return decode_detector_logits(logits.float(), grid)
        return prob_fn

    if not fast:
        @torch.no_grad()
        def prob_fn(image):
            with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
                logits = model(image)["logits"]
            return decode_detector_logits(logits, grid)
        return prob_fn

    infer = folded_superpoint(fold_batch_norm(model), model.config)

    @torch.no_grad()
    def prob_fn(image):
        logits = infer(image.to(torch.bfloat16))["logits"]
        return decode_detector_logits(logits.float(), grid)
    return prob_fn


@torch.no_grad()
def export_pseudo_labels(config: dict, model: SuperPoint, loader,
                         split: str = "training", enable_ha: bool = True,
                         seed: int = 0, fast: bool = True,
                         device="cuda", mesh: Mesh | None = None) -> Path:
    """Write one keypoint file per image of ``loader`` (an iterable of
    {"image": (B, H, W, 1) float in [0, 1], "name": [...]} batches).

    ``config`` is the reference's export config as a dict: ``data``
    (experiment_name, batch_size), ``model.detector_head`` (nms,
    det_thresh, top_k), ``homography_adaptation`` (see ``HAConfig``) and
    ``export`` (serving: false, or true / "int8" | "bf16" | "mixed" for
    the serving graph in that mode: "mixed" runs the int8 backbone with
    bf16 heads; topk_cap, default 4096). Image i of the dataset
    draws its views from (seed, i), counted from the loader dataset's
    ``shard_offset`` if it has one: the labels depend on neither batch
    size, padding, sharding nor resumes.

    ``mesh`` shards each batch over its ranks, as the reference's mesh
    does: the batch pads (repeating its last image) to a multiple of the
    ranks, at least ``batch_size`` rounded up to one, each rank adapts
    its contiguous rows of it and writes its real ones, and the call
    returns when every rank has written. Under a process group of more
    than one rank the int8 serving graph is calibrated on rank 0's first
    batch, so that ranks that read different shards of the data
    (``data.shard: auto``) label as one process does.
    """
    device = resolve_device(device)
    exper = config["data"]["experiment_name"]
    out_dir = Path(EXPER_PATH, "outputs", exper, split)
    out_dir.mkdir(parents=True, exist_ok=True)

    det_cfg = config["model"]["detector_head"]
    exp_cfg = config.get("export", {}) or {}
    ha_cfg = HAConfig.from_dict(config.get("homography_adaptation", {}))
    det_thresh = float(det_cfg["det_thresh"])
    top_k = int(det_cfg.get("top_k", 0) or 0)
    # point cap when top_k is unlimited: NMS'd 240 x 320 heatmaps keep a
    # few hundred points, so 4096 is "all" in practice
    k_cap = top_k if top_k > 0 else int(exp_cfg.get("topk_cap", 4096))

    model = model.to(device).eval()
    n_shard = 1 if mesh is None else mesh.size
    if mesh is not None:
        replicate(model, mesh)
    serving = None
    serving_mode = exp_cfg.get("serving", False)
    if serving_mode:
        mode = serving_mode if isinstance(serving_mode, str) else "int8"
        # calibrate on the first batch (bf16 needs none); close the
        # iterator so that its prefetch thread ends
        cal_it = iter(loader)
        first = next(cal_it)
        if hasattr(cal_it, "close"):
            cal_it.close()
        calib = torch.from_numpy(np.asarray(first["image"])[:8]).to(device)
        calib = broadcast(calib, make_mesh() if mesh is None else mesh)
        serving = ServingSuperPoint.build(model.config, model, calib,
                                          mode=mode, device=device)
    prob_fn = make_prob_fn(model, fast=fast, serving=serving)
    b_fixed = -(-int(config["data"].get("batch_size", 1)) // n_shard) * n_shard

    def ha_points(image_u8, homs):
        """uint8 batch -> (scores, ys, xs), each (B, k) on the device."""
        image = image_u8.float() * (1.0 / 255.0)
        if enable_ha:
            prob = homography_adaptation(prob_fn, image, homs, ha_cfg)
        else:
            prob = prob_fn(image)
        pn = box_nms(prob, size=det_cfg["nms"], iou=0.1,
                     min_prob=det_thresh, keep_top_k=top_k)
        Bp, H, W = pn.shape
        scores, idx = torch.topk(pn.reshape(Bp, -1), min(k_cap, H * W),
                                 dim=1)
        return scores, idx // W, idx % W

    def to_device(a):
        t = torch.as_tensor(a)
        if device.type == "cuda":
            t = t.pin_memory()
        return t.to(device, non_blocking=True)

    def flush(pending):
        todo, (scores, ys, xs), done = pending
        if done is not None:
            done.synchronize()
        scores, ys, xs = scores.numpy(), ys.numpy(), xs.numpy()
        for i, name in todo:
            keep = scores[i] >= det_thresh
            pred = np.stack([ys[i][keep], xs[i][keep]], -1).astype(np.int64)
            np.save(out_dir / f"{name}.npy", pred)

    pending = None  # 1-deep pipeline: host writes overlap the card's work
    img_seen = int(getattr(getattr(loader, "dataset", None),
                           "shard_offset", 0) or 0)
    for batch in loader:
        names = batch["name"]
        img = np.asarray(batch["image"])
        n_real = img.shape[0]
        todo = [(i, n) for i, n in enumerate(names)
                if not (out_dir / f"{n}.npy").exists()]
        idx0, img_seen = img_seen, img_seen + n_real
        if not todo:
            continue
        homs = None
        if enable_ha:
            homs = image_homographies(seed, range(idx0, idx0 + n_real),
                                      ha_cfg.num - 1, img.shape[1:3],
                                      ha_cfg.params)
        image_u8 = np.clip(np.rint(img * 255.0), 0, 255).astype(np.uint8)
        pad = max(b_fixed, -(-n_real // n_shard) * n_shard) - n_real
        if pad:  # padded rows are dropped on flush
            image_u8 = np.concatenate(
                [image_u8, np.repeat(image_u8[-1:], pad, axis=0)])
            if homs is not None:
                homs = torch.cat([homs, homs[-1:].expand(pad, -1, -1, -1)])
        if mesh is not None:  # this rank's rows, renumbered from 0
            rows = mesh.rows(n_real + pad)
            image_u8 = image_u8[rows]
            homs = None if homs is None else homs[rows]
            todo = [(i - rows.start, n) for i, n in todo
                    if rows.start <= i < rows.stop]
            if not todo:
                continue
        res = ha_points(to_device(image_u8),
                        None if homs is None else to_device(homs))
        done = None
        if device.type == "cuda":
            host = tuple(torch.empty(r.shape, dtype=r.dtype, pin_memory=True)
                         for r in res)
            for h, r in zip(host, res):
                h.copy_(r, non_blocking=True)
            done = torch.cuda.Event()
            done.record()
            res = host
        if pending is not None:
            flush(pending)  # batch i-1, while the card runs batch i
        pending = (todo, res, done)
    if pending is not None:
        flush(pending)
    if mesh is not None:
        barrier(mesh)
    return out_dir


@torch.no_grad()
def export_hpatches(config: dict, model: SuperPoint, loader,
                    with_descriptors: bool = False, device="cuda") -> Path:
    """HPatches repeatability or descriptor bundles: for every pair of
    ``loader`` (an iterable of {"image", "warped_image": (B, H, W, 1)
    float in [0, 1], "homography": (B, 3, 3), "name": [...]} batches)
    one EXPER_PATH/{repeatability|descriptors}/<experiment>/<name>.npz
    with "image", "warped_image" (H, W), "prob", "warped_prob" (the NMS'd
    heatmaps of ``superpoint_inference``), "homography" and, with
    descriptors, "desc" and "warped_desc" (H, W, C) float32."""
    device = resolve_device(device)
    kind = "descriptors" if with_descriptors else "repeatability"
    out_dir = Path(EXPER_PATH, kind, config["data"]["experiment_name"])
    out_dir.mkdir(parents=True, exist_ok=True)
    model = model.to(device).eval()

    def infer(images):
        x = torch.as_tensor(np.asarray(images, np.float32)).to(device)
        out = superpoint_inference(model, x)
        keys = ("prob_heatmap_nms", "desc") if with_descriptors \
            else ("prob_heatmap_nms",)
        return [out[k].cpu().numpy() for k in keys]

    for bi, batch in enumerate(loader):
        names = batch.get("name", [str(bi)])
        out1 = infer(batch["image"])
        out2 = infer(batch["warped_image"])
        for i, name in enumerate(names):
            payload = {
                "image": np.asarray(batch["image"][i, ..., 0]),
                "warped_image": np.asarray(batch["warped_image"][i, ..., 0]),
                "prob": out1[0][i],
                "warped_prob": out2[0][i],
                "homography": np.asarray(batch["homography"][i]),
            }
            if with_descriptors:
                payload["desc"] = out1[1][i]
                payload["warped_desc"] = out2[1][i]
            np.savez_compressed(out_dir / f"{name}.npz", **payload)
    return out_dir
