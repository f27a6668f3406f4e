"""On-device batch preparation: heatmaps, homographic augmentation, pairs
(``spnerf_tpu/train/pipeline.py``).

The host ships (image, padded keypoints); everything geometric happens
batched on the device inside the training step. Homographies arrive as
an argument (the reference samples them from its key): the caller draws
them with ``geometry.homography.sample_homographies`` from an explicit
generator.
"""

from __future__ import annotations

import torch

from spnerf_tpu_torch.geometry.homography import warp_points
from spnerf_tpu_torch.geometry.keypoints import (
    compute_keypoint_map,
    filter_points_mask,
)
from spnerf_tpu_torch.ops.image_warp import (
    compute_valid_mask,
    warp_image,
    warp_image_matmul,
)


def make_heatmaps(kpts: torch.Tensor, kpts_mask: torch.Tensor, shape):
    """(B, N, 2) padded points + (B, N) mask -> (B, H, W) binary maps."""
    return compute_keypoint_map(kpts, shape, kpts_mask)


def homographic_augment(homographies: torch.Tensor, images: torch.Tensor,
                        kpts: torch.Tensor, kpts_mask: torch.Tensor,
                        erosion: int = 0) -> dict:
    """Warp images, keypoints and the valid mask by ``homographies``
    (B, 3, 3): {"image", "kpts", "kpts_mask", "kpts_heatmap",
    "valid_mask", "homography"}."""
    B, H, W, _ = images.shape
    homographies = homographies.to(images.device)
    if images.shape[-1] == 1:
        warped_images = warp_image_matmul(images, homographies)
    else:
        warped_images = warp_image(images, homographies, mode="bilinear")
    warped_kpts = warp_points(kpts, homographies)
    warped_mask = kpts_mask.bool() & filter_points_mask(warped_kpts, (H, W))
    return {
        "image": warped_images,
        "kpts": warped_kpts,
        "kpts_mask": warped_mask,
        "kpts_heatmap": make_heatmaps(warped_kpts, warped_mask, (H, W)),
        "valid_mask": compute_valid_mask((H, W), homographies, erosion),
        "homography": homographies,
    }


def prepare_detector_batch(homographies: torch.Tensor | None, batch: dict,
                           erosion: int = 0) -> dict:
    """MagicPoint batch: heatmap labels, and with ``homographies`` the
    homographic self-augmentation, which replaces the raw view.

    batch: {"image": (B, H, W, 1), "kpts": (B, N, 2), "kpts_mask": (B, N)}
    -> {"image", "kpts_heatmap", "valid_mask"}.
    """
    image = batch["image"]
    B, H, W, _ = image.shape
    if homographies is None:
        return {
            "image": image,
            "kpts_heatmap": make_heatmaps(batch["kpts"], batch["kpts_mask"],
                                          (H, W)),
            "valid_mask": torch.ones((B, H, W), dtype=torch.int32,
                                     device=image.device),
        }
    warp = homographic_augment(homographies, image, batch["kpts"],
                               batch["kpts_mask"], erosion)
    return {k: warp[k] for k in ("image", "kpts_heatmap", "valid_mask")}


def prepare_superpoint_batch(homographies: torch.Tensor, batch: dict,
                             erosion: int = 0) -> dict:
    """SuperPoint batch: the raw view, its warped pair and the pair's
    homography: {"raw", "warp", "homography"}. The warped view is made
    from ``batch["image_warp_src"]`` where present (an independently
    augmented copy of the image)."""
    image = batch["image"]
    B, H, W, _ = image.shape
    warp = homographic_augment(homographies,
                               batch.get("image_warp_src", image),
                               batch["kpts"], batch["kpts_mask"], erosion)
    return {
        "raw": {
            "image": image,
            "kpts_heatmap": make_heatmaps(batch["kpts"], batch["kpts_mask"],
                                          (H, W)),
            "valid_mask": torch.ones((B, H, W), dtype=torch.int32,
                                     device=image.device),
        },
        "warp": {k: warp[k] for k in ("image", "kpts_heatmap", "valid_mask")},
        "homography": warp["homography"],
    }


def prepare_nerf_batch(batch: dict):
    """NeRF warped-pair batch (keypoints reprojected through rendered
    depth): comes with ``geometry/reprojection.py`` in the NeRF slice of
    the port."""
    raise NotImplementedError(
        "prepare_nerf_batch needs geometry/reprojection.py, which the NeRF "
        "slice of the port brings")
