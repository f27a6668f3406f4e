"""Host photometric augmentation (``spnerf_tpu/data/photometric.py``),
numpy only: six primitives applied in a random order per sample, with the
reference's ``Generator`` draws in its order.

Brightness, contrast and the two noises are the reference's arithmetic
and equal it exactly for the same generator. Motion blur and shade call
the port's float32 filters (``data/cv_filter.py``) for ``cv2.filter2D``
and ``cv2.GaussianBlur``, within about 1e-4 on the 0-255 scale; the shade's
ellipses are ``data/cv_draw.ellipse``, byte-equal to cv2's.
"""

from __future__ import annotations

import numpy as np

from spnerf_tpu_torch.data import cv_draw
from spnerf_tpu_torch.data.cv_filter import filter2d_f32, gaussian_blur_f32

PRIMITIVES = (
    "random_brightness",
    "random_contrast",
    "additive_gaussian_noise",
    "additive_speckle_noise",
    "motion_blur",
    "additive_shade",
)


def random_brightness(img, rng, max_abs_change=50):
    delta = rng.uniform(-max_abs_change, max_abs_change)
    return np.clip(img.astype(np.float32) + delta, 0, 255)


def random_contrast(img, rng, strength_range=(0.5, 1.5)):
    s = rng.uniform(*strength_range)
    mean = img.mean()
    return np.clip((img.astype(np.float32) - mean) * s + mean, 0, 255)


def additive_gaussian_noise(img, rng, stddev_range=(0, 10)):
    std = rng.uniform(*stddev_range)
    noise = rng.normal(0.0, std, img.shape)
    return np.clip(img.astype(np.float32) + noise, 0, 255)


def additive_speckle_noise(img, rng, prob_range=(0.0, 0.005)):
    p = rng.uniform(*prob_range)
    u = rng.uniform(size=img.shape)
    out = img.astype(np.float32).copy()
    out[u < p] = 0.0
    out[u > 1 - p] = 255.0
    return out


def motion_blur(img, rng, max_kernel_size=3):
    # odd kernel size in [1, max]
    ksize = int(rng.integers(0, (max_kernel_size + 1) // 2 + 1)) * 2 + 1
    ksize = min(ksize, max_kernel_size if max_kernel_size % 2 else max_kernel_size + 1)
    if ksize <= 1:
        return img.astype(np.float32)
    center = (ksize - 1) // 2
    kernel = np.zeros((ksize, ksize), np.float32)
    direction = rng.choice(["h", "v", "d1", "d2"])
    if direction == "h":
        kernel[center, :] = 1.0
    elif direction == "v":
        kernel[:, center] = 1.0
    elif direction == "d1":
        np.fill_diagonal(kernel, 1.0)
    else:
        np.fill_diagonal(np.fliplr(kernel), 1.0)
    kernel /= kernel.sum()
    return filter2d_f32(img.astype(np.float32), kernel)


def additive_shade(img, rng, nb_ellipses=20, transparency_range=(-0.5, 0.8),
                   kernel_size_range=(100, 150)):
    H, W = img.shape[:2]
    mask = np.zeros((H, W), np.uint8)
    min_dim = min(H, W) / 4
    for _ in range(nb_ellipses):
        ax = int(max(rng.uniform(min_dim / 5, min_dim), 1))
        ay = int(max(rng.uniform(min_dim / 5, min_dim), 1))
        max_rad = max(ax, ay)
        x = int(rng.integers(max_rad, max(W - max_rad, max_rad + 1)))
        y = int(rng.integers(max_rad, max(H - max_rad, max_rad + 1)))
        angle = rng.uniform(0, 90)
        cv_draw.ellipse(mask, (x, y), (ax, ay), angle, 255)
    transparency = rng.uniform(*transparency_range)
    ksize = int(rng.integers(*kernel_size_range))
    if ksize % 2 == 0:
        ksize += 1
    mask_f = gaussian_blur_f32(mask.astype(np.float32), ksize)
    shaded = img.astype(np.float32) * (1 - transparency * mask_f / 255.0)
    return np.clip(shaded, 0, 255)


AUG_FNS = {
    "random_brightness": random_brightness,
    "random_contrast": random_contrast,
    "additive_gaussian_noise": additive_gaussian_noise,
    "additive_speckle_noise": additive_speckle_noise,
    "motion_blur": motion_blur,
    "additive_shade": additive_shade,
}


class PhotometricAug:
    """Applies configured primitives in random shuffled order.

    config: {"enable": bool, "primitives": [...] | "all", "params": {...}}
    """

    def __init__(self, config: dict | None):
        config = config or {}
        prims = config.get("primitives", "all")
        if prims == "all" or prims is None:
            prims = list(PRIMITIVES)
        self.primitives = [p for p in prims if p in AUG_FNS]
        self.params = config.get("params", {}) or {}

    def __call__(self, image: np.ndarray, rng: np.random.Generator) -> np.ndarray:
        """uint8/float (H, W) image in [0, 255] -> float32 in [0, 255]."""
        out = image.astype(np.float32)
        order = rng.permutation(len(self.primitives))
        for i in order:
            name = self.primitives[i]
            out = AUG_FNS[name](out, rng, **self.params.get(name, {}))
        return out.astype(np.float32)
