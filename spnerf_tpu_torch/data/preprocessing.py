"""Host-side image preprocessing shared by datasets
(``spnerf_tpu/data/preprocessing.py``), without cv2: the resize is
``data/resize.resize_linear``, equal to ``cv2.resize`` (``INTER_LINEAR``)
byte for byte."""

from __future__ import annotations

import numpy as np

from spnerf_tpu_torch.data.resize import resize_linear


def ratio_preserving_resize(image: np.ndarray, target_size) -> np.ndarray:
    """Scale-to-cover + center-crop of an (H, W) uint8 image to
    ``target_size`` (H_t, W_t)."""
    th, tw = int(target_size[0]), int(target_size[1])
    h, w = image.shape[:2]
    s = max(th / h, tw / w)
    nh, nw = int(h * s), int(w * s)
    resized = resize_linear(image, (nw, nh))
    y0 = (nh - th) // 2
    x0 = (nw - tw) // 2
    return resized[y0 : y0 + th, x0 : x0 + tw]


def adapt_homography_to_ratio_resize(
    homography: np.ndarray,
    image_shape,
    warped_image_shape,
    target_size,
) -> np.ndarray:
    """Conjugate a GT homography by the ratio-preserving resize + crop of
    both images; float32 products in the reference's order."""
    target = np.asarray(target_size, np.float32)
    src = np.asarray(image_shape, np.float32)
    wsrc = np.asarray(warped_image_shape, np.float32)

    s = float(np.max(target / src))
    up_scale = np.diag([1.0 / s, 1.0 / s, 1.0]).astype(np.float32)
    ws = float(np.max(target / wsrc))
    down_scale = np.diag([ws, ws, 1.0]).astype(np.float32)

    pad_y = int((src[0] * s - target[0]) / 2.0)
    pad_x = int((src[1] * s - target[1]) / 2.0)
    translation = np.eye(3, dtype=np.float32)
    translation[0, 2] = pad_x
    translation[1, 2] = pad_y

    wpad_y = int((wsrc[0] * ws - target[0]) / 2.0)
    wpad_x = int((wsrc[1] * ws - target[1]) / 2.0)
    warped_translation = np.eye(3, dtype=np.float32)
    warped_translation[0, 2] = -wpad_x
    warped_translation[1, 2] = -wpad_y

    return (
        warped_translation @ down_scale @ homography.astype(np.float32)
        @ up_scale @ translation
    )
