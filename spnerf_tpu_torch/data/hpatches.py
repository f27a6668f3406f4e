"""HPatches evaluation dataset (``spnerf_tpu/data/hpatches.py``).

Yields image pairs + the GT homography adapted to the ratio-preserving
resize, as float32 numpy, from DATA_PATH/<name>/<sequence>/{1..6}.ppm
and H_1_{2..6}. ``alteration``: 'i' (illumination), 'v' (viewpoint) or
'all'. Images are read by ``data/imread.py`` (the decoder by the file's
signature), as ``cv2.imread(..., IMREAD_GRAYSCALE)`` reads them.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from spnerf_tpu_torch import settings
from spnerf_tpu_torch.data.imread import read_gray
from spnerf_tpu_torch.data.preprocessing import (
    adapt_homography_to_ratio_resize,
    ratio_preserving_resize,
)


class HPatches:
    def __init__(self, data_config: dict):
        self.config = data_config
        self.samples = self._init_dataset()

    def _init_dataset(self):
        data_dir = Path(settings.DATA_PATH, self.config.get("name", "HPatches"))
        alteration = self.config.get("alteration", "all")
        image_paths, warped_paths, homographies, names = [], [], [], []
        if data_dir.exists():
            for folder in sorted(p for p in data_dir.iterdir() if p.is_dir()):
                if alteration in ("i", "v") and folder.stem[0] != alteration:
                    continue
                ext = ".ppm"
                if not (folder / ("1" + ext)).exists():
                    ext = ".jpg"
                for i in range(2, 7):
                    if not (folder / (str(i) + ext)).exists():
                        continue
                    image_paths.append(str(folder / ("1" + ext)))
                    warped_paths.append(str(folder / (str(i) + ext)))
                    homographies.append(np.loadtxt(str(folder / f"H_1_{i}")))
                    names.append(f"{folder.stem}_1_{i}")
        return {
            "image_paths": image_paths,
            "warped_image_paths": warped_paths,
            "homography": homographies,
            "names": names,
        }

    def __len__(self):
        return len(self.samples["image_paths"])

    def __getitem__(self, idx: int) -> dict:
        image = read_gray(self.samples["image_paths"][idx])
        warped = read_gray(self.samples["warped_image_paths"][idx])
        H = np.asarray(self.samples["homography"][idx], np.float32)

        resize = self.config.get("preprocessing", {}).get("resize")
        if resize:
            H = adapt_homography_to_ratio_resize(
                H, image.shape[:2], warped.shape[:2], resize
            )
            image = ratio_preserving_resize(image, resize)
            warped = ratio_preserving_resize(warped, resize)

        return {
            "image": (image.astype(np.float32) / 255.0)[..., None],
            "warped_image": (warped.astype(np.float32) / 255.0)[..., None],
            "homography": H.astype(np.float32),
            "name": self.samples["names"][idx],
        }
