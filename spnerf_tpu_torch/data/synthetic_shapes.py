"""Synthetic Shapes dataset (``spnerf_tpu/data/synthetic_shapes.py``):
on-disk generation and fixed-shape samples, numpy only.

Generation is resumable per primitive and writes
``DATA_PATH/<data_dir>/<primitive>/{images,points}/<split>/<idx>.{png,npy}``
as the reference does, through the port's byte-equal copies of cv2's
filters and codecs: the sample (``data/synthetic_draw.py``), the 8-bit
Gaussian blur (``data/cv_filter.py``), the bilinear resize
(``data/resize.py``) and the PNG writer and reader (``data/png.py``), so
one thread writes the reference's files byte for byte (cv2's generator is
per thread, as OpenCV keeps it). As in the
reference, each primitive's generator is seeded with
``random_seed + hash(primitive) % 100000``: Python salts ``str`` hashes
per process, so the generated set repeats across processes only under a
fixed ``PYTHONHASHSEED``. Samples carry padded (MAX_KPTS, 2) keypoints
and a validity mask; heatmaps and the homographic augmentation are built
on the device in the training step. Host photometric augmentation
(``data/photometric.py``) runs where ``on_device`` is false.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from spnerf_tpu_torch import settings
from spnerf_tpu_torch.data import png
from spnerf_tpu_torch.data.cv_filter import gaussian_blur_u8
from spnerf_tpu_torch.data.photometric import PhotometricAug
from spnerf_tpu_torch.data.resize import resize_linear
from spnerf_tpu_torch.data.rng import ThreadLocalRNG, stable_seed
from spnerf_tpu_torch.data.synthetic_draw import PRIMITIVES, generate_sample
from spnerf_tpu_torch.utils.config import dict_update, parse_primitives

MAX_KPTS = 128

DEFAULT_CONFIG = {
    "primitives": "all",
    "truncate": {},
    "data_dir": "synthetic_shapes",
    "generation": {
        "split_sizes": {"training": 10000, "validation": 200, "test": 500},
        "image_size": [960, 1280],
        "random_seed": 0,
        "params": {
            "generate_background": {
                "min_kernel_size": 150,
                "max_kernel_size": 500,
                "min_rad_ratio": 0.02,
                "max_rad_ratio": 0.031,
            },
        },
    },
    "preprocessing": {"resize": [240, 320], "blur_size": 11},
    "augmentation": {
        "photometric": {"enable": False, "primitives": "all", "params": {}},
        "homographic": {"enable": False, "params": {}, "valid_border_margin": 0},
    },
}


class SyntheticShapes:
    """Map-style dataset over generated synthetic shapes."""

    def __init__(self, data_config: dict, task: str = "training"):
        self.config = dict_update(DEFAULT_CONFIG, dict(data_config or {}))
        self.split = (
            "training" if task == "training"
            else "validation" if task == "validation"
            else "test"
        )
        self.primitives = parse_primitives(self.config["primitives"], PRIMITIVES)
        self.samples = self._init_dataset()
        photo_cfg = self.config["augmentation"]["photometric"]
        # on_device routes photometric into the training step
        # (ops/photometric_device.py); the host then ships raw images
        self.photometric = (
            PhotometricAug(photo_cfg)
            if photo_cfg.get("enable") and not photo_cfg.get("on_device")
            else None
        )
        self._rng = ThreadLocalRNG(
            self.config["generation"]["random_seed"] + stable_seed(self.split) % 10000
        )

    # ---------------------------------------------------------------- gen
    def _primitive_dir(self, primitive: str) -> Path:
        return Path(settings.DATA_PATH, self.config["data_dir"], primitive)

    def _dump_primitive(self, primitive: str) -> None:
        """Generate and cache one primitive's splits (resumable)."""
        gen = self.config["generation"]
        out_dir = self._primitive_dir(primitive)
        target_h, target_w = self.config["preprocessing"]["resize"]
        blur = self.config["preprocessing"]["blur_size"]
        gen_size = tuple(gen["image_size"])
        rng = np.random.default_rng(gen["random_seed"] + hash(primitive) % 100000)
        for split, size in gen["split_sizes"].items():
            img_dir = out_dir / "images" / split
            pts_dir = out_dir / "points" / split
            img_dir.mkdir(parents=True, exist_ok=True)
            pts_dir.mkdir(parents=True, exist_ok=True)
            for i in range(size):
                img_path = img_dir / f"{i}.png"
                pts_path = pts_dir / f"{i}.npy"
                if img_path.exists() and pts_path.exists():
                    continue
                img, points = generate_sample(
                    primitive, rng, gen_size, gen.get("params", {})
                )
                img = gaussian_blur_u8(img, blur)
                scale = np.array(
                    [target_h / gen_size[0], target_w / gen_size[1]], np.float32
                )
                img = resize_linear(img, (target_w, target_h))
                points = points * scale[None, :] if len(points) else points
                png.write_gray(img_path, img)
                np.save(pts_path, points.astype(np.float32))

    def _init_dataset(self):
        truncate = self.config.get("truncate") or {}
        image_paths, point_paths = [], []
        for primitive in self.primitives:
            pdir = self._primitive_dir(primitive)
            split_size = self.config["generation"]["split_sizes"][self.split]
            have = len(list((pdir / "images" / self.split).glob("*.png"))) if (
                pdir / "images" / self.split
            ).exists() else 0
            if have < split_size:
                self._dump_primitive(primitive)
            imgs = sorted(
                (pdir / "images" / self.split).glob("*.png"),
                key=lambda p: int(p.stem),
            )[:split_size]
            frac = truncate.get(primitive, 1.0) or 1.0
            imgs = imgs[: max(1, int(len(imgs) * frac))]
            image_paths += imgs
            point_paths += [
                p.parent.parent.parent / "points" / self.split / f"{p.stem}.npy"
                for p in imgs
            ]
        return {"images": image_paths, "points": point_paths}

    # -------------------------------------------------------------- access
    def __len__(self):
        return len(self.samples["images"])

    def __getitem__(self, idx: int) -> dict:
        img = png.read_gray(self.samples["images"][idx])
        points = np.load(self.samples["points"][idx]).reshape(-1, 2)

        if self.photometric is not None and self.split == "training":
            img = self.photometric(img, self._rng.get())

        kpts = np.zeros((MAX_KPTS, 2), np.float32)
        mask = np.zeros((MAX_KPTS,), bool)
        n = min(len(points), MAX_KPTS)
        kpts[:n] = points[:n]
        mask[:n] = True

        return {
            "image": (img.astype(np.float32) / 255.0)[..., None],  # (H, W, 1)
            "kpts": kpts,
            "kpts_mask": mask,
        }
