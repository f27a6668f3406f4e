"""NeRF-rendered multi-view dataset (``spnerf_tpu/data/nerf_dataset.py``),
numpy.

Scene layout on disk (``tasks/nerf_task.write_scene`` writes it, as does
any NerfStudio-compatible exporter):

    DATA_PATH/<name>/<scene>/images/<split>/<i>.png  (or .jpg, .ppm, ...)
    DATA_PATH/<name>/<scene>/camera_transforms/<split>/<i>.npy  (4x4 c2w)
    DATA_PATH/<name>/<scene>/depth/<split>/<i>.npy              (H, W) along-ray

The host loads a frame, its partner frame 7-15% of the sequence away and
their cameras; the partner's keypoints are reprojected on the device
(``train/pipeline.prepare_nerf_batch``). Images are read by
``data/imread.read_gray`` (PNG, PBM / PGM / PPM or JPEG by signature,
byte-equal to ``cv2.imread(..., IMREAD_GRAYSCALE)``);
the draws come from the same seeded numpy streams as the reference's, so
its samples and the port's are equal.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from spnerf_tpu_torch import settings
from spnerf_tpu_torch.data.photometric import PhotometricAug
from spnerf_tpu_torch.data.imread import read_gray
from spnerf_tpu_torch.data.rng import ThreadLocalRNG, stable_seed

MAX_KPTS = 1024


def camera_intrinsics(shape, fov_degrees: float) -> np.ndarray:
    H, W = shape
    c_x, c_y = W // 2, H // 2
    f = c_y / np.tan(np.deg2rad(fov_degrees) / 2.0)
    return np.array([[f, 0, c_x], [0, f, c_y], [0, 0, 1]], np.float32)


def axis_transform(cam_matrix: np.ndarray) -> np.ndarray:
    """NerfStudio -> OpenCV axis flip."""
    return cam_matrix @ np.diag([1.0, -1.0, -1.0, 1.0]).astype(cam_matrix.dtype)


class NeRFDataset:
    """Frames of one scene and split: {"name", "image" (H, W, 1) in [0,
    1], "depth", "rotation", "translation", "intrinsics"}, with
    ``has_labels`` {"kpts" (1024, 2), "kpts_mask"} from
    EXPER_PATH/<has_labels>/<split>, with ``warped_pair`` the partner's
    {"image_warp", "rotation_warp", "translation_warp", "warped_name"};
    training frames are photometric-augmented on the host where
    ``augmentation.photometric`` is enabled and not ``on_device``, and
    randomly cropped to ``downsample_size`` where ``downsample`` is set,
    the intrinsics recomputed for the crop."""

    def __init__(self, data_config: dict, task: str = "training"):
        self.config = data_config
        self.split = (
            "training" if task == "training"
            else "validation" if task == "validation"
            else "test"
        )
        self.samples = self._init_dataset()
        photo = self.config.get("augmentation", {}).get("photometric", {})
        self.photometric = (
            PhotometricAug(photo)
            if photo.get("enable") and not photo.get("on_device")
            else None
        )
        self.warped_pair = bool(self.config.get("warped_pair"))
        self._rng = ThreadLocalRNG(stable_seed("nerf", self.split))

    def _init_dataset(self):
        scene = Path(settings.DATA_PATH, self.config.get("name", "NeRF"),
                     self.config["data_dir"])
        img_dir = scene / "images" / self.split
        cam_dir = scene / "camera_transforms" / self.split
        depth_dir = scene / "depth" / self.split
        # a string sort of the stems: "10" before "2", as the reference
        image_paths = (sorted(img_dir.glob("*"), key=lambda p: p.stem)
                       if img_dir.exists() else [])
        names = [p.stem for p in image_paths]
        files = {
            "image_paths": [str(p) for p in image_paths],
            "names": names,
            "camera_transform_paths": [str(cam_dir / f"{n}.npy") for n in names],
            "depth_paths": [str(depth_dir / f"{n}.npy") for n in names],
        }
        if self.config.get("has_labels"):
            label_dir = Path(settings.EXPER_PATH, self.config["has_labels"],
                             self.split)
            files["label_paths"] = [str(label_dir / f"{n}.npy") for n in names]
        return files

    def __len__(self):
        return len(self.samples["image_paths"])

    def _random_partner(self, index: int) -> int:
        """A frame 7-15% of the sequence away, either side."""
        n = len(self)
        lo, hi = max(1, int(0.07 * n)), max(2, int(0.15 * n))
        candidates = []
        for off in range(lo, hi):
            if index - off >= 0:
                candidates.append(index - off)
            if index + off < n:
                candidates.append(index + off)
        if not candidates:
            candidates = [i for i in range(n) if i != index] or [index]
        return int(self._rng.get().choice(candidates))

    def _load_frame(self, index: int):
        img = read_gray(self.samples["image_paths"][index])
        T = axis_transform(np.load(self.samples["camera_transform_paths"][index]))
        R = T[:3, :3].astype(np.float32)
        t = T[:3, 3:4].astype(np.float32)
        return img.astype(np.float32), R, t

    def __getitem__(self, index: int) -> dict:
        img, R, t = self._load_frame(index)
        depth = np.load(self.samples["depth_paths"][index]).astype(np.float32)
        H, W = img.shape
        fov = self.config.get("fov", 60.0)
        out = {
            "name": self.samples["names"][index],
            "depth": depth,
            "rotation": R,
            "translation": t,
            "intrinsics": camera_intrinsics((H, W), fov),
        }

        if "label_paths" in self.samples:
            points = np.load(self.samples["label_paths"][index]).reshape(-1, 2)
            kpts = np.zeros((MAX_KPTS, 2), np.float32)
            mask = np.zeros((MAX_KPTS,), bool)
            n = min(len(points), MAX_KPTS)
            kpts[:n] = points[:n]
            mask[:n] = True
            out["kpts"] = kpts
            out["kpts_mask"] = mask

        # host photometric augmentation of both frames, each its own draw
        aug = self.photometric is not None and self.split == "training"
        if aug:
            img = self.photometric(img, self._rng.get())

        if self.warped_pair:
            j = self._random_partner(index)
            wimg, Rw, tw = self._load_frame(j)
            if aug:
                wimg = self.photometric(wimg, self._rng.get())
            out["image_warp"] = (wimg / 255.0)[..., None].astype(np.float32)
            out["rotation_warp"] = Rw
            out["translation_warp"] = tw
            out["warped_name"] = self.samples["names"][j]

        # random crop of every aligned array, the intrinsics recomputed for
        # the crop's size
        if self.config.get("downsample") and self.split == "training":
            dh, dw = self.config["downsample_size"]
            i0 = int(self._rng.get().integers(0, max(H - dh, 0) + 1))
            j0 = int(self._rng.get().integers(0, max(W - dw, 0) + 1))
            img = img[i0:i0 + dh, j0:j0 + dw]
            out["depth"] = out["depth"][i0:i0 + dh, j0:j0 + dw]
            if "image_warp" in out:
                out["image_warp"] = out["image_warp"][i0:i0 + dh, j0:j0 + dw]
            if "kpts" in out:
                shifted = out["kpts"] - np.array([i0, j0], np.float32)
                inside = ((shifted[:, 0] >= 0) & (shifted[:, 0] < dh)
                          & (shifted[:, 1] >= 0) & (shifted[:, 1] < dw))
                out["kpts"] = np.where(inside[:, None], shifted,
                                       0.0).astype(np.float32)
                out["kpts_mask"] = out["kpts_mask"] & inside
            out["intrinsics"] = camera_intrinsics((dh, dw), fov)

        out["image"] = (img / 255.0)[..., None].astype(np.float32)
        return out
