"""COCO dataset: images and optional exported pseudo-labels
(``spnerf_tpu/data/coco.py``), numpy only.

The host reads, resizes and (where ``on_device`` is false)
photometric-augments; keypoint heatmaps, valid masks and the warped pair
are built on the device in the training step. Images are read as
``cv2.imread(..., IMREAD_GRAYSCALE)`` reads them (``data/imread.py``,
the decoder by the file's signature: JPEG by the port's own decoder, PNG,
PBM / PGM / PPM), then
``ratio_preserving_resize``.

Three modes, as the reference:
- export (``has_labels`` false): {"image", "name"} for pseudo-label
  export;
- MagicPoint training (``has_labels``, ``warped_pair`` false):
  photometric and (on-device) homographic self-augmentation;
- SuperPoint training (``warped_pair``): with host photometric, a second,
  independently augmented copy of the image ("image_warp_src") that the
  device warps into the pair.

``shard`` splits the images into contiguous blocks for a multi-process
export: ``auto`` takes this process's block (its rank of the process
group, ``parallel.distributed``; the whole set without a group), an
explicit [k, n] the k-th of n. ``shard_offset`` is the block's first
global index (``tasks/export.py`` starts its image cursor there).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from spnerf_tpu_torch import settings
from spnerf_tpu_torch.data.imread import read_gray
from spnerf_tpu_torch.data.photometric import PhotometricAug
from spnerf_tpu_torch.data.preprocessing import ratio_preserving_resize
from spnerf_tpu_torch.data.rng import ThreadLocalRNG, stable_seed
from spnerf_tpu_torch.parallel.distributed import process_count, process_index


MAX_KPTS = 1024


class COCO:
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
        self._rng = ThreadLocalRNG(stable_seed("coco", self.split))

    def _init_dataset(self):
        data_dir = Path(settings.DATA_PATH, self.config.get("name", "COCO"),
                        "images", self.split)
        image_paths = sorted(data_dir.iterdir()) if data_dir.exists() else []
        truncate = self.config.get("truncate")
        if truncate:
            image_paths = image_paths[: int(truncate * len(image_paths))]
        # export sharding: contiguous blocks (not strides) keep every
        # image's global dataset index, and so its homographies, those of
        # the unsharded enumeration
        self.shard_offset = 0
        shard = self.config.get("shard")
        if shard:
            if shard == "auto":
                k, n = process_index(), process_count()
            else:
                k, n = int(shard[0]), int(shard[1])
            if not 0 <= k < n:
                raise ValueError(f"bad shard {shard}")
            starts = [round(i * len(image_paths) / n) for i in range(n + 1)]
            self.shard_offset = starts[k]
            image_paths = image_paths[starts[k]:starts[k + 1]]
        names = [p.stem for p in image_paths]
        files = {"image_paths": [str(p) for p in image_paths], "names": names}
        if self.config.get("has_labels"):
            label_dir = Path(settings.EXPER_PATH, self.config["has_labels"],
                             self.split)
            files["label_paths"] = [str(label_dir / f"{n}.npy") for n in names]
        return files

    def __len__(self):
        return len(self.samples["image_paths"])

    def __getitem__(self, idx: int) -> dict:
        img = read_gray(self.samples["image_paths"][idx])
        img = ratio_preserving_resize(
            img, self.config["preprocessing"]["resize"]
        ).astype(np.float32)

        out = {"name": self.samples["names"][idx]}

        if "label_paths" in self.samples:
            points = np.load(self.samples["label_paths"][idx]).reshape(-1, 2)
            kpts = np.zeros((MAX_KPTS, 2), np.float32)
            mask = np.zeros((MAX_KPTS,), bool)
            n = min(len(points), MAX_KPTS)
            kpts[:n] = points[:n]
            mask[:n] = True
            out["kpts"] = kpts
            out["kpts_mask"] = mask

        aug = self.photometric is not None and self.split == "training"
        raw = self.photometric(img, self._rng.get()) if aug else img
        out["image"] = (raw / 255.0)[..., None].astype(np.float32)

        if self.warped_pair and aug:
            # independent photometric draw for the to-be-warped view.
            # Without host augmentation this would be a byte-identical
            # copy of "image" (prepare_superpoint_batch falls back to
            # it), so it is only shipped when it actually differs —
            # on-device photometric mode draws its own pair there.
            warp_src = self.photometric(img, self._rng.get())
            out["image_warp_src"] = (warp_src / 255.0)[..., None].astype(np.float32)

        return out
