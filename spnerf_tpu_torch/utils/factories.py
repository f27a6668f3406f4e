"""Dataset and loader factories (``spnerf_tpu/utils/factories.py``).

Only the NeRF dataset so far: the other readers of the reference
(SyntheticShapes, COCO, HPatches) use cv2 and wait for ROADMAP Queue 1
item 5 (host data readers and augmentation).
"""

from __future__ import annotations

from spnerf_tpu_torch.data.loader import DataLoader
from spnerf_tpu_torch.data.nerf_dataset import NeRFDataset


def get_dataset(data_config: dict, task: str = "training"):
    name = data_config.get("class_name", data_config.get("name"))
    if name == "NeRF":
        return NeRFDataset(data_config, task)
    raise NotImplementedError(
        f"get_dataset: {name!r} is not ported yet (ROADMAP Queue 1 item 5, "
        "host data readers and augmentation); only 'NeRF' is")


def get_nerf_loaders(config: dict) -> dict:
    """{"train": [...], "validation": [...]}: one training and one
    validation loader per scene of ``data.all_data_dirs``, with labels
    from the matching entry of ``data.all_label_dirs``. Training loaders
    shuffle and drop the last partial batch."""
    data_cfg = dict(config["data"])
    batch_size = data_cfg.get("batch_size", 1)
    all_dirs = data_cfg.get("all_data_dirs") or []
    all_labels = data_cfg.get("all_label_dirs") or [None] * len(all_dirs)
    loaders = {"train": [], "validation": []}
    for scene, labels in zip(all_dirs, all_labels):
        scene_cfg = dict(data_cfg, data_dir=scene)
        if labels is not None:
            scene_cfg["has_labels"] = labels
        for split, key in (("training", "train"), ("validation", "validation")):
            training = split == "training"
            loaders[key].append(DataLoader(
                get_dataset(scene_cfg, split), batch_size=batch_size,
                shuffle=training, drop_last=training))
    return loaders
