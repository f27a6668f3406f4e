"""Model, dataset and loader factories (``spnerf_tpu/utils/factories.py``):
the reference's four datasets, SyntheticShapes, COCO, NeRF and HPatches,
by ``class_name`` (or ``name``)."""

from __future__ import annotations

from spnerf_tpu_torch.data.coco import COCO
from spnerf_tpu_torch.data.hpatches import HPatches
from spnerf_tpu_torch.data.loader import DataLoader
from spnerf_tpu_torch.data.nerf_dataset import NeRFDataset
from spnerf_tpu_torch.data.synthetic_shapes import SyntheticShapes
from spnerf_tpu_torch.models.superpoint import (
    SuperPoint,
    SuperPointConfig,
    init_superpoint,
)


def get_model(model_config: dict, seed: int = 0, device="cuda") -> SuperPoint:
    """The config's SuperPoint (``class_name`` SuperPoint) with weights
    drawn from ``seed``, on ``device``."""
    name = model_config.get("class_name", "SuperPoint")
    if name != "SuperPoint":
        raise ValueError(f"Unknown model class: {name}")
    return init_superpoint(seed, SuperPointConfig.from_dict(model_config),
                           device=device)


def get_dataset(data_config: dict, task: str = "training"):
    name = data_config.get("class_name", data_config.get("name"))
    if name == "SyntheticShapes":
        return SyntheticShapes(data_config, task)
    if name == "COCO":
        return COCO(data_config, task)
    if name == "NeRF":
        return NeRFDataset(data_config, task)
    if name == "HPatches":
        return HPatches(data_config)
    raise ValueError(f"Unknown dataset class: {name}")


def get_loaders(config: dict, task: str, nerf_train: bool = False) -> dict:
    """Loaders of ``config["data"]``: for ``task`` "train" (or
    "training") {"train", "validation"}, the training one shuffled and
    dropping its last partial batch; with ``nerf_train`` the lists of
    ``get_nerf_loaders``; else {task: loader}. Each loads its samples on
    ``data.num_workers`` threads (default 0: the loader's own)."""
    if nerf_train:
        return get_nerf_loaders(config)
    data_cfg = config["data"]
    batch_size = data_cfg.get("batch_size", 1)

    def make(split):
        training = split == "training"
        return DataLoader(get_dataset(data_cfg, split), batch_size=batch_size,
                          shuffle=training, drop_last=training,
                          num_workers=data_cfg.get("num_workers", 0))

    if task in ("train", "training"):
        return {"train": make("training"), "validation": make("validation")}
    return {task: make(task)}


def get_nerf_loaders(config: dict) -> dict:
    """{"train": [...], "validation": [...]}: one training and one
    validation loader per scene of ``data.all_data_dirs``, with labels
    from the matching entry of ``data.all_label_dirs``. Training loaders
    shuffle and drop the last partial batch; every loader takes
    ``data.num_workers``."""
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
                shuffle=training, drop_last=training,
                num_workers=data_cfg.get("num_workers", 0)))
    return loaders
