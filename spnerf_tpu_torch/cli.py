"""Task dispatcher CLI of the port: the reference's entry point
(``spnerf_tpu/cli.py``) with ``--device``:

    python -m spnerf_tpu_torch.cli --config-path cfg.yaml --task train \\
        [--validate-training] [--no-include-mask-loss] [--nerf-loss] \\
        [--train-nerf] [--no-enable-homography-adaptation] \\
        [--split training] [--seed 0] [--set key.path=value ...] \\
        [--device cuda|cpu]

Tasks: train, export_pseudo_labels, export_NeRF_labels,
export_HPatches_Repeatability, export_HPatches_Descriptors. Configs are
read by the port's own YAML reader (``utils.config``), so no ``yaml``
package is needed. Every task runs on the card unless ``--device cpu``.
The bootstrap of the README runs from its datasets: ``train`` on
``magicpoint_syn.yaml`` (Synthetic Shapes, generated on first use),
``export_pseudo_labels`` on ``magicpoint_coco_export.yaml`` (COCO JPEGs
through the port's own decoder), then ``train`` on
``magicpoint_coco_train.yaml`` and ``superpoint_coco_train.yaml`` over
those labels.

Like the reference, the CLI first joins a process group where one is
configured (``parallel.distributed.maybe_initialize_distributed``): under
``torchrun --nproc_per_node=N -m spnerf_tpu_torch.cli ...`` each rank is
one process on card ``LOCAL_RANK`` (``--device cuda`` means that card),
joined by NCCL (gloo with ``--device cpu``). ``train`` is then data
parallel over the ranks; ``export_pseudo_labels`` with ``data.shard:
auto`` exports each rank's block of the images. The CLI waits for every
rank at the end of the task and leaves the group it joined. Without
``torchrun``'s variables nothing of this happens.
``--split`` also picks the split of ``export_NeRF_labels`` (the
reference exports the training split only), so that validation labels
can be written too.
"""

from __future__ import annotations

import argparse

import torch

from spnerf_tpu_torch.parallel import distributed
from spnerf_tpu_torch.utils.config import apply_overrides, load_config

TASKS = (
    "train",
    "export_pseudo_labels",
    "export_NeRF_labels",
    "export_HPatches_Repeatability",
    "export_HPatches_Descriptors",
)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--config-path", required=True)
    p.add_argument("--task", required=True, choices=TASKS)
    # training options (reference engine.py:14-27)
    p.add_argument("--validate-training", action="store_true", default=False)
    p.add_argument("--include-mask-loss", dest="include_mask_loss",
                   action="store_true", default=True)
    p.add_argument("--no-include-mask-loss", dest="include_mask_loss",
                   action="store_false")
    p.add_argument("--nerf-loss", action="store_true", default=False)
    p.add_argument("--train-nerf", action="store_true", default=False)
    # export options (reference engine.py:30-39)
    p.add_argument("--enable-homography-adaptation", dest="enable_ha",
                   action="store_true", default=True)
    p.add_argument("--no-enable-homography-adaptation", dest="enable_ha",
                   action="store_false")
    p.add_argument("--split", default="training",
                   choices=("training", "validation", "test"))
    p.add_argument("--seed", type=int, default=0)
    # dotted-key config overrides, reference tyro ergonomics (engine.py:14-43):
    #   --set train.learning_rate=1e-4 --set model.detector_head.nms=8
    p.add_argument("--set", dest="overrides", action="append", default=[],
                   metavar="KEY=VALUE",
                   help="override a config key by dotted path; value parsed "
                        "as YAML; repeatable")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="where the task runs (default: the card)")
    return p


def model_for_inference(config: dict, device):
    """The config's model drawn from seed 0, then restored from
    ``config["pretrained"]`` (partial merge by path and shape)."""
    from spnerf_tpu_torch.tasks.train_task import restore_pretrained
    from spnerf_tpu_torch.utils.factories import get_model

    model = get_model(config["model"], 0, device)
    restore_pretrained(config, model)
    return model.eval()


def main(argv=None):
    args = build_parser().parse_args(argv)
    started = (not distributed.is_initialized()
               and distributed.maybe_initialize_distributed(
                   device=args.device))
    try:
        out = run_task(args, distributed.rank_device(args.device))
        if started:  # the shards of an export end unevenly
            torch.distributed.barrier()
        return out
    finally:
        if started:
            torch.distributed.destroy_process_group()


def run_task(args, device):
    """The task of the parsed ``args`` on ``device``."""
    config = apply_overrides(load_config(args.config_path), args.overrides)

    if args.task == "train":
        from spnerf_tpu_torch.tasks.train_task import train

        return train(
            config,
            validate_training=args.validate_training,
            include_mask_loss=args.include_mask_loss,
            nerf_loss=args.nerf_loss,
            train_nerf=args.train_nerf,
            seed=args.seed,
            device=device,
        )

    from spnerf_tpu_torch.data.loader import DataLoader
    from spnerf_tpu_torch.device import resolve_device
    from spnerf_tpu_torch.utils.factories import get_dataset

    device = resolve_device(device)
    batch_size = config["data"].get("batch_size", 1)

    if args.task == "export_pseudo_labels":
        from spnerf_tpu_torch.tasks.export import export_pseudo_labels

        loader = DataLoader(get_dataset(config["data"], args.split),
                            batch_size=batch_size, shuffle=False,
                            drop_last=False)
        return export_pseudo_labels(
            config, model_for_inference(config, device), loader,
            split=args.split, enable_ha=args.enable_ha, seed=args.seed,
            device=device,
        )

    if args.task in ("export_HPatches_Repeatability",
                     "export_HPatches_Descriptors"):
        from spnerf_tpu_torch.data.hpatches import HPatches
        from spnerf_tpu_torch.tasks.export import export_hpatches

        loader = DataLoader(HPatches(config["data"]), batch_size=batch_size,
                            shuffle=False, drop_last=False)
        return export_hpatches(
            config, model_for_inference(config, device), loader,
            with_descriptors=(args.task == "export_HPatches_Descriptors"),
            device=device,
        )

    if args.task == "export_NeRF_labels":
        from spnerf_tpu_torch.tasks.export_nerf import export_nerf_labels

        return export_nerf_labels(config, model_for_inference(config, device),
                                  seed=args.seed, split=args.split,
                                  device=device)

    raise ValueError(f"Unhandled task {args.task}")


if __name__ == "__main__":
    main()
