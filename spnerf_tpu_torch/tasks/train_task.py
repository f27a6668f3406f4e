"""Config-driven training task (``spnerf_tpu/tasks/train_task.py``).

``train`` takes the reference's training config as a dict and any loader
of host batches {"image": (B, H, W, 1) float in [0, 1], "kpts": (B, N, 2),
"kpts_mask": (B, N)} (NeRF pairs add the second view, its depth and the
cameras: ``data.nerf_dataset.NeRFDataset``); the step does augmentation,
forwards, losses and the update on the device, the loop checkpoints
(optimizer state included), validates and logs. A seeded model where the
config names no ``pretrained`` checkpoint.

Under a process group (``parallel.distributed``) training is data
parallel, as the reference's mesh is: rank 0's model is replicated, each
rank loads and steps on its contiguous rows of every global batch, and
only rank 0 writes checkpoints, metrics and traces.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
from pathlib import Path

import numpy as np
import torch

from spnerf_tpu_torch import settings
from spnerf_tpu_torch.data.loader import DataLoader
from spnerf_tpu_torch.device import resolve_device
from spnerf_tpu_torch.geometry.homography import HomographyConfig
from spnerf_tpu_torch.models.superpoint import SuperPointConfig, init_superpoint
from spnerf_tpu_torch.ops.photometric_device import PhotometricDeviceConfig
from spnerf_tpu_torch.parallel.mesh import make_mesh, replicate, shard_batch
from spnerf_tpu_torch.tools.import_jax_weights import flax_checkpoint_to_torch
from spnerf_tpu_torch.train.loop import (
    StepConfig,
    StepGenerators,
    TrainState,
    create_train_state,
    eval_step,
    load_checkpoint,
    model_batch_stats,
    model_params,
    partial_restore,
    save_checkpoint,
    train_step,
)
from spnerf_tpu_torch.train.losses import DescriptorLossConfig
from spnerf_tpu_torch.utils.factories import get_loaders
from spnerf_tpu_torch.utils.logging import MetricWriter, NullWriter
from spnerf_tpu_torch.utils.profiling import StepTimer, trace_if


def build_step_config(config: dict, include_mask: bool,
                      nerf_desc: bool = False) -> StepConfig:
    data_cfg = config.get("data", {})
    aug_cfg = data_cfg.get("augmentation", {})
    model_cfg = config["model"]
    is_pair = model_cfg.get("model_name") != "magicpoint"

    aug = None
    erosion = 0
    if is_pair and aug_cfg.get("pair_homography"):
        pair = aug_cfg["pair_homography"]
        aug = HomographyConfig.from_dict(pair.get("params", {}))
        erosion = pair.get("valid_border_margin", 0)
    elif not is_pair and aug_cfg.get("homographic", {}).get("enable"):
        hom = aug_cfg["homographic"]
        aug = HomographyConfig.from_dict(hom.get("params", {}))
        erosion = hom.get("valid_border_margin", 0)

    pcfg = aug_cfg.get("photometric", {}) or {}
    photometric = (PhotometricDeviceConfig.from_dict(pcfg)
                   if pcfg.get("enable") and pcfg.get("on_device") else None)

    det_head = model_cfg.get("detector_head", {})
    return StepConfig(
        grid_size=det_head.get("grid_size", 8),
        include_mask=include_mask,
        desc_cfg=DescriptorLossConfig.from_dict(
            model_cfg.get("descriptor_head", {})),
        nerf_desc=nerf_desc,
        aug=aug,
        erosion=erosion,
        pair=is_pair,
        photometric=photometric,
        # the reference's key: its blockwise kernel is written in Pallas
        blockwise_desc=bool(config.get("train", {}).get("pallas_desc_loss",
                                                        False)),
        det_thresh=float(det_head.get("det_thresh", 0.015)),
    )


def restore_pretrained(config: dict, model) -> int:
    """The reference's partial checkpoint load: parameters and BatchNorm
    statistics of ``config["pretrained"]`` (under CKPT_PATH) go into
    ``model`` wherever path and shape match. Returns the iteration to
    continue from (0 unless ``continue_training``). The checkpoint may be
    the port's own or one the JAX package wrote."""
    pretrained = config.get("pretrained")
    if not pretrained:
        return 0
    data = load_checkpoint(Path(settings.CKPT_PATH, pretrained))
    if any(isinstance(v, dict) for v in data["params"].values()):
        data = flax_checkpoint_to_torch(data)  # nested: the flax tree
    partial_restore(model_params(model), data["params"])
    if "batch_stats" in data:
        partial_restore(model_batch_stats(model), data["batch_stats"])
    return int(data["iteration"]) if config.get("continue_training") else 0


def train(config: dict, loader=None, val_loader=None,
          validate_training: bool = False, include_mask_loss: bool = True,
          nerf_loss: bool = False, train_nerf: bool = False,
          seed: int = 0, device="cuda") -> TrainState:
    """The ``--task train`` entry point, on the card unless
    ``device="cpu"``. Trains ``config["model"]`` from weights drawn from
    ``seed`` (or ``config["pretrained"]``) for ``train.num_iters`` steps
    over ``loader`` (by default ``utils.factories.get_loaders`` of
    ``config``, built before the weights), cycling it; every
    ``save_or_validation_interval`` steps it validates on ``val_loader``
    (if ``validate_training``; at most ``train.val_batches`` batches when
    that is > 0) and writes a checkpoint. Metrics go to
    CKPT_PATH/<ckpt_name>/logs/metrics.jsonl and are read from the device
    only every ``log_every`` steps; ``perf/steps_per_sec`` per window of
    ``log_every`` steps (``utils.profiling.StepTimer``).

    ``nerf_loss``: NeRF pairs warp the descriptor cells by depth
    reprojection. ``train_nerf``: ``loader`` and ``val_loader`` are lists
    of per-scene loaders; the steps take a batch from each scene in turn
    and validation reads the first scene's loader.

    ``profile: {enable, logdir, start, num_steps}`` in the config traces
    steps ``start`` to ``start + num_steps - 1`` with ``torch.profiler``
    into ``logdir`` (default CKPT_PATH/<ckpt_name>/trace), a Chrome
    trace; outside that window a step does the same work.

    Under a process group the ranks train one model on the global batches
    of ``loader`` (each batch's size a multiple of the ranks): each rank
    takes its rows of every batch (a ``DataLoader`` loads only those),
    the step sums over the ranks (``train.loop.train_step``), validation
    runs on every rank on the whole of ``val_loader``, and rank 0 alone
    writes."""
    device = resolve_device(device)
    mesh = make_mesh()
    if loader is None:
        loaders = get_loaders(config, "train", nerf_train=train_nerf)
        loader, val_loader = loaders["train"], loaders["validation"]
    model = init_superpoint(seed, SuperPointConfig.from_dict(config["model"]),
                            device=device)
    iteration = restore_pretrained(config, model)
    replicate(model, mesh)
    state = create_train_state(model, config["train"]["learning_rate"])
    state.iteration = iteration

    step_cfg = build_step_config(config, include_mask_loss,
                                 nerf_desc=nerf_loss)
    gens = StepGenerators(seed, device)
    ckpt_name = config["ckpt_name"]
    lead = mesh.rank == 0
    writer = (MetricWriter(Path(settings.CKPT_PATH, ckpt_name, "logs"))
              if lead else NullWriter())
    num_iters = config["train"]["num_iters"]
    interval = config.get("save_or_validation_interval", 1000)
    log_every = int(config.get("log_every", 50))
    val_batches = int(config.get("train", {}).get("val_batches", 0))
    profile = config.get("profile", {}) or {}
    trace_start = int(profile.get("start", 10))
    trace_stop = trace_start + int(profile.get("num_steps", 20))
    trace_dir = profile.get("logdir",
                            str(Path(settings.CKPT_PATH, ckpt_name, "trace")))

    if train_nerf:
        streams = [iter_forever(rank_rows(scene, mesh)) for scene in loader]
        scenes = itertools.cycle(streams)
        get_batch = lambda: next(next(scenes))  # noqa: E731
        val_loader = val_loader[0] if val_loader else None
    else:
        streams = [iter_forever(rank_rows(loader, mesh))]
        get_batch = lambda: next(streams[0])  # noqa: E731
    batches = device_prefetch(get_batch, device)
    running = []
    it = state.iteration
    timer = StepTimer(window=log_every)
    trace = contextlib.ExitStack()
    try:
        while it < num_iters:
            if profile.get("enable") and lead:
                if it == trace_start:
                    trace.enter_context(trace_if(True, trace_dir))
                if it == trace_stop:
                    trace.close()
            metrics = train_step(state, next(batches), step_cfg, gens,
                                 mesh)
            it = state.iteration
            # metrics are read only now and then: a float() every step
            # would make the host wait for the device every step
            if it % log_every == 0 or it % interval == 0 or it >= num_iters:
                host_metrics = {k: float(v) for k, v in metrics.items()}
                running.append(host_metrics["loss"])
                writer.scalars(host_metrics, it, prefix="iter_loss/")
            sps = timer.tick()
            if sps is not None:
                writer.scalar("perf/steps_per_sec", sps, it)

            if it % interval == 0 or it >= num_iters:
                if running:
                    writer.scalar("running_loss/train",
                                  float(np.mean(running)), it)
                running = []
                if validate_training and val_loader is not None:
                    val_iter = iter(val_loader)
                    if val_batches > 0:
                        val_iter = itertools.islice(val_iter, val_batches)
                    vals = collections.defaultdict(list)
                    for i, vb in enumerate(val_iter):
                        m = eval_step(state, _to_device(vb, device),
                                      step_cfg, gens, index=i)
                        for k, v in m.items():
                            vals[k].append(float(v))
                    writer.scalars({k: float(np.mean(v))
                                    for k, v in vals.items()}, it,
                                   prefix="val/")
                if lead:
                    save_checkpoint(ckpt_name, state, it)
                writer.flush()
                timer.restart()
    finally:
        trace.close()
        batches.close()
        for stream in streams:
            stream.close()
        writer.close()
    return state


def iter_forever(loader):
    """``loader``'s batches, pass after pass. A pass that yields nothing
    raises (a dataset smaller than its batch, with ``drop_last``), where
    the reference's loop would spin without end."""
    while True:
        empty = True
        for batch in loader:
            empty = False
            yield batch
        if empty:
            raise ValueError("the training loader yields no batch (fewer "
                             "samples than a batch, the partial batch "
                             "dropped)")


class _RankRows:
    """An iterable of this rank's rows of each batch of ``loader``."""

    def __init__(self, loader, mesh):
        self.loader, self.mesh = loader, mesh

    def __iter__(self):
        for batch in self.loader:
            yield shard_batch(batch, self.mesh)


def rank_rows(loader, mesh):
    """``loader`` as this rank of ``mesh`` takes it: its rows of every
    batch; a ``DataLoader`` is cut before it loads, so that a rank reads
    and decodes its own samples only."""
    if mesh.size == 1:
        return loader
    if isinstance(loader, DataLoader):
        return loader.shard(mesh.rank, mesh.size)
    return _RankRows(loader, mesh)


def device_prefetch(get_batch, device, depth: int = 2):
    """Generator of device batches, ``depth`` of them in flight: each host
    batch is pinned and copied without blocking on a side stream, with an
    event recorded behind it, and the consumer's stream waits on that
    event only when it takes the batch, so the copies of the next batches
    overlap the step that runs. On the CPU the batches pass through."""
    device = torch.device(device)
    if device.type != "cuda":
        while True:
            yield _to_device(get_batch(), device)
    side = torch.cuda.Stream(device)
    queue = collections.deque()
    while True:
        while len(queue) < depth:
            with torch.cuda.stream(side):
                batch = _to_device(get_batch(), device, pin=True)
                done = torch.cuda.Event()
                done.record(side)
            queue.append((batch, done))
        batch, done = queue.popleft()
        current = torch.cuda.current_stream(device)
        current.wait_event(done)
        for t in batch.values():
            t.record_stream(current)  # allocated on the side stream
        yield batch


def _to_device(batch: dict, device, pin: bool = False) -> dict:
    """Host batch -> tensors on ``device``; fields that never go to the
    device (names and other string arrays) are dropped."""
    out = {}
    for k, v in batch.items():
        if isinstance(v, (str, bytes, list)):
            continue
        if isinstance(v, np.ndarray) and v.dtype.kind in "USO":
            continue
        t = torch.as_tensor(v)
        if pin:
            t = t.pin_memory()
        out[k] = t.to(device, non_blocking=pin)
    return out
