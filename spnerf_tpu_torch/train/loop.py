"""Training steps, Adam and checkpoints (``spnerf_tpu/train/loop.py``).

One step is augmentation on the device + both forwards + losses +
backward + Adam + the BatchNorm running statistics. The reference jits
that as one program with its state donated; here it runs eagerly, with
``zero_grad(set_to_none=True)`` and in-place Adam in place of donation,
and never waits on the host inside a step: metrics come back as tensors
on the device.

Randomness. torch cannot reproduce ``jax.random``; every step draws from
two explicit generators (``StepGenerators``), reseeded from (seed, kind,
iteration) at the start of the step, so that a step's draws depend on
its iteration alone (the reference folds the iteration into its key) and
a resumed run repeats them. Order within a training step:

1. photometric augmentation (``ops.photometric_device
   .draw_photometric_randoms``): for a pair step the raw view's draws,
   then the warped view's source (for a NeRF pair: the second view
   itself); small per-sample draws from the CPU generator, the two
   full-image noise fields from the device generator;
2. the homographies (``geometry.homography.draw_homography_randoms``),
   from the CPU generator (none for a NeRF pair: its warp is the depth
   reprojection of ``train.pipeline.prepare_nerf_batch``);
3. the detector losses' tie-break noise from the device generator: the
   raw view's, then the warped view's.

A validation step draws 2 and 3 only. In a data-parallel step each draw
is made for the global batch and cut to the rank's rows
(``parallel.mesh.global_rows``).
"""

from __future__ import annotations

import dataclasses
import hashlib
import io
from pathlib import Path

import torch

from spnerf_tpu_torch import settings
from spnerf_tpu_torch.geometry.homography import (
    HomographyConfig,
    sample_homographies,
    warp_points,
)
from spnerf_tpu_torch.geometry.reprojection import warp_points_nerf
from spnerf_tpu_torch.kernels.descriptor_loss import descriptor_loss_blockwise
from spnerf_tpu_torch.models.superpoint import SuperPoint
from spnerf_tpu_torch.ops.detector_decode import decode_detector_logits
from spnerf_tpu_torch.ops.photometric_device import (
    PhotometricDeviceConfig,
    photometric_augment,
)
from spnerf_tpu_torch.parallel.mesh import (
    Mesh,
    data_parallel,
    global_rows,
    sum_gradients,
    sum_metrics,
)
from spnerf_tpu_torch.train import flax_msgpack
from spnerf_tpu_torch.train.losses import (
    DescriptorLossConfig,
    cell_grid_coords,
    descriptor_loss,
    descriptor_loss_nerf,
    descriptor_loss_normalised_blockwise,
    detector_loss,
    detector_noise,
)
from spnerf_tpu_torch.train.metrics import precision_recall
from spnerf_tpu_torch.train.pipeline import (
    prepare_detector_batch,
    prepare_nerf_batch,
    prepare_superpoint_batch,
)


@dataclasses.dataclass
class TrainState:
    """Model (parameters and BatchNorm statistics), optimizer and the
    number of steps taken. The steps update it in place."""

    model: SuperPoint
    optimizer: torch.optim.Adam
    iteration: int = 0


def create_train_state(model: SuperPoint, learning_rate: float) -> TrainState:
    """Adam as ``optax.adam(learning_rate)`` runs it: betas 0.9 / 0.999,
    eps 1e-8 outside the root, no weight decay."""
    optimizer = torch.optim.Adam(model.parameters(), lr=learning_rate,
                                 betas=(0.9, 0.999), eps=1e-8,
                                 weight_decay=0.0)
    return TrainState(model=model, optimizer=optimizer, iteration=0)


class StepGenerators:
    """The two generators a step draws from: ``cpu`` for the small
    per-sample draws, ``device`` for full-image fields on the model's
    device."""

    def __init__(self, seed: int, device):
        self.seed = int(seed)
        self.cpu = torch.Generator()
        self.device = torch.Generator(device=torch.device(device))

    def reseed(self, *key: int) -> None:
        """Seed both generators from (seed, *key)."""
        digest = hashlib.blake2b(repr((self.seed,) + key).encode(),
                                 digest_size=8).digest()
        value = int.from_bytes(digest, "little") >> 1
        self.cpu.manual_seed(value)
        self.device.manual_seed(value)


# --------------------------------------------------------------------- steps


def magicpoint_loss_fn(model: SuperPoint, data: dict, noise: torch.Tensor,
                       grid_size: int, include_mask: bool,
                       train: bool = True):
    """Detector loss of one forward; ``train`` runs BatchNorm on the batch
    and updates its running statistics."""
    model.train(train)
    out = model(data["image"])
    loss = detector_loss(noise, out["logits"], data["kpts_heatmap"],
                         data["valid_mask"] if include_mask else None,
                         grid_size)
    return loss, {"detector_loss": loss}


def superpoint_loss_fn(model: SuperPoint, data: dict, noise,
                       grid_size: int, include_mask: bool,
                       desc_cfg: DescriptorLossConfig,
                       nerf_desc: bool = False, train: bool = True,
                       blockwise_desc: bool = False):
    """Both detector losses and the descriptor loss of a warped pair.
    ``noise`` is the pair (raw, warped) of tie-break noise tensors. The
    raw view goes through the model first, then the warped one, and each
    training forward updates the running statistics. ``nerf_desc`` warps
    the cells by the depth reprojection (else by the pair's homography);
    ``blockwise_desc`` takes the blockwise loss (the CUDA kernels, or the
    checkpointed passes with ``normalise_descriptors``), else the dense
    volume."""
    model.train(train)
    out = model(data["raw"]["image"])
    warped_out = model(data["warp"]["image"])

    det = detector_loss(
        noise[0], out["logits"], data["raw"]["kpts_heatmap"],
        data["raw"]["valid_mask"] if include_mask else None, grid_size)
    det_warped = detector_loss(
        noise[1], warped_out["logits"], data["warp"]["kpts_heatmap"],
        data["warp"]["valid_mask"] if include_mask else None, grid_size)
    wmask = data["warp"]["valid_mask"] if include_mask else None
    if blockwise_desc:
        _, Hc, Wc, _ = out["desc_raw"].shape
        cells = cell_grid_coords(Hc, Wc, desc_cfg.grid_size,
                                 device=out["desc_raw"].device)
        if nerf_desc:
            warped_cells = warp_points_nerf(
                cells, data["raw"]["depth"], data["intrinsics"],
                data["raw"]["rotation"], data["raw"]["translation"],
                data["warp"]["rotation"], data["warp"]["translation"])
        else:
            warped_cells = warp_points(cells, data["homography"])
        if desc_cfg.normalise_descriptors:
            # the volume's global row and column norms do not fit the
            # streaming kernel
            desc, pos, neg = descriptor_loss_normalised_blockwise(
                out["desc_raw"], warped_out["desc_raw"], warped_cells,
                desc_cfg, wmask)
        else:
            desc, pos, neg = descriptor_loss_blockwise(
                out["desc_raw"], warped_out["desc_raw"], warped_cells,
                desc_cfg, wmask)
    elif nerf_desc:
        desc, pos, neg = descriptor_loss_nerf(
            out["desc_raw"], warped_out["desc_raw"], data["raw"]["depth"],
            data["intrinsics"], data["raw"]["rotation"],
            data["raw"]["translation"], data["warp"]["rotation"],
            data["warp"]["translation"], desc_cfg, wmask)
    else:
        desc, pos, neg = descriptor_loss(
            out["desc_raw"], warped_out["desc_raw"], data["homography"],
            desc_cfg, wmask)
    loss = det + det_warped + desc
    metrics = {
        "detector_loss": det,
        "warped_detector_loss": det_warped,
        "descriptor_loss": desc,
        "positive_dist": pos,
        "negative_dist": neg,
        "loss": loss,
    }
    return loss, metrics


@dataclasses.dataclass(frozen=True)
class StepConfig:
    """What a step does besides its batch and state."""

    grid_size: int = 8
    include_mask: bool = True
    desc_cfg: DescriptorLossConfig = DescriptorLossConfig()
    nerf_desc: bool = False
    # homographic augmentation on the device (None: none)
    aug: HomographyConfig | None = None
    erosion: int = 0
    pair: bool = False  # SuperPoint warped-pair mode
    # photometric augmentation on the device, training steps only
    photometric: PhotometricDeviceConfig | None = None
    # blockwise descriptor loss: the CUDA kernels (normalise False) or the
    # checkpointed row-tile passes (normalise True); False: the dense path
    blockwise_desc: bool = False
    # detection threshold of validation precision and recall
    det_thresh: float = 0.015


def _float32_convs():
    """cuDNN's convolutions in float32 (its default takes TF32)."""
    return torch.backends.cudnn.flags(enabled=True, allow_tf32=False)


def _noise(gens: StepGenerators, image: torch.Tensor, grid_size: int,
           mesh: Mesh | None = None):
    """Tie-break noise for ``image``: with a ``mesh``, drawn for the
    global batch and cut to this rank's rows."""
    B, H, W, _ = image.shape
    n, rows = global_rows(B, mesh)
    return detector_noise(gens.device, (n, H // grid_size, W // grid_size,
                                        grid_size ** 2 + 1))[rows]


def _prepare(batch: dict, cfg: StepConfig, gens: StepGenerators,
             mesh: Mesh | None = None) -> dict:
    """The step's data from a device batch: heatmaps, and the homographic
    augmentation or warped pair where the batch has keypoints (with a
    ``mesh``, homographies drawn for the global batch, cut to this rank's
    rows)."""
    if cfg.nerf_desc and "depth" in batch:
        return prepare_nerf_batch(batch)
    if "kpts" not in batch:
        return batch
    B, H, W, _ = batch["image"].shape
    homs = None
    if cfg.aug is not None:
        n, rows = global_rows(B, mesh)
        homs = sample_homographies(gens.cpu, n, (H, W), cfg.aug)[rows]
    if not cfg.pair:
        return prepare_detector_batch(homs, batch, cfg.erosion)
    if homs is None:
        return batch
    return prepare_superpoint_batch(homs, batch, cfg.erosion)


def _step_noise(data: dict, cfg: StepConfig, gens: StepGenerators,
                mesh: Mesh | None = None):
    """The detector losses' tie-break noise of a prepared batch: the
    (raw, warped) pair for a pair step, else one tensor."""
    if cfg.pair:
        return (_noise(gens, data["raw"]["image"], cfg.grid_size, mesh),
                _noise(gens, data["warp"]["image"], cfg.grid_size, mesh))
    return _noise(gens, data["image"], cfg.grid_size, mesh)


def _losses(state: TrainState, data: dict, cfg: StepConfig, noise,
            train: bool):
    if cfg.pair:
        return superpoint_loss_fn(
            state.model, data, noise, cfg.grid_size, cfg.include_mask,
            cfg.desc_cfg, cfg.nerf_desc, train, cfg.blockwise_desc)
    return magicpoint_loss_fn(state.model, data, noise, cfg.grid_size,
                              cfg.include_mask, train)


def train_step(state: TrainState, batch: dict, cfg: StepConfig,
               gens: StepGenerators, mesh: Mesh | None = None) -> dict:
    """One optimizer step on a device batch {"image", "kpts",
    "kpts_mask"}; updates ``state`` in place and returns the metrics as
    tensors on the device (no host synchronisation). Convolutions run in
    float32 (cuDNN's TF32 off), the augmentation's too.

    With a ``mesh`` (``parallel.mesh.make_mesh``) the batch is this rank's
    contiguous rows of the global batch: every draw is made for the global
    batch and cut to those rows, so that a rank sees exactly the rows a
    single-process step sees, and ``apply_step`` sums over the ranks."""
    gens.reseed(0, state.iteration)
    with torch.no_grad(), _float32_convs():
        if cfg.photometric is not None:
            batch = dict(batch)
            base = batch["image"]
            augment = lambda images: photometric_augment(  # noqa: E731
                gens.cpu, images, cfg.photometric, gens.device, mesh)
            batch["image"] = augment(base)
            if cfg.nerf_desc and "depth" in batch:
                # a NeRF pair is two real views: independent draws on each
                batch["image_warp"] = augment(batch["image_warp"])
            elif cfg.pair:
                # the to-be-warped view: independent draws on the same
                # base image
                batch["image_warp_src"] = augment(base)
        data = _prepare(batch, cfg, gens, mesh)
    return apply_step(state, data, _step_noise(data, cfg, gens, mesh), cfg,
                      mesh)


def apply_step(state: TrainState, data: dict, noise, cfg: StepConfig,
               mesh: Mesh | None = None) -> dict:
    """The losses of a prepared batch, the backward and Adam; with a
    ``mesh``, BatchNorm and the losses' normalisers take the global batch,
    and the gradients (before Adam) and the metrics are summed over the
    ranks."""
    state.optimizer.zero_grad(set_to_none=True)
    with data_parallel(mesh), _float32_convs():
        loss, metrics = _losses(state, data, cfg, noise, train=True)
        loss.backward()
    sum_gradients(state.model.parameters(), mesh)
    state.optimizer.step()
    state.iteration += 1
    metrics = {k: v.detach() for k, v in metrics.items()}
    metrics["loss"] = loss.detach()
    return sum_metrics(metrics, mesh)


@torch.no_grad()
def eval_step(state: TrainState, batch: dict, cfg: StepConfig,
              gens: StepGenerators, index: int = 0) -> dict:
    """Validation on one batch: the losses with running statistics, and
    precision / recall of the thresholded heatmap. ``index`` numbers the
    batch within its validation pass (it seeds the draws)."""
    gens.reseed(1, state.iteration, index)
    with _float32_convs():
        data = _prepare(batch, cfg, gens)
        noise = _step_noise(data, cfg, gens)
        loss, metrics = _losses(state, data, cfg, noise, train=False)
        view = data["raw"] if cfg.pair else data
        out = state.model(view["image"])
    prob = decode_detector_logits(out["logits"], cfg.grid_size)
    pred = (prob >= cfg.det_thresh).to(torch.int32)
    precision, recall = precision_recall(pred, view["kpts_heatmap"])
    metrics = dict(metrics)
    metrics.update({"val_loss": loss, "precision": precision,
                    "recall": recall})
    return metrics


# --------------------------------------------------------------- checkpoints


def model_params(model: SuperPoint) -> dict:
    """{path: parameter} of the model, torch paths
    (``backbone.block1.Conv_0.weight``)."""
    return dict(model.named_parameters())


def model_batch_stats(model: SuperPoint) -> dict:
    """{path: buffer} of the BatchNorm running means and variances."""
    return {k: v for k, v in model.named_buffers()
            if k.endswith(("running_mean", "running_var"))}


def checkpoint_payload(state: TrainState) -> dict:
    """{iteration, params, batch_stats, opt_state} of ``state``, tensors
    on the CPU: what a checkpoint file holds."""
    cpu = lambda tree: {k: v.detach().cpu() for k, v in tree.items()}  # noqa: E731
    opt = state.optimizer.state_dict()
    opt["state"] = {i: {k: v.cpu() if torch.is_tensor(v) else v
                        for k, v in s.items()}
                    for i, s in opt["state"].items()}
    return {
        "iteration": int(state.iteration),
        "params": cpu(model_params(state.model)),
        "batch_stats": cpu(model_batch_stats(state.model)),
        "opt_state": opt,
    }


def save_checkpoint(ckpt_name: str, state: TrainState,
                    step: int | None = None) -> Path:
    """``torch.save`` the ``checkpoint_payload`` of ``state`` to
    CKPT_PATH/<ckpt_name>/<ckpt_name>_<step>.ckpt."""
    step = state.iteration if step is None else step
    path = Path(settings.CKPT_PATH, ckpt_name)
    path.mkdir(parents=True, exist_ok=True)
    out = path / f"{ckpt_name}_{step}.ckpt"
    torch.save(checkpoint_payload(state), out)
    return out


@torch.no_grad()
def partial_restore(target: dict, saved: dict) -> list:
    """Copy saved tensors into the target's wherever path AND shape
    match: the partial merge by which MagicPoint weights seed a SuperPoint
    model. Returns the restored paths."""
    restored = []
    for path, value in target.items():
        s = saved.get(path)
        if s is not None and tuple(s.shape) == tuple(value.shape):
            value.copy_(s)
            restored.append(path)
    return restored


def load_checkpoint(path: str | Path) -> dict:
    """The payload ``save_checkpoint`` wrote, tensors on the CPU; or, for
    a checkpoint the JAX package wrote (a flax msgpack map, told apart by
    its first byte), the flax tree as numpy arrays
    (``tools.import_jax_weights.flax_checkpoint_to_torch`` maps it)."""
    data = Path(path).read_bytes()
    if flax_msgpack.is_msgpack_map(data[:1]):
        return flax_msgpack.msgpack_restore(data)
    return torch.load(io.BytesIO(data), map_location="cpu", weights_only=True)
