"""NeRF scene training and novel-view dataset rendering
(``spnerf_tpu/tasks/nerf_task.py``).

Train an in-framework NeRF on posed images, then render novel views with
along-ray depth and camera poses into the directory layout the NeRF
dataset reads:

    DATA_PATH/NeRF/<scene>/{images,camera_transforms,depth}/<split>/

Training keeps the whole ray pool on the device; each step draws its ray
indices there (``randint`` from a device generator), renders, and takes
Adam as ``optax.adam`` runs it. Losses stay on the device and are read
only at the ``log_every`` boundaries, so no step waits on the host.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from spnerf_tpu_torch import settings
from spnerf_tpu_torch.data.png import write_gray
from spnerf_tpu_torch.device import resolve_device
from spnerf_tpu_torch.models.nerf import (
    NeRF,
    NeRFConfig,
    camera_rays,
    init_nerf,
    render_image,
    render_rays,
)


def create_nerf_optimizer(model: NeRF, learning_rate: float):
    """Adam as ``optax.adam(learning_rate)`` runs it: betas 0.9 / 0.999,
    eps 1e-8 outside the root, no weight decay."""
    return torch.optim.Adam(model.parameters(), lr=learning_rate,
                            betas=(0.9, 0.999), eps=1e-8, weight_decay=0.0)


def nerf_train_step(model: NeRF, optimizer, origins, dirs, target_rgb,
                    config: NeRFConfig,
                    generator: torch.Generator | None = None,
                    draws=None) -> dict:
    """One photometric MSE step over a ray batch (coarse + fine), in
    place. Returns {"loss", "coarse", "fine"} as tensors on the device."""
    optimizer.zero_grad(set_to_none=True)
    out = render_rays(model, origins, dirs, config, generator=generator,
                      draws=draws)
    loss_c = torch.mean((out["rgb_coarse"] - target_rgb) ** 2)
    loss_f = torch.mean((out["rgb"] - target_rgb) ** 2)
    loss = loss_c + loss_f
    loss.backward()
    optimizer.step()
    return {"loss": loss.detach(), "coarse": loss_c.detach(),
            "fine": loss_f.detach()}


def scene_rays(images: np.ndarray, cam_to_worlds: np.ndarray,
               intrinsics: np.ndarray, device):
    """Every pixel's ray and colour of a posed image set, on ``device``:
    (origins, directions, rgb), each (N * H * W, 3) float32."""
    N, H, W, _ = images.shape
    K = torch.as_tensor(intrinsics, device=device)
    origins, dirs = [], []
    for i in range(N):
        o, d = camera_rays((H, W), K,
                           torch.as_tensor(cam_to_worlds[i], device=device))
        origins.append(o)
        dirs.append(d)
    rgb = torch.as_tensor(np.asarray(images, np.float32), device=device)
    return torch.cat(origins), torch.cat(dirs), rgb.reshape(-1, 3)


def nerf_train_steps(model: NeRF, optimizer, pool, config: NeRFConfig,
                     ray_batch: int, n_steps: int,
                     generator: torch.Generator) -> torch.Tensor:
    """``n_steps`` steps on ray batches drawn on the device from the
    resident pool (origins, directions, rgb). Returns the (n_steps,)
    losses, on the device."""
    all_o, all_d, all_rgb = pool
    losses = torch.empty(n_steps, device=all_o.device)
    for i in range(n_steps):
        idx = torch.randint(0, all_o.shape[0], (ray_batch,),
                            generator=generator, device=all_o.device)
        out = nerf_train_step(model, optimizer, all_o[idx], all_d[idx],
                              all_rgb[idx], config, generator=generator)
        losses[i] = out["loss"]
    return losses


def train_nerf_scene(
    images: np.ndarray,  # (N, H, W, 3) in [0, 1]
    cam_to_worlds: np.ndarray,  # (N, 4, 4) OpenCV convention
    intrinsics: np.ndarray,  # (3, 3)
    config: NeRFConfig = NeRFConfig(),
    num_iters: int = 20000,
    ray_batch: int = 1024,
    learning_rate: float = 5e-4,
    seed: int = 0,
    log_every: int = 500,
    device="cuda",
):
    """Train a hierarchical NeRF on a posed image set, on the card unless
    ``device="cpu"``. Returns (model, history): ``history`` holds the loss
    of the last step of every chunk of min(log_every, 100) steps that ends
    on a multiple of ``log_every``, and of the last step (the reference's
    boundaries). The field starts as ``init_nerf(seed)``; ray indices and
    samples draw from a device generator seeded ``seed + 1``."""
    device = resolve_device(device)
    model = init_nerf(seed, config, device)
    optimizer = create_nerf_optimizer(model, learning_rate)
    pool = scene_rays(images, cam_to_worlds, intrinsics, device)
    generator = torch.Generator(device=device).manual_seed(seed + 1)
    history = []
    chunk = min(log_every, 100)
    it = 0
    while it < num_iters:
        n_steps = min(chunk, num_iters - it)
        losses = nerf_train_steps(model, optimizer, pool, config, ray_batch,
                                  n_steps, generator)
        if (it + n_steps) % log_every == 0 or it + n_steps == num_iters:
            history.append(float(losses[-1]))
        it += n_steps
    return model, history


def pose_orbit(n_frames: int, radius: float = 4.0, height: float = 0.5,
               look_at=(0.0, 0.0, 0.0)) -> np.ndarray:
    """Simple orbit of OpenCV-convention cam-to-world poses for novel-view
    rendering around a scene center."""
    poses = []
    center = np.asarray(look_at, np.float64)
    for i in range(n_frames):
        theta = 2 * np.pi * i / n_frames
        eye = np.array([radius * np.cos(theta), height, radius * np.sin(theta)])
        forward = center - eye
        forward = forward / np.linalg.norm(forward)
        tmp_up = np.array([0.0, -1.0, 0.0])  # OpenCV: y down
        right = np.cross(tmp_up, forward)
        right /= np.linalg.norm(right)
        down = np.cross(forward, right)
        T = np.eye(4)
        T[:3, 0] = right
        T[:3, 1] = down
        T[:3, 2] = forward
        T[:3, 3] = eye
        poses.append(T)
    return np.stack(poses).astype(np.float32)


_FLIP = np.diag([1.0, -1.0, -1.0, 1.0]).astype(np.float32)


def _scene_dirs(scene_name: str, splits: dict) -> Path:
    root = Path(settings.DATA_PATH, "NeRF", scene_name)
    for split in splits:
        for sub in ("images", "camera_transforms", "depth"):
            (root / sub / split).mkdir(parents=True, exist_ok=True)
    return root


def _write_frame(root: Path, split: str, j: int, rgb: np.ndarray,
                 depth: np.ndarray, pose: np.ndarray) -> None:
    """One view: ``images/<split>/<j>.png`` (8-bit gray, the mean of
    ``rgb``'s channels times 255, clipped), ``camera_transforms/<split>/
    <j>.npy`` (pose @ diag(1, -1, -1, 1), NerfStudio's axes; the dataset
    flips it back) and ``depth/<split>/<j>.npy``."""
    gray = np.clip(np.asarray(rgb).mean(-1) * 255.0, 0, 255).astype(np.uint8)
    write_gray(root / "images" / split / f"{j}.png", gray)
    np.save(root / "camera_transforms" / split / f"{j}.npy", pose @ _FLIP)
    np.save(root / "depth" / split / f"{j}.npy", depth)


def write_scene(scene_name: str, rgb: np.ndarray, depth: np.ndarray,
                poses: np.ndarray, splits: dict | None = None) -> Path:
    """Write views into the NeRF dataset layout under
    DATA_PATH/NeRF/<scene_name> (see ``_write_frame``).

    rgb (N, H, W, C) in [0, 1]; depth (N, H, W) along-ray; poses (N, 4, 4)
    OpenCV-convention cam-to-world; splits {split: [frame index, ...]},
    default every frame in "training"."""
    splits = splits or {"training": list(range(len(poses)))}
    root = _scene_dirs(scene_name, splits)
    for split, indices in splits.items():
        for j, idx in enumerate(indices):
            _write_frame(root, split, j, rgb[idx], depth[idx], poses[idx])
    return root


def render_dataset(
    model: NeRF,
    scene_name: str,
    poses: np.ndarray,  # (N, 4, 4) OpenCV-convention cam-to-world
    shape: tuple[int, int],
    intrinsics: np.ndarray,
    config: NeRFConfig = NeRFConfig(),
    splits: dict | None = None,  # {"training": [idx...], ...}
    seed: int = 0,
    chunk: int = 4096,
    draws=None,
    device="cuda",
) -> Path:
    """Render novel views with along-ray depth and their poses into the
    NeRF dataset layout (as ``write_scene``), on the card unless
    ``device="cpu"``. Views render in split order; their samples draw from
    a device generator seeded ``seed``, or ``draws`` holds each view's
    per-chunk draws (``render_image``'s), in that order."""
    device = resolve_device(device)
    splits = splits or {"training": list(range(len(poses)))}
    root = _scene_dirs(scene_name, splits)
    generator = torch.Generator(device=device).manual_seed(seed)
    frame = 0
    for split, indices in splits.items():
        for j, idx in enumerate(indices):
            out = render_image(model, shape, intrinsics, poses[idx], config,
                               chunk=chunk, generator=generator,
                               draws=None if draws is None else draws[frame],
                               device=device)
            _write_frame(root, split, j, out["rgb"].cpu().numpy(),
                         out["depth"].cpu().numpy(), poses[idx])
            frame += 1
    return root
