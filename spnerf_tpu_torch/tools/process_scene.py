"""Scene preprocessing: video / images -> posed frames -> NeRF scene
(``spnerf_tpu/tools/process_scene.py``).

- frame extraction shells out to ffmpeg when available;
- camera poses come from COLMAP when installed, or from a
  NerfStudio-style ``transforms.json`` if one already exists;
- the NeRF is trained and novel views with depth are rendered by
  ``tasks/nerf_task.py``, on the card unless ``--device cpu``: the output
  is the ``DATA_PATH/NeRF/<scene>/{images,camera_transforms,depth}``
  layout the NeRF dataset reads.

Frames are read as ``cv2.imread`` reads them (``data/imread.read_rgb``:
any format the port decodes, by signature) and resized as ``cv2.resize`` does
(``data/resize.resize_linear``).

    python -m spnerf_tpu_torch.tools.process_scene --data-path scene_dir \\
        [--input-type images|video] [--train-iters 20000] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import shutil
import subprocess
from pathlib import Path

import numpy as np
import torch

from spnerf_tpu_torch.data.nerf_dataset import camera_intrinsics
from spnerf_tpu_torch.data.imread import read_rgb
from spnerf_tpu_torch.data.resize import resize_linear
from spnerf_tpu_torch.geometry.reprojection import nerfstudio_to_cv
from spnerf_tpu_torch.models.nerf import NeRFConfig
from spnerf_tpu_torch.tasks.nerf_task import (
    pose_orbit,
    render_dataset,
    train_nerf_scene,
)

PRESETS = {
    "full": NeRFConfig(),
    "light": NeRFConfig(depth=4, width=128, n_coarse=32, n_fine=32),
    "tiny": NeRFConfig(depth=2, width=64, n_coarse=12, n_fine=12),
}


def extract_frames(video: Path, out_dir: Path, fps: int = 2) -> list[Path]:
    """Video -> frames via ffmpeg."""
    out_dir.mkdir(parents=True, exist_ok=True)
    if shutil.which("ffmpeg") is None:
        raise RuntimeError("ffmpeg not found on PATH")
    subprocess.run(
        ["ffmpeg", "-y", "-i", str(video), "-vf", f"fps={fps}",
         str(out_dir / "frame_%05d.png")],
        check=True, capture_output=True,
    )
    return sorted(out_dir.glob("frame_*.png"))


def run_colmap(image_dir: Path, work_dir: Path) -> Path:
    """SfM poses via COLMAP when installed."""
    if shutil.which("colmap") is None:
        raise RuntimeError(
            "colmap not found on PATH; provide a transforms.json instead"
        )
    work_dir.mkdir(parents=True, exist_ok=True)
    db = work_dir / "database.db"
    sparse = work_dir / "sparse"
    sparse.mkdir(exist_ok=True)
    for cmd in (
        ["colmap", "feature_extractor", "--database_path", str(db),
         "--image_path", str(image_dir)],
        ["colmap", "exhaustive_matcher", "--database_path", str(db)],
        ["colmap", "mapper", "--database_path", str(db),
         "--image_path", str(image_dir), "--output_path", str(sparse)],
    ):
        subprocess.run(cmd, check=True, capture_output=True)
    return sparse


def load_transforms_json(path: Path):
    """NerfStudio-style transforms.json -> (image paths, c2w (N,4,4), fov)."""
    meta = json.loads(path.read_text())
    frames = sorted(meta["frames"], key=lambda f: f["file_path"])
    images = [path.parent / f["file_path"] for f in frames]
    poses = np.stack([np.asarray(f["transform_matrix"], np.float32)
                      for f in frames])
    if "camera_angle_x" in meta:
        fov = float(np.rad2deg(meta["camera_angle_x"]))
    else:
        fov = 2 * np.rad2deg(np.arctan(meta["h"] / (2 * meta["fl_y"])))
    return images, poses, fov


def load_frames(paths, shape) -> np.ndarray:
    """(N, H, W, 3) float32 RGB in [0, 1]: each image (PNG, PGM / PPM or
    JPEG) resized to ``shape`` (H, W)."""
    H, W = shape
    return np.stack([(resize_linear(read_rgb(p), (W, H)) / 255.0).astype(
        np.float32) for p in paths])


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--data-path", required=True,
                   help="scene directory (images/, video file, or "
                        "transforms.json inside)")
    p.add_argument("--input-type", choices=("images", "video"),
                   default="images")
    p.add_argument("--scene-name", default=None)
    p.add_argument("--fps", type=int, default=2)
    p.add_argument("--train-iters", type=int, default=20000)
    p.add_argument("--nerf-preset", choices=tuple(PRESETS), default="full",
                   help="field size: full=8x256 (quality), light=4x128, "
                        "tiny=2x64 (smoke tests)")
    p.add_argument("--render-size", type=int, nargs=2, default=(480, 640))
    p.add_argument("--n-novel-views", type=int, default=120)
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu")
    args = p.parse_args(argv)

    scene_dir = Path(args.data_path)
    scene_name = args.scene_name or scene_dir.stem

    if args.input_type == "video":
        videos = sorted(scene_dir.glob("*.mp4")) + sorted(scene_dir.glob("*.mov"))
        if not videos:
            raise SystemExit(f"no video found in {scene_dir}")
        extract_frames(videos[0], scene_dir / "images", args.fps)

    tj = scene_dir / "transforms.json"
    if not tj.exists():
        run_colmap(scene_dir / "images", scene_dir / "colmap")
        raise SystemExit(
            "COLMAP sparse model written; convert it to transforms.json "
            "(e.g. with any COLMAP->NerfStudio converter) and rerun."
        )

    images, poses, fov = load_transforms_json(tj)
    H, W = args.render_size
    imgs = load_frames(images, (H, W))
    poses_cv = nerfstudio_to_cv(torch.from_numpy(poses)).numpy()
    K = camera_intrinsics((H, W), fov)
    config = PRESETS[args.nerf_preset]
    model, history = train_nerf_scene(
        imgs, poses_cv, K, config, num_iters=args.train_iters,
        device=args.device,
    )
    print(f"NeRF trained; final loss {history[-1] if history else float('nan'):.5f}")

    novel = pose_orbit(args.n_novel_views)
    n = args.n_novel_views
    splits = {
        "training": list(range(0, int(0.8 * n))),
        "validation": list(range(int(0.8 * n), int(0.9 * n))),
        "test": list(range(int(0.9 * n), n)),
    }
    root = render_dataset(model, scene_name, novel, (H, W), K, config, splits,
                          device=args.device)
    print(f"NeRF scene rendered to {root}")
    return root


if __name__ == "__main__":
    main()
