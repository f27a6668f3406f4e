"""Fabricated 3-D multi-view scenes for the demo's NeRF leg
(``demo/make_nerf_scenes.py``): textured rectangles floating around the
origin, ray-traced on the host in float64 numpy with exact camera
geometry (OpenCV convention, pixel-centre rays, the intrinsics of
``data.nerf_dataset.camera_intrinsics``) and exact along-ray depth.

Outputs per scene (under ``DATA_PATH/NeRF_gt/<scene>/``):
    images/training/<i>.png        posed views for NeRF training
    depth/training/<i>.npy         along-ray depth
    poses.npy                      (N, 4, 4) OpenCV cam-to-world
    intrinsics.npy                 (3, 3)

PNGs go through ``data.png.write_gray``: their pixels are the reference's,
their bytes are not cv2's (another zlib stream). Each texture is a
stand-in composite whose background draws from OpenCV's generator, so
``main`` starts the calling thread's generator where a fresh cv2 process
starts it, and scenes are built in order.

Usage: SPNERF_ROOT=... python -m spnerf_tpu_torch.demo.nerf_scenes
[--n-scenes 4] [--n-views 48]
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from spnerf_tpu_torch import settings
from spnerf_tpu_torch.data import png
from spnerf_tpu_torch.data.nerf_dataset import camera_intrinsics
from spnerf_tpu_torch.data.rng import stable_seed
from spnerf_tpu_torch.demo.standin_data import fresh_cv_rng, make_composite
from spnerf_tpu_torch.tasks.nerf_task import pose_orbit

BACKGROUND = 0.5      # constant miss shade (the grey NeRF background)
MISS_DEPTH = 8.0      # along-ray depth recorded for rays hitting nothing
TEX = 256             # texture resolution


def _unit(v):
    return v / np.linalg.norm(v)


def build_scene(rng, n_rects: int = 7):
    """Textured rectangles around the origin, mostly facing outward so
    orbiting cameras (radius ~4) see texture nearly everywhere."""
    rects = []
    for _ in range(n_rects):
        center = rng.uniform(-1.0, 1.0, 3) * np.array([1.1, 0.8, 1.1])
        # normal: away from origin with noise -> visible from the orbit
        n = _unit(center + rng.normal(0, 0.35, 3) + 1e-3)
        # in-plane basis with random roll
        a = np.array([0.0, 1.0, 0.0])
        if abs(np.dot(a, n)) > 0.9:
            a = np.array([1.0, 0.0, 0.0])
        e1 = _unit(np.cross(a, n))
        e2 = np.cross(n, e1)
        roll = rng.uniform(0, 2 * np.pi)
        e1, e2 = (np.cos(roll) * e1 + np.sin(roll) * e2,
                  -np.sin(roll) * e1 + np.cos(roll) * e2)
        hx, hy = rng.uniform(0.45, 0.95, 2)
        tex = make_composite(rng, size=(TEX, TEX)).astype(np.float32) / 255.0
        rects.append({
            "center": center, "e1": e1 * hx, "e2": e2 * hy,
            "normal": n, "tex": tex,
        })
    return rects


def render_scene(rects, K, c2w, shape):
    """Ray-trace one view: (gray float32 in [0, 1] (H, W), along-ray
    depth float32 (H, W))."""
    H, W = shape
    ys, xs = np.meshgrid(np.arange(H) + 0.5, np.arange(W) + 0.5,
                         indexing="ij")
    pix = np.stack([xs.ravel(), ys.ravel(), np.ones(H * W)], axis=-1)
    dirs_cam = pix @ np.linalg.inv(K).T
    dirs = dirs_cam @ c2w[:3, :3].T
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    origin = c2w[:3, 3]

    best_t = np.full(H * W, np.inf)
    shade = np.full(H * W, BACKGROUND, np.float32)
    for r in rects:
        n = r["normal"]
        denom = dirs @ n
        with np.errstate(divide="ignore", invalid="ignore"):
            t = np.dot(r["center"] - origin, n) / denom
        p = origin + t[:, None] * dirs
        d = p - r["center"]
        a = d @ r["e1"] / np.dot(r["e1"], r["e1"])
        b = d @ r["e2"] / np.dot(r["e2"], r["e2"])
        hit = (np.abs(denom) > 1e-6) & (t > 0.1) & (t < best_t) \
            & (np.abs(a) <= 1) & (np.abs(b) <= 1)
        if not hit.any():
            continue
        u = (a[hit] + 1) * 0.5 * (TEX - 1)
        v = (b[hit] + 1) * 0.5 * (TEX - 1)
        u0, v0 = np.floor(u).astype(int), np.floor(v).astype(int)
        u1, v1 = np.minimum(u0 + 1, TEX - 1), np.minimum(v0 + 1, TEX - 1)
        fu, fv = u - u0, v - v0
        tex = r["tex"]
        val = (tex[v0, u0] * (1 - fu) * (1 - fv) + tex[v0, u1] * fu * (1 - fv)
               + tex[v1, u0] * (1 - fu) * fv + tex[v1, u1] * fu * fv)
        shade[hit] = val
        best_t[hit] = t[hit]

    depth = np.where(np.isfinite(best_t), best_t, MISS_DEPTH)
    return shade.reshape(H, W), depth.reshape(H, W).astype(np.float32)


def to_u8(img: np.ndarray) -> np.ndarray:
    """A rendered view as the 8-bit image the reference writes."""
    return np.clip(img * 255, 0, 255).astype(np.uint8)


def orbit_with_jitter(rng, n, radius=4.0):
    """pose_orbit with per-frame radius / height jitter, so NeRF training
    views are not degenerate (an exact circle has poor parallax)."""
    poses = []
    for i in range(n):
        base = pose_orbit(n, radius=radius + rng.uniform(-0.35, 0.35),
                          height=rng.uniform(-0.6, 0.9))[i]
        poses.append(base)
    return np.stack(poses).astype(np.float32)


def scene_rng(seed: int, s: int):
    """Scene ``s``'s numpy stream: ``build_scene`` draws from it first."""
    return np.random.default_rng((seed, stable_seed("nerf_scene"), s))


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--n-scenes", type=int, default=4)
    ap.add_argument("--n-views", type=int, default=48)
    ap.add_argument("--height", type=int, default=240)
    ap.add_argument("--width", type=int, default=320)
    ap.add_argument("--fov", type=float, default=60.0)
    ap.add_argument("--seed", type=int, default=0)
    return ap


def main(argv=None, root=None) -> None:
    """The reference's ``main`` under ``root`` (default
    ``settings.DATA_PATH``, read at call time)."""
    args = build_parser().parse_args(argv)
    root = Path(settings.DATA_PATH if root is None else root)
    fresh_cv_rng()
    K = camera_intrinsics((args.height, args.width), args.fov)
    for s in range(args.n_scenes):
        scene = f"demo_scene{s:02d}"
        out = root / "NeRF_gt" / scene
        if (out / "poses.npy").exists():
            print(f"{scene}: exists, skipping")
            continue
        rng = scene_rng(args.seed, s)
        rects = build_scene(rng)
        poses = orbit_with_jitter(rng, args.n_views)
        (out / "images" / "training").mkdir(parents=True, exist_ok=True)
        (out / "depth" / "training").mkdir(parents=True, exist_ok=True)
        for i in range(args.n_views):
            img, depth = render_scene(rects, K, poses[i],
                                      (args.height, args.width))
            png.write_gray(out / "images" / "training" / f"{i}.png",
                           to_u8(img))
            np.save(out / "depth" / "training" / f"{i}.npy", depth)
        np.save(out / "poses.npy", poses)
        np.save(out / "intrinsics.npy", K)
        print(f"{scene}: {args.n_views} views rendered")


if __name__ == "__main__":
    main()
