"""Fabricate the stand-in COCO and HPatches datasets of the demo
(``demo/make_standin_data.py``), byte for byte, without cv2.

- "COCO" stand-ins: composites of several synthetic-shapes primitives on
  one canvas at 480 x 640, written as gray JPEGs in the COCO layout
  (``DATA_PATH/COCO/images/{training,validation}/demo_<i>.jpg``).
- "HPatches" viewpoint scenes: a held-out composite warped by 5 random
  pixel-coordinate homographies, in the HPatches layout
  (``DATA_PATH/HPatches/v_demo<s>/{1..6}.jpg`` and ``H_1_2`` .. ``H_1_6``).

The drawing is the port's (``data/synthetic_draw.py``), the blur
``cv_filter.gaussian_blur_u8``, the warp ``cv_warp.warp_perspective_u8``
and the JPEG writer ``jpeg.write_gray``: cv2's bytes. Each composite's
background draws from OpenCV's generator, so an image depends on every
fill before it; ``main`` starts the calling thread's generator where a
fresh process starts cv2's, and files that exist are skipped without
drawing, as the reference script does.

Usage: SPNERF_ROOT=... python -m spnerf_tpu_torch.demo.standin_data
[--n-coco 5000] [--n-hpatches 30]
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from spnerf_tpu_torch import settings
from spnerf_tpu_torch.data import cv_draw, jpeg
from spnerf_tpu_torch.data import synthetic_draw as sd
from spnerf_tpu_torch.data.cv_filter import gaussian_blur_u8
from spnerf_tpu_torch.data.cv_warp import warp_perspective_u8
from spnerf_tpu_torch.data.rng import stable_seed
from spnerf_tpu_torch.eval import cv_rng

PRIMS = [
    sd.draw_lines, sd.draw_polygon, sd.draw_multiple_polygons,
    sd.draw_ellipses, sd.draw_star, sd.draw_checkerboard,
    sd.draw_stripes, sd.draw_cube,
]


def fresh_cv_rng() -> None:
    """Restart the calling thread's OpenCV generator at the state a fresh
    cv2 process starts its main thread at (``setRNGSeed(0)``'s)."""
    cv_rng.set_rng_seed(0)


def make_composite(rng, size=(480, 640)):
    img = sd.generate_background(size, rng)
    for fn in rng.choice(PRIMS, size=rng.integers(2, 5), replace=False):
        fn(img, rng)
    blur = int(rng.integers(0, 2)) * 2 + 1
    if blur > 1:
        img = gaussian_blur_u8(img, blur)
    return np.clip(img, 0, 255).astype(np.uint8)


def random_pixel_homography(rng, h, w, strength=0.15):
    """Random viewpoint homography in pixel coordinates: perspective +
    rotation + scale + translation jitter of the image corners."""
    corners = np.array([[0, 0], [w, 0], [w, h], [0, h]], np.float32)
    jitter = rng.uniform(-strength, strength, (4, 2)).astype(np.float32)
    target = corners + jitter * np.array([w, h], np.float32)
    return cv_draw.get_perspective_transform(corners,
                                             target.astype(np.float32))


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--n-coco", type=int, default=5000)
    ap.add_argument("--n-hpatches", type=int, default=30)
    ap.add_argument("--strength", type=float, default=0.15,
                    help="viewpoint difficulty (a fixed benchmark "
                         "parameter)")
    ap.add_argument("--seed", type=int, default=0)
    return ap


def main(argv=None, root=None) -> None:
    """The reference's ``main`` under ``root`` (default
    ``settings.DATA_PATH``, read at call time)."""
    args = build_parser().parse_args(argv)
    root = Path(settings.DATA_PATH if root is None else root)
    fresh_cv_rng()

    # independent per-section streams: each image or scene is a function
    # of (seed, section, index) and of the OpenCV draws before it
    def stream(section, index):
        return np.random.default_rng((args.seed, stable_seed(section), index))

    coco_dir = root / "COCO" / "images" / "training"
    coco_dir.mkdir(parents=True, exist_ok=True)
    for i in range(args.n_coco):
        out = coco_dir / f"demo_{i:05d}.jpg"
        if not out.exists():
            jpeg.write_gray(out, make_composite(stream("coco_train", i)))
    print(f"wrote {args.n_coco} stand-in COCO images -> {coco_dir}")

    val_dir = root / "COCO" / "images" / "validation"
    val_dir.mkdir(parents=True, exist_ok=True)
    for i in range(max(8, args.n_coco // 20)):
        out = val_dir / f"demo_{i:05d}.jpg"
        if not out.exists():
            jpeg.write_gray(out, make_composite(stream("coco_val", i)))

    hp_root = root / "HPatches"
    for s in range(args.n_hpatches):
        scene = hp_root / f"v_demo{s:02d}"
        if (scene / "H_1_6").exists():
            continue
        scene.mkdir(parents=True, exist_ok=True)
        rng = stream("hpatches", s)
        base = make_composite(rng)
        h, w = base.shape
        jpeg.write_gray(scene / "1.jpg", base)
        for i in range(2, 7):
            H = random_pixel_homography(rng, h, w, strength=args.strength)
            jpeg.write_gray(scene / f"{i}.jpg",
                            warp_perspective_u8(base, H, (w, h)))
            np.savetxt(str(scene / f"H_1_{i}"), H)
    print(f"wrote {args.n_hpatches} viewpoint scenes -> {hp_root}")


if __name__ == "__main__":
    main()
