"""Flatten the NeRF-rendered training views into a COCO-layout corpus
(``demo/link_rendered_corpus.py``), so that the homography control trains
on exactly the images the NeRF arm trains on:

    NeRF/<scene>/images/training/<i>.png
        -> COCO_nerf_views/images/training/<scene>_<i:03d>.png

as symbolic links. Links that exist are kept; rerun after rendering more
scenes.

Usage: SPNERF_ROOT=... python -m spnerf_tpu_torch.demo.link_corpus
"""

from __future__ import annotations

from pathlib import Path

from spnerf_tpu_torch import settings


def main(root=None) -> int:
    """Link every rendered training view under ``root`` (default
    ``settings.DATA_PATH``, read at call time); returns the corpus size."""
    root = Path(settings.DATA_PATH if root is None else root)
    src_root = root / "NeRF"
    dst = root / "COCO_nerf_views" / "images" / "training"
    dst.mkdir(parents=True, exist_ok=True)
    n = 0
    for scene_dir in sorted(src_root.iterdir()):
        img_dir = scene_dir / "images" / "training"
        if not img_dir.is_dir():
            continue
        for p in sorted(img_dir.glob("*.png"), key=lambda q: int(q.stem)):
            link = dst / f"{scene_dir.name}_{int(p.stem):03d}.png"
            if not link.exists():
                link.symlink_to(p.resolve())
                n += 1
    total = len(list(dst.glob("*.png")))
    print(f"linked {n} new views ({total} total) -> {dst}")
    if total == 0:
        raise SystemExit("no rendered views found - run the nerf leg")
    return total


if __name__ == "__main__":
    main()
