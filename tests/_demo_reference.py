"""The demo's fabricated files made by the reference scripts of ``demo/``
(with cv2), in one process, as separate runs of the scripts would make
them, and the digests the port is held to.

    python tests/_demo_reference.py ROOT            # the tree under ROOT
    python tests/_demo_reference.py ROOT --digests  # and rewrite the fixture

Under ``ROOT/data`` (the reference reads ``SPNERF_DATA_PATH`` at import,
hence a process of its own): ``make_standin_data`` at ``COUNTS``,
``make_nerf_scenes`` and ``render_gt_test_views``, each from OpenCV's
generator as a fresh process starts it; ``run_nerf_leg.write_pose_pairs``
over test poses from ``arc_poses`` (no NeRF is trained);
``link_rendered_corpus`` over stand-in rendered views. Under
``ROOT/extra``: ``orbit_with_jitter`` and ``arc_poses`` as text and one
small ``build_scene`` / ``render_scene`` view. ``--digests`` writes
``spnerf_tpu_torch/demo/digests.json``: sha256 of each JPEG's bytes, of
each PNG's pixels (``pixel_digest``) and of each text file, at the counts
``chip_smoke.py``'s ``[demo]`` phase fabricates, and under ``"orb"`` of
cv2's ORB (1,024 features) of each GT test view (``orb_digest``).
"""

from __future__ import annotations

import json
import os
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
FIXTURE = REPO / "spnerf_tpu_torch" / "demo" / "digests.json"
# the fabrication counts of the [demo] phase (tools/smoke_demo.py)
COUNTS = {"n_coco": 24, "n_hpatches": 2, "n_scenes": 2, "n_views": 16,
          "n_test_views": 12}
SMALL_SHAPE = (24, 32)
LINKED_VIEWS = 3  # stand-in rendered views a scene, for the link names


def run(root: Path) -> None:
    import cv2
    import numpy as np

    sys.path.insert(0, str(REPO))
    data = root / "data"
    os.environ["SPNERF_DATA_PATH"] = str(data)
    from demo import (link_rendered_corpus, make_nerf_scenes,
                      make_standin_data, render_gt_test_views, run_nerf_leg)

    def script(mod, *args):
        cv2.setRNGSeed(0)  # a fresh process's generator
        sys.argv = [mod.__file__, *args]
        mod.main()

    c = COUNTS
    script(make_standin_data, "--n-coco", str(c["n_coco"]), "--n-hpatches",
           str(c["n_hpatches"]))
    script(make_nerf_scenes, "--n-scenes", str(c["n_scenes"]), "--n-views",
           str(c["n_views"]))
    script(render_gt_test_views, "--n-test-views", str(c["n_test_views"]))
    scenes = sorted(p.name for p in (data / "NeRF_gt").iterdir())
    test_poses = run_nerf_leg.arc_poses(c["n_test_views"], radius=4.0,
                                        height=-0.2, start_deg=150.0)
    for s in scenes:
        views = data / "NeRF" / s / "images" / "training"
        views.mkdir(parents=True)
        np.save(data / "NeRF" / s / "poses_test.npy", test_poses)
        for i in range(LINKED_VIEWS):
            (views / f"{i}.png").write_bytes(b"")
    run_nerf_leg.write_pose_pairs(scenes, data / "nerf_pose_pairs.txt",
                                  n_test=c["n_test_views"], min_gap=2,
                                  max_gap=5)
    link_rendered_corpus.main()

    extra = root / "extra"
    extra.mkdir()
    rng = np.random.default_rng(1)
    np.savetxt(extra / "orbit.txt",
               make_nerf_scenes.orbit_with_jitter(rng, 5).reshape(-1, 4))
    np.savetxt(extra / "arc.txt", run_nerf_leg.arc_poses(
        7, radius=4.0, height=0.3, start_deg=0.0).reshape(-1, 4))
    cv2.setRNGSeed(0)
    rects = make_nerf_scenes.build_scene(np.random.default_rng(2), n_rects=3)
    K = make_nerf_scenes.camera_intrinsics(SMALL_SHAPE, 60.0)
    img, depth = make_nerf_scenes.render_scene(
        rects, K, make_nerf_scenes.pose_orbit(4)[1], SMALL_SHAPE)
    np.save(extra / "small_img.npy", img)
    np.save(extra / "small_depth.npy", depth)


def main() -> None:
    root, write = Path(sys.argv[1]), "--digests" in sys.argv[2:]
    run(root)
    if write:
        import cv2

        from spnerf_tpu_torch.tools.smoke_demo import (digests,
                                                       gt_test_views,
                                                       orb_digest)

        data = root / "data"
        files = digests(data,
                        lambda p: cv2.imread(str(p), cv2.IMREAD_GRAYSCALE))
        orb = {}
        for p in gt_test_views(data):
            kps, desc = cv2.ORB_create(1024).detectAndCompute(
                cv2.imread(str(p), cv2.IMREAD_GRAYSCALE), None)
            orb[p.relative_to(data).as_posix()] = orb_digest(
                [k.pt for k in kps], [k.size for k in kps],
                [k.angle for k in kps], [k.response for k in kps],
                [k.octave for k in kps], desc)
        FIXTURE.write_text(json.dumps({"counts": COUNTS, "files": files,
                                       "orb": orb}, indent=1,
                                      sort_keys=True) + "\n")
        print(f"{len(files)} digests, {len(orb)} ORB digests -> {FIXTURE}")


if __name__ == "__main__":
    main()
