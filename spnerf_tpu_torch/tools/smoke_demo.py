"""The ``[demo]`` phase of ``chip_smoke.py``: the repo's end-to-end
experiment (``demo/run_demo.sh``'s default chain) through
``spnerf_tpu_torch.demo.run`` on the card, at a cut budget, in a child
process of its own (``SPNERF_ROOT`` is read at import).

    python -m spnerf_tpu_torch.tools.smoke_demo --root DIR [--out JSON]

runs the child; ``phase_demo(root)`` starts it from ``chip_smoke.py``
and returns its launches by leg. The chain, in order: data, mp,
nerf_data, nerf, nerf_export, link, ctl_export, nerf_sp, ctl_sp, pose,
eval, each leg timed by the host clock around synchronised work with the
launch counters at 0 before it. The cuts (``CUTS``, ``ENV``): 24 COCO
stand-ins (and 8 validation), 2 HPatches scenes, 2 NeRF scenes of 16
fabricated views, 200 NeRF steps a scene and 16 rendered training views,
MagicPoint resumed from ``demo/pretrained/demo_mp_5000.ckpt`` (the
JAX package's checkpoint, read by the port's msgpack reader) for 20 steps
over 6 + 1 Synthetic Shapes samples a primitive, and 20 steps of each
SuperPoint arm. Widths are the configs': SuperPoint 64-64-64-64-128-128-
128-128 with 256-wide heads, 240 x 320 images, 100 homographies in
chunks of 10, the bf16 4 x 128 field.

Checked: every leg ends without error; every file the fixture
``spnerf_tpu_torch/demo/digests.json`` lists (the JPEG bytes, PNG pixels
and text that ``demo/*.py`` writes at these counts) has its digest; the
warp kernel (row 9) launches in ``ctl_export`` and the hinge kernels
(rows 10-11) in ``nerf_sp`` and ``ctl_sp``; the pose leg writes the SIFT
calibration row (``baseline/sift``) beside both arms' rows. Printed, not
gated: each leg's seconds and launches, the bf16 NeRF step's and frame's
ms, the NeRF test PSNR, the repeatability, HPatches correctness and pose
AUC rows of both arms and of SIFT, and SIFT's host ms an image over the
GT test views.

After the chain, the demo's measurement tools over its tree, each phase
with its seconds: ``[orb]`` the ORB row (``--feature orb``, OpenCV's ORB
in ``native/cv_orb.cpp`` on the host) over the pose leg's GT pairs and
ORB's host ms an image; ``[label-fidelity]`` ``demo.label_fidelity``
over both scenes (the ray-traced side exported on the card, the NeRF side
the chain's labels); ``[live-steps]`` ``demo.live_steps`` over the legs'
logs; ``[multiproc-export]`` ``demo.multiproc_export`` over the 24 COCO
stand-ins, two gloo ranks on the card against one process, which fails
the phase unless the labels are equal. None of these runs a kernel of
ours (``[multiproc-export]``'s ranks count their own, unread).
"""

from __future__ import annotations

import argparse
import faulthandler
import hashlib
import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
FIXTURE = ROOT / "spnerf_tpu_torch" / "demo" / "digests.json"
DEMO_MP = ROOT / "demo" / "pretrained" / "demo_mp_5000.ckpt"
STEPS = 20
# the run's cuts: counts and steps, never widths
ENV = {"SPNERF_N_COCO": "24", "SPNERF_N_HPATCHES": "2",
       "SPNERF_N_SCENES": "2", "SPNERF_N_VIEWS": "16",
       "SPNERF_N_TRAIN_VIEWS": "16", "SPNERF_NERF_ITERS": "200",
       "SPNERF_MP_TARGET": str(5000 + STEPS), "SPNERF_MP_VALIDATE": "1",
       "SPNERF_SP_TARGET": str(STEPS)}
# 6 training samples a primitive: 39 after the config's truncation, one
# batch of 32 (the loader drops the partial one)
CUTS = ["mp:data.generation.split_sizes={training: 6, validation: 1, "
        "test: 0}", "mp:train.val_batches=1", "mp:log_every=5",
        "nerf_sp:log_every=5", "ctl_sp:log_every=5"]
# the kernels each leg must launch (rows 9, 10 and 11)
EXPECT = {"ctl_export": ("warp[",),
          "nerf_sp": ("desc_loss[fwd]", "desc_loss[dA]", "desc_loss[dB]"),
          "ctl_sp": ("desc_loss[fwd]", "desc_loss[dA]", "desc_loss[dB]")}
TIMEOUT = 300.0  # the chain takes about 65 s on an H100, the tools ~60 s
ECHO = ("[demo]", "[orb]", "[label-fidelity]", "[live-steps]",
        "[multiproc-export]")
T0 = time.perf_counter()


def log(msg: str) -> None:
    print(msg, flush=True)


def pixel_digest(shape, pixels: bytes) -> str:
    return hashlib.sha256(f"{shape[0]}x{shape[1]}:".encode()
                          + pixels).hexdigest()


def digests(data_root: Path, read_png) -> dict:
    """{path under ``data_root``: sha256} of the files the fixture holds:
    the bytes of JPEGs, ``H_1_*`` and pose-pair files, the pixels (by
    ``read_png``) of the fabricated scenes' PNGs."""
    out = {}
    for p in sorted(Path(data_root).rglob("*")):
        rel = p.relative_to(data_root).as_posix()
        if p.is_symlink() or not p.is_file():
            continue
        if p.suffix == ".png" and rel.startswith("NeRF_gt/"):
            img = read_png(p)
            out[rel] = pixel_digest(img.shape, img.tobytes())
        elif p.suffix == ".jpg" or p.name.startswith("H_1_") \
                or p.name.endswith("pose_pairs.txt"):
            out[rel] = hashlib.sha256(p.read_bytes()).hexdigest()
    return out


def orb_digest(pt, size, angle, response, octave, desc) -> str:
    """sha256 of one image's ORB keypoints and descriptors in cv2's order
    (float32 pt, size, angle, response, int32 level, uint8 descriptors)."""
    import numpy as np

    h = hashlib.sha256()
    for a, dtype in ((pt, np.float32), (size, np.float32),
                     (angle, np.float32), (response, np.float32),
                     (octave, np.int32), (desc, np.uint8)):
        h.update(np.ascontiguousarray(a, dtype).tobytes())
    return h.hexdigest()


def gt_test_views(data_root: Path) -> list:
    return sorted(Path(data_root, "NeRF_gt").glob("*/images/test/*.png"))


def check_digests(data_root: Path, want: dict, done: set) -> int:
    """Check the fixture's files that exist now and were not checked;
    returns how many were."""
    from spnerf_tpu_torch.data import png

    got = digests(data_root, png.read_gray)
    fresh = [k for k in want if k in got and k not in done]
    bad = [k for k in fresh if got[k] != want[k]]
    if bad:
        raise AssertionError(f"[demo] {len(bad)} fabricated files differ from "
                             f"digests.json: {bad[:5]}")
    done.update(fresh)
    return len(fresh)


def sift_ms(data_root: Path) -> list:
    """Host ms of ``eval.sift.sift(image, 1024)`` (the pose row's call) on
    each GT test view, timed by the host clock."""
    from spnerf_tpu_torch.data import png
    from spnerf_tpu_torch.eval import sift

    times = []
    for p in gt_test_views(data_root):
        img = png.read_gray(p)
        t0 = time.perf_counter()
        sift.sift(img, 1024)
        times.append(1e3 * (time.perf_counter() - t0))
    return times


def orb_ms(data_root: Path, want: dict) -> list:
    """Host ms of ``eval.orb.orb(image, 1024)`` (the ORB row's call) on
    each GT test view, timed by the host clock; each view's keypoints and
    descriptors must have the digest of cv2's (``want``, from
    digests.json)."""
    from spnerf_tpu_torch.data import png
    from spnerf_tpu_torch.eval import orb

    times, bad = [], []
    for p in gt_test_views(data_root):
        img = png.read_gray(p)
        t0 = time.perf_counter()
        o = orb.orb(img, 1024)
        times.append(1e3 * (time.perf_counter() - t0))
        rel = p.relative_to(data_root).as_posix()
        if orb_digest(o.pt, o.size, o.angle, o.response, o.octave,
                      o.desc) != want.get(rel):
            bad.append(rel)
    if bad or len(times) != len(want):
        raise AssertionError(f"[orb] {len(bad)} of {len(times)} views differ "
                             f"from cv2's ORB in digests.json ({len(want)} "
                             f"views): {bad[:4]}")
    return times


def spread(times: list) -> str:
    return (f"median {sorted(times)[len(times) // 2]:.3f} ms an image (min "
            f"{min(times):.3f}, max {max(times):.3f})")


def pose_line(row: dict) -> str:
    return (f"AUC@5 {row['auc5']:.2f} AUC@10 {row['auc10']:.2f} AUC@20 "
            f"{row['auc20']:.2f} precision {row['precision']:.2f} matching "
            f"score {row['matching_score']:.2f} over {row['num_pairs']} pairs")


def tools_after_chain(demo, summary: dict) -> dict:
    """[orb], [label-fidelity], [live-steps], [multiproc-export]."""
    from spnerf_tpu_torch import settings
    from spnerf_tpu_torch.demo import (label_fidelity, live_steps,
                                       multiproc_export,
                                       pose_baseline_classical, run)

    out = {}
    t0 = time.perf_counter()
    row = pose_baseline_classical.main([
        "--feature", "orb", "--config-path",
        str(run.CONFIGS / "pose_demo.yaml"), "--json-out",
        str(run.evidence("pose_auc.jsonl")), *demo.sets("pose")])
    times = orb_ms(settings.DATA_PATH,
                   json.loads(FIXTURE.read_text())["orb"])
    sift = next(r for r in summary["pose"] if r["pretrained"] == run.SIFT_TAG)
    log(f"[orb] baseline/orb (OpenCV's ORB, native/cv_orb.cpp): "
        f"{pose_line(row)}; baseline/sift {pose_line(sift)}")
    log(f"[orb] ORB on the host: {len(times)} GT test views of 240x320, "
        f"each equal to cv2's (digests.json), {spread(times)}; the phase "
        f"{time.perf_counter() - t0:.3f} s")
    out["orb"] = {"row": row, "ms": times}

    t0 = time.perf_counter()
    rows, seconds = label_fidelity.fidelity(
        int(ENV["SPNERF_N_SCENES"]), run.mp_seed(), "cuda")
    if len(rows) != int(ENV["SPNERF_N_SCENES"]) + 1:
        raise AssertionError(f"[label-fidelity] rows {rows}")
    for r in rows[:-1]:
        ref_s, test_s = seconds[r["scene"]]
        log(f"[label-fidelity] {r['scene']}: exact IoU {r['exact_iou']} "
            f"within 2 px {r['within_2px']} (ray-traced depth's labels "
            f"exported in {ref_s:.3f} s; the NeRF depth's "
            + (f"in {test_s:.3f} s)" if test_s else "from the nerf_export "
               "leg)"))
    log(f"[label-fidelity] mean exact IoU {rows[-1]['mean_exact_iou']} "
        f"within 2 px {rows[-1]['mean_within_2px']} over "
        f"{rows[-1]['n_scenes']} scenes, {rows[0]['pretrained']}; the phase "
        f"{time.perf_counter() - t0:.3f} s")
    out["label_fidelity"] = rows

    t0 = time.perf_counter()
    by_leg = live_steps.samples_by_leg()
    rows, short = live_steps.rows(by_leg), live_steps.short_legs(by_leg)
    for r in rows:
        log(f"[live-steps] {r['leg']}: median {r['median']} steps/s (p10 "
            f"{r['p10']}, p90 {r['p90']}) over {r['n_samples']} windows")
    for leg, n in sorted(short.items()):
        log(f"[live-steps] {leg}: {n} perf/steps_per_sec windows, fewer than "
            f"the 3 the tool needs: no row")
    log(f"[live-steps] the phase {time.perf_counter() - t0:.3f} s")
    out["live_steps"] = {"rows": rows, "short": short}

    t0 = time.perf_counter()
    rows = multiproc_export.main(["--truncate", "1.0", "--ha-num", "8",
                                  "--device", "cuda", "--timeout", "120"])
    for r in rows[:2]:
        log(f"[multiproc-export] {r['mode']}: {r['images']} images, "
            f"{r['ha_num']} homographies, {r['seconds']} s ({r['img_per_sec']}"
            f" images/s, process starts included)")
    log(f"[multiproc-export] merged_equals_single "
        f"{rows[2]['merged_equals_single']} ({rows[2]['n_byte_equal']} of "
        f"{rows[2]['n_images']} label files equal); the phase "
        f"{time.perf_counter() - t0:.3f} s")
    out["multiproc_export"] = rows
    return out


def child(out: Path) -> None:
    import torch

    from spnerf_tpu_torch import settings
    from spnerf_tpu_torch.demo import run
    from spnerf_tpu_torch.kernels import _build

    fixture = json.loads(FIXTURE.read_text())
    counts = {"n_coco": int(ENV["SPNERF_N_COCO"]),
              "n_hpatches": int(ENV["SPNERF_N_HPATCHES"]),
              "n_scenes": int(ENV["SPNERF_N_SCENES"]),
              "n_views": int(ENV["SPNERF_N_VIEWS"]),
              "n_test_views": run.N_TEST_VIEWS}
    if fixture["counts"] != counts:
        raise AssertionError(f"[demo] digests.json is for {fixture['counts']}"
                             f", this run fabricates {counts}")
    mp = Path(settings.CKPT_PATH, "demo_mp", "demo_mp_5000.ckpt")
    mp.parent.mkdir(parents=True, exist_ok=True)
    shutil.copy(DEMO_MP, mp)
    demo = run.Demo("cuda", run.parse_cuts(CUTS))
    checked: set = set()
    legs = {}
    for leg in run.CHAIN:
        log(f"[demo] {leg}: starting at {time.perf_counter() - T0:.1f} s")
        _build.launch_counts.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        demo.run(leg)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = dict(_build.launch_counts)
        n = check_digests(settings.DATA_PATH, fixture["files"], checked)
        legs[leg] = {"seconds": secs, "launches": launches}
        log(f"[demo] {leg}: {secs:.3f} s; launches "
            f"{json.dumps(launches, sort_keys=True)}"
            + (f"; {n} files equal to digests.json" if n else ""))
        for prefix in EXPECT.get(leg, ()):
            if not any(k.startswith(prefix) for k in launches):
                raise AssertionError(f"[demo] {leg} launched no {prefix}")
        torch.cuda.empty_cache()
    if checked != set(fixture["files"]):
        missing = sorted(set(fixture["files"]) - checked)
        raise AssertionError(f"[demo] {len(missing)} fixture files not "
                             f"written: {missing[:5]}")
    summary = run.summary()
    report = json.loads(Path(settings.DATA_PATH, "NeRF",
                             "nerf_leg_report.json").read_text())
    for scene, r in sorted(report.items()):
        log(f"[demo] bf16 NeRF {scene}: {r['iters']} steps of 4096 rays at "
            f"{r['step_ms']:.3f} ms a step (init included), {r['frames']} "
            f"frames of 240x320 at {r['frame_ms']:.3f} ms, final loss "
            f"{r['final_loss']:.5f}")
    for row in summary["quality"]:
        log(f"[demo] quality {json.dumps(row)}")
    for row in summary["pose"]:
        log(f"[demo] pose {row['pretrained']}: AUC@5 {row['auc5']:.2f} "
            f"AUC@10 {row['auc10']:.2f} AUC@20 {row['auc20']:.2f} precision "
            f"{row['precision']:.2f} matching score "
            f"{row['matching_score']:.2f} over {row['num_pairs']} pairs")
    log(f"[demo] NeRF test PSNR {json.dumps(summary['nerf_test_psnr'])}")
    times = sift_ms(settings.DATA_PATH)
    if not times:
        raise AssertionError("[demo] no GT test view to time SIFT on")
    log(f"[demo] SIFT on the host (native/cv_sift.cpp): {len(times)} GT "
        f"test views of 240x320, {spread(times)}")
    arms = {r["pretrained"].split("/")[0] for r in summary["pose"]}
    if arms != set(run.ARMS) | {"baseline"} or len(summary["quality"]) != 2:
        raise AssertionError(f"[demo] pose rows of {sorted(arms)}, "
                             f"{len(summary['quality'])} quality rows")
    tools = tools_after_chain(demo, summary)
    out.write_text(json.dumps({"legs": legs, "summary": summary,
                               "sift_ms": times, "tools": tools}))


def phase_demo(root: Path) -> dict:
    """[demo]: the child under ``root``, its output to ``root/demo.log``
    (its ``[demo]`` lines echoed here, its tail on a failure); returns
    {leg: launches}."""
    out, log_path = root / "demo.json", root / "demo.log"
    env = dict(os.environ, PYTHONUNBUFFERED="1")
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT)] + [p for p in os.environ.get("PYTHONPATH", "").split(
            os.pathsep) if p])
    t0 = time.perf_counter()
    with open(log_path, "w") as f:
        proc = subprocess.Popen([sys.executable, "-m", __name__, "--root",
                                 str(root), "--out", str(out)], cwd=ROOT,
                                env=env, stdout=f, stderr=subprocess.STDOUT)
        try:
            rc = proc.wait(timeout=TIMEOUT)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
            rc = f"killed after {TIMEOUT:.0f} s"
    text = log_path.read_text(errors="replace")
    for line in text.splitlines():
        if line.startswith(ECHO):
            log(line)
    if rc != 0:
        raise AssertionError(f"[demo] the chain failed ({rc}):\n"
                             f"{text[-6000:]}")
    legs = json.loads(out.read_text())["legs"]
    log(f"[demo] run_demo.sh's chain ({len(legs)} legs) in "
        f"{time.perf_counter() - t0:.3f} s with the child's start; cuts "
        f"{json.dumps(ENV, sort_keys=True)} {json.dumps(CUTS)}")
    return {leg: v["launches"] for leg, v in legs.items()}


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--root", required=True)
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)
    # before the port's settings are imported: they read SPNERF_ROOT
    os.environ.update(ENV, SPNERF_ROOT=str(Path(args.root) / "runs"))
    for key in ("SPNERF_DATA_PATH", "SPNERF_CKPT_PATH", "SPNERF_EXPER_PATH"):
        os.environ.pop(key, None)
    # a leg that hangs leaves every thread's stack in the log
    faulthandler.dump_traceback_later(TIMEOUT - 30, exit=True)
    child(Path(args.out))


if __name__ == "__main__":
    main()
