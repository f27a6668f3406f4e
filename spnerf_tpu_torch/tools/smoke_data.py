"""The bootstrap's own-data phases of ``chip_smoke.py``: README's
bootstrap from its own data through ``cli.main`` on the card, with the
JPEG reads it rests on. ``chip_smoke.py`` runs ``phase_bootstrap`` after
``[quant]``; the phases, in order:

- ``[jpeg]``: every committed fixture of ``tests/data/jpeg``, ``png``,
  ``pnm`` (baseline, progressive, 4:2:0 to 4:1:1, gray, CMYK, YCCK, cut,
  EXIF-rotated, arithmetic-coded, RGB-coded, block-smoothed, resynced,
  lossless; PNG at every depth and colour type, Adam7, misnamed files;
  P1-P6) and of OpenCV's own six decoders' folders, ``bmp``, ``sunras``,
  ``pam``, ``pfm``, ``hdr``, ``gif``, read by ``data/imread.py``, which
  picks the decoder by the file's signature, gray and colour, to the
  shape and sha256 of cv2's reads when the fixtures were made
  (``digests.json``; a null digest, cv2's None, must raise
  ``Unreadable``); the uncompressed 480 x 640 timing files (BMP, Sun
  raster, PAM, PFM) written here from a decoded fixture and read back
  to it; ms per 480 x 640 image on the host clock for each kind timed
  (``JPEG_TIMED``), gray and colour, beside the card's name and power
  limit;
- ``[process-scene-jpeg]``: ``tools.process_scene.main`` at the tiny
  preset over a scene whose frames are the colour JPEG fixtures, with
  orbit poses; the frames read as the colour digests say, the written
  scene read back by ``NeRFDataset``;
- ``[syn-gen]``: magicpoint_syn.yaml's Synthetic Shapes at its widths
  (960 x 1280, blur 21, resize 120 x 160, nine primitives, its truncate),
  ``split_sizes`` cut to 12 / 4 / 0: ms per sample by primitive, counts,
  points, and a second pass into a fresh directory byte-identical (the
  primitives' seeds depend on ``PYTHONHASHSEED``, which ``chip_smoke.py``
  fixes to 0, so the samples and their point counts repeat run to run);
- ``[syn-train]``: 20 steps of it (batch 32, photometric and homographic
  augmentation on the card), 2 validation batches and a checkpoint, the
  loss falling;
- ``[coco-export]``: ``export_pseudo_labels`` on
  magicpoint_coco_export.yaml (240 x 320, batch 8, 100 views in chunks of
  10) from that checkpoint over 96 + 8 COCO-layout copies of the
  fixtures of all nine folders (every one cv2 reads gray in the training
  split, a PNG named ``.jpg`` among them), the training split again with
  ``export.serving=int8``: labels
  checked, the warp twice a chunk and the int8 kernels once a forward
  per batch, images/s;
- ``[label-iou]`` and ``[ha-rate]``: ``demo.label_iou`` of the int8
  training labels against the bf16 ones (exact IoU and within 2 px, the
  agreement the reference's round 3 measured), and ``demo.ha_rate`` of
  both exports (images/s after the first fifth, by the files' mtimes);
- ``[coco-train]``: magicpoint_coco_train.yaml for 20 steps at
  ``data.num_workers`` 1 and 4 (no kernel of ours), then
  superpoint_coco_train.yaml (240 x 320, batch 2) over those labels with
  the photometric augmentation on the card, and on the host at
  ``data.num_workers`` 1 and 4: rows 10-11 once per step (the forward
  once more per validation batch), steps/s of every run, the host
  augmentation's ms per image, and the training loaders' batch indices,
  equal at 1 and 4 workers.

Imports nothing of the JAX package, no cv2 and no PIL.
"""

from __future__ import annotations

import collections
import contextlib
import copy
import hashlib
import json
import shutil
import statistics
import struct
import time
from pathlib import Path

import numpy as np
import torch

from spnerf_tpu_torch import cli, settings
from spnerf_tpu_torch.data import (bmp, coco, cv_codec, gif, hdr, imread,
                                   jpeg, pam, pfm, photometric, png, pnm,
                                   sunras, synthetic_shapes)
from spnerf_tpu_torch.data.loader import DataLoader
from spnerf_tpu_torch.data.nerf_dataset import NeRFDataset
from spnerf_tpu_torch.demo import ha_rate, label_iou
from spnerf_tpu_torch.eval import cv_rng
from spnerf_tpu_torch.kernels import _build
from spnerf_tpu_torch.tasks import export
from spnerf_tpu_torch.tasks.nerf_task import pose_orbit
from spnerf_tpu_torch.tools import process_scene
from spnerf_tpu_torch.utils.config import apply_overrides, load_config

ROOT = Path(__file__).resolve().parents[2]
# the configurations, read by the port's own YAML reader from its copies
CONFIGS = ROOT / "spnerf_tpu_torch" / "configs"
JPEG_DIR = ROOT / "tests" / "data" / "jpeg"
# the committed fixtures of every format the port reads
IMAGE_DIRS = tuple(ROOT / "tests" / "data" / f for f in (
    "jpeg", "png", "pnm", "bmp", "sunras", "pam", "pfm", "hdr", "gif"))
COLOUR = "colour"  # the colour digests' key in digests.json
# the 480 x 640 file timed for each kind: (folder, name); folder WRITTEN
# for the uncompressed files phase_jpeg writes (write_timed)
WRITTEN = "written"
JPEG_TIMED = {"baseline": ("jpeg", "q95_420.jpg"),
              "progressive": ("jpeg", "prog_420.jpg"),
              "arithmetic": ("jpeg", "arith_420.jpg"),
              "arithmetic progressive": ("jpeg", "arith_prog_420.jpg"),
              "RGB-coded": ("jpeg", "rgb_444.jpg"),
              "block-smoothed": ("jpeg", "prog_smooth_cut.jpg"),
              "resynced": ("jpeg", "rst_missing.jpg"),
              "lossless": ("jpeg", "lossless_gray.jpg"),
              "PNG 16-bit": ("png", "rgb16.png"),
              "PNG palette": ("png", "palette.png"),
              "BMP 24-bit": (WRITTEN, "rgb24.bmp"),
              "Sun raster 24-bit": (WRITTEN, "bgr24.ras"),
              "PAM RGB": (WRITTEN, "rgb.pam"),
              "PFM gray": (WRITTEN, "gray.pfm"),
              "PFM colour": (WRITTEN, "rgb.pfm"),
              "HDR run-length": ("hdr", "rle_480x640.hdr"),
              "GIF": ("gif", "colour_480x640.gif")}
# the reads cv2 refuses of a timed kind (None: cv2.imread returns None)
NOT_READ = {"lossless": "colour", "PFM gray": "colour", "PFM colour": "gray"}
# (gray, colour) decoder of each format, by imread.format_of
DECODERS = {"jpeg": (jpeg.decode_gray, jpeg.decode_bgr)}
DECODERS.update({module.__name__.rsplit(".", 1)[1]: (
    module.decode_gray, module.decode_rgb) for module in (
        png, pnm, bmp, sunras, pam, pfm, hdr, gif)})
JPEG_REPS = 20
SEED = 0
HA_SHAPE = (240, 320)  # magicpoint_coco_export.yaml's resize
SYN_CONFIG = CONFIGS / "magicpoint_syn.yaml"
# the only cut of magicpoint_syn.yaml's data: 12 training and 4
# validation samples per primitive (10,000 / 200 / 500 in the file; 24
# and 8 until the script's time went to [demo])
SYN_CUTS = {"data.generation.split_sizes": {"training": 12, "validation": 4,
                                            "test": 0}}
BOOT_STEPS = 20
BOOT_TRAIN_CUTS = {"train.num_iters": BOOT_STEPS,
                   "save_or_validation_interval": BOOT_STEPS,
                   "train.val_batches": 2, "log_every": 5}
# points a sample must carry: one segment has two corners, every other
# corner-bearing primitive at least three; ellipses and noise none. The
# stripes' corners all lie on the top and bottom edges, which the board's
# homography may push out of the image: a sample may keep none, so three
# is asked of their median
SYN_MIN_POINTS = {"draw_lines": 2, "draw_ellipses": 0, "gaussian_noise": 0,
                  "draw_stripes": 0}
SYN_MEDIAN_POINTS = {"draw_stripes": 3}
# training: the smallest multiple of 8 (the export's batch) that holds
# every fixture cv2 reads gray, and one PNG more named .jpg
COCO_IMAGES = {"training": 96, "validation": 8}
COCO_EXPORT = CONFIGS / "magicpoint_coco_export.yaml"
COCO_INT8_EXPER = "coco_export_int8"
PHOTO_REPS = 20
WORKERS = (1, 4)  # data.num_workers of the [coco-train] A/B
PROCESS_SCENE_JPEG_SIZE = (120, 160)
PROCESS_SCENE_JPEG_ARGS = ["--scene-name", "JpegTool", "--train-iters", "24",
                           "--render-size",
                           *(str(v) for v in PROCESS_SCENE_JPEG_SIZE),
                           "--n-novel-views", "5", "--nerf-preset", "tiny"]
PROCESS_SCENE_FOV = 60.0


def log(msg: str) -> None:
    print(msg, flush=True)


def cut(config: dict, cuts: dict) -> dict:
    """A copy of ``config`` with ``cuts`` ({"dotted.path": value}) set."""
    config = copy.deepcopy(config)
    for dotted, value in cuts.items():
        *path, leaf = dotted.split(".")
        node = config
        for part in path:
            node = node[part]
        node[leaf] = copy.deepcopy(value)
    return config


def set_args(cuts: dict) -> list:
    """``--set key=value`` arguments, each value written as YAML."""
    out = []
    for key, value in cuts.items():
        out += ["--set", f"{key}={json.dumps(value)}"]
    return out


def read_metrics(ckpt_name: str) -> dict:
    """{tag: [(step, value), ...]} of a run's metrics.jsonl."""
    path = Path(settings.CKPT_PATH, ckpt_name, "logs", "metrics.jsonl")
    out = collections.defaultdict(list)
    for line in path.read_text().splitlines():
        row = json.loads(line)
        out[row["tag"]].append((row["step"], row["value"]))
    return out


def check_labels(out_dir: Path, n: int, shape=HA_SHAPE):
    """Keypoints per file of ``n`` int64 (N, 2) label files inside
    ``shape``, none of them empty."""
    files = sorted(out_dir.glob("*.npy"))
    if len(files) != n:
        raise AssertionError(f"{len(files)} label files for {n} images")
    counts = []
    for f in files:
        pts = np.load(f)
        if pts.dtype != np.int64 or pts.ndim != 2 or pts.shape[1] != 2:
            raise AssertionError(f"{f.name}: {pts.dtype} {pts.shape}")
        if len(pts) == 0:
            raise AssertionError(f"{f.name}: no keypoint")
        if pts.min() < 0 or (pts >= list(shape)).any():
            raise AssertionError(f"{f.name}: keypoint outside the image")
        counts.append(len(pts))
    return counts


def digest(img: np.ndarray) -> dict:
    return {"shape": list(img.shape),
            "sha256": hashlib.sha256(np.ascontiguousarray(img).tobytes())
            .hexdigest()}


def jpeg_digests(folder: Path = JPEG_DIR):
    """(gray digests, colour digests) by fixture name; a colour digest is
    None where cv2's colour read returned None."""
    digests = json.loads((folder / "digests.json").read_text())
    colour = digests.pop(COLOUR)
    return digests, colour


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    import subprocess

    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()


def median_ms(fn, *args, reps: int = JPEG_REPS):
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn(*args)
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times), min(times)


def write_timed(folder: Path, rgb: np.ndarray) -> dict:
    """The uncompressed 480 x 640 timing files (``JPEG_TIMED``'s WRITTEN
    ones) written into ``folder`` from (H, W, 3) uint8 R, G, B: as
    ``cv2.imencode`` writes them (BMP and Sun raster rows of B, G, R, the
    BMP's bottom-up and padded to 4 bytes; PAM bytes as cv2 stores a B,
    G, R image; PFM float32 rows bottom-up, little-endian). Returns {name:
    (gray read, colour read)} each must decode to, the PFM files one read
    each."""
    h, w = rgb.shape[:2]
    bgr = np.ascontiguousarray(rgb[..., ::-1])
    gray = rgb[..., 1]
    row = w * 3 + (-w * 3) % 4
    rows = np.zeros((h, row), np.uint8)
    rows[:, :w * 3] = bgr[::-1].reshape(h, -1)
    files = {
        "rgb24.bmp": b"BM" + struct.pack("<IHHI", 54 + rows.size, 0, 0, 54)
        + struct.pack("<IiiHHIIiiII", 40, w, h, 1, 24, 0, rows.size, 0, 0,
                      0, 0) + rows.tobytes(),
        "bgr24.ras": struct.pack(">8I", 0x59A66A95, w, h, 24, bgr.size, 1,
                                 0, 0) + bgr.tobytes(),
        "rgb.pam": f"P7\nWIDTH {w}\nHEIGHT {h}\nDEPTH 3\nMAXVAL 255\n"
        f"TUPLTYPE RGB\nENDHDR\n".encode() + bgr.tobytes(),
        "gray.pfm": f"Pf\n{w} {h}\n-1\n".encode()
        + gray[::-1].astype("<f4").tobytes(),
        "rgb.pfm": f"PF\n{w} {h}\n-1\n".encode()
        + rgb[::-1].astype("<f4").tobytes(),
    }
    folder.mkdir(parents=True, exist_ok=True)
    for name, data in files.items():
        (folder / name).write_bytes(data)
    codec_gray = cv_codec.gray(bgr)  # OpenCV's codecs' colour-to-gray
    # a PAM gray read takes the first byte of a pixel for red
    return {"rgb24.bmp": (codec_gray, rgb), "bgr24.ras": (codec_gray, rgb),
            "rgb.pam": (cv_codec.gray(rgb), rgb), "gray.pfm": (gray, None),
            "rgb.pfm": (None, rgb)}


def phase_jpeg(root: Path) -> None:
    """[jpeg]: every committed fixture of the nine folders read gray and
    colour through ``data/imread.py`` (the decoder picked by the file's
    signature: misnamed files go through it) to the shape and sha256 cv2
    gave when the fixtures were made, or to ``Unreadable`` where cv2's
    read was None; the uncompressed timing files written under ``root``
    (``write_timed``) read back to the image they were written from; ms
    per 480 x 640 image of each timed kind, gray and colour, with the
    card's name and power limit."""
    t0 = time.perf_counter()
    jpeg.read_gray(JPEG_DIR / "q95_420.jpg")  # builds the library
    build_s = time.perf_counter() - t0
    names = []
    for folder in IMAGE_DIRS:
        gray, colour = jpeg_digests(folder)
        for name in sorted(gray):
            path = folder / name
            for mode, want, read in (
                    ("gray", gray[name], imread.read_gray),
                    ("colour", colour[name],
                     lambda p: imread.read_rgb(p)[..., ::-1])):
                if want is None:
                    try:
                        read(path)
                    except imread.Unreadable:
                        continue
                    raise AssertionError(f"[jpeg] {folder.name}/{name}: a "
                                         f"{mode} read cv2 refuses decoded")
                got = digest(read(path))
                if got != want:
                    raise AssertionError(
                        f"[jpeg] {folder.name}/{name} {mode}: {got} against "
                        f"cv2's {want}")
            names.append(f"{folder.name}/{name}")
    written = root / WRITTEN
    t0 = time.perf_counter()
    wants = write_timed(written, imread.read_rgb(JPEG_DIR / "q95_420.jpg"))
    for name, (want_gray, want_rgb) in wants.items():
        for want, read in ((want_gray, imread.read_gray),
                           (want_rgb, imread.read_rgb)):
            if want is not None and not np.array_equal(read(written / name),
                                                       want):
                raise AssertionError(f"[jpeg] {name} does not read back to "
                                     "the image it was written from")
    write_s = time.perf_counter() - t0
    times = []
    for kind, (folder, name) in JPEG_TIMED.items():
        path = (written if folder == WRITTEN else
                ROOT / "tests" / "data" / folder) / name
        data = path.read_bytes()
        gray_fn, colour_fn = DECODERS[imread.format_of(data)]
        for mode, decode in (("gray", gray_fn), ("colour", colour_fn)):
            if NOT_READ.get(kind) == mode:
                continue  # cv2.imread returns None for this read
            img = decode(data)
            med, least = median_ms(decode, data)
            times.append(f"{kind} {mode} {name} ({img.shape[0]}x"
                         f"{img.shape[1]}, {len(data) / 1e3:.1f} kB) "
                         f"{med:.4f} ms (min {least:.4f})")
    log(f"[jpeg] {len(names)} fixtures ({', '.join(names)}) read through "
        f"imread to cv2.imread's shape and sha256, gray and colour; "
        f"{len(wants)} timing files written and read back in "
        f"{write_s:.3f} s; ms per image (median of {JPEG_REPS}, host "
        f"clock; card {card_line()}): {'; '.join(times)}; g++ build + "
        f"first decode {build_s:.3f} s")


def phase_process_scene_jpeg(root: Path) -> None:
    """[process-scene-jpeg]: the colour JPEG fixtures as a scene's frames,
    with orbit poses in a NerfStudio ``transforms.json``, through
    ``tools.process_scene.main`` (PROCESS_SCENE_JPEG_ARGS); every frame
    read as its colour digest says, the layout read back by
    ``NeRFDataset``."""
    _, colour = jpeg_digests()
    scene_dir = root / "process_scene_jpeg"
    (scene_dir / "images").mkdir(parents=True)
    # not the lossless file: cv2 reads it gray alone
    names = sorted(n for n, d in colour.items() if d is not None)
    poses = pose_orbit(len(names))
    flip = np.diag([1.0, -1.0, -1.0, 1.0])
    frames = []
    for j, name in enumerate(names):
        frame = f"images/frame_{j:05d}.jpg"
        shutil.copy(JPEG_DIR / name, scene_dir / frame)
        got = digest(imread.read_rgb(scene_dir / frame)[..., ::-1])
        if got != colour[name]:
            raise AssertionError(f"[process-scene-jpeg] {frame} ({name}): "
                                 f"{got} against {colour[name]}")
        frames.append({"file_path": frame,
                       "transform_matrix": (poses[j] @ flip).tolist()})
    (scene_dir / "transforms.json").write_text(json.dumps(
        {"camera_angle_x": float(np.deg2rad(PROCESS_SCENE_FOV)),
         "frames": frames}))
    H, W = PROCESS_SCENE_JPEG_SIZE
    t0 = time.perf_counter()
    loaded = process_scene.load_frames(
        [scene_dir / f["file_path"] for f in frames], (H, W))
    load_ms = (time.perf_counter() - t0) * 1e3
    if loaded.shape != (len(names), H, W, 3) or not (
            (loaded >= 0) & (loaded <= 1)).all():
        raise AssertionError(f"[process-scene-jpeg] frames {loaded.shape}")
    t0 = time.perf_counter()
    out = process_scene.main(["--data-path", str(scene_dir)]
                             + PROCESS_SCENE_JPEG_ARGS)
    secs = time.perf_counter() - t0
    counts = {}
    for split in ("training", "validation", "test"):
        ds = NeRFDataset({"name": "NeRF", "data_dir": out.name,
                          "warped_pair": False}, split)
        counts[split] = len(ds)
        for i in range(len(ds)):
            sample = ds[i]
            if (sample["image"].shape != (H, W, 1)
                    or sample["depth"].shape != (H, W)
                    or not np.isfinite(sample["depth"]).all()):
                raise AssertionError(f"[process-scene-jpeg] {split} {i}: "
                                     f"{sample['image'].shape}")
    if counts != {"training": 4, "validation": 0, "test": 1}:
        raise AssertionError(f"[process-scene-jpeg] frames per split "
                             f"{counts}")
    log(f"[process-scene-jpeg] tools.process_scene.main "
        f"{' '.join(PROCESS_SCENE_JPEG_ARGS)} on {len(names)} JPEG frames "
        f"(the fixtures, read to their colour digests; orbit poses, "
        f"transforms.json) on the card: {secs:.3f} s; load_frames "
        f"{load_ms:.3f} ms for all {len(names)}; NeRFDataset reads {counts}")


def syn_data_config() -> dict:
    return cut(load_config(SYN_CONFIG), SYN_CUTS)["data"]


def files_of(root: Path) -> dict:
    return {p.relative_to(root): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


def phase_syn_gen(root: Path) -> None:
    """[syn-gen]: magicpoint_syn.yaml's dataset (960 x 1280, blur 21,
    resize 120 x 160, all nine primitives, its truncate) with SYN_CUTS,
    one primitive at a time (ms per sample); the datasets' counts and
    points checked; a second pass into a fresh directory, OpenCV's
    generator restarted at the first pass's state, byte-identical."""
    data_cfg = syn_data_config()
    gen = data_cfg["generation"]
    sizes = gen["split_sizes"]
    per_primitive = sum(sizes.values())
    start = cv_rng.the_rng().state
    settings.DATA_PATH = root / "data"
    rates = {}
    t_all = time.perf_counter()
    for primitive in synthetic_shapes.PRIMITIVES:
        t0 = time.perf_counter()
        synthetic_shapes.SyntheticShapes(dict(data_cfg,
                                              primitives=[primitive]))
        rates[primitive] = (time.perf_counter() - t0) / per_primitive * 1e3
    first_s = time.perf_counter() - t_all
    truncate = data_cfg["truncate"]
    resize = data_cfg["preprocessing"]["resize"]
    counts = collections.defaultdict(list)  # points per sample, both splits
    n_samples = {}
    for split in ("training", "validation"):
        ds = synthetic_shapes.SyntheticShapes(data_cfg, split)
        want = sum(max(1, int(sizes[split] * (truncate.get(p, 1.0) or 1.0)))
                   for p in synthetic_shapes.PRIMITIVES)
        if len(ds) != want:
            raise AssertionError(f"[syn-gen] {split}: {len(ds)} samples, "
                                 f"expected {want}")
        n_samples[split] = len(ds)
        for img_path, pts_path in zip(ds.samples["images"],
                                      ds.samples["points"]):
            pts = np.load(pts_path)
            if pts.dtype != np.float32 or (len(pts) and (
                    pts.min() < 0 or (pts >= resize).any())):
                raise AssertionError(f"[syn-gen] {img_path}: points "
                                     f"{pts.dtype} outside {resize}")
            counts[img_path.parts[-4]].append(len(pts))
        sample = ds[0]
        if sample["image"].shape != tuple(resize) + (1,):
            raise AssertionError(f"[syn-gen] sample {sample['image'].shape}")
    for primitive, n in counts.items():
        least = SYN_MIN_POINTS.get(primitive, 3)
        none = primitive in ("draw_ellipses", "gaussian_noise")
        if (min(n) < least or (none and max(n) > 0)
                or statistics.median(n) < SYN_MEDIAN_POINTS.get(primitive, 0)):
            raise AssertionError(f"[syn-gen] {primitive}: points per sample "
                                 f"{n}")
    points = {p: (min(n), statistics.median(n), max(n))
              for p, n in counts.items()}
    first = files_of(root / "data")
    cv_rng.the_rng().state = start
    settings.DATA_PATH = root / "again"
    t0 = time.perf_counter()
    synthetic_shapes.SyntheticShapes(data_cfg)
    second_s = time.perf_counter() - t0
    if files_of(root / "again") != first:
        raise AssertionError("[syn-gen] the second pass wrote other files")
    settings.DATA_PATH = root / "data"
    n_files = len(first)
    log(f"[syn-gen] {SYN_CONFIG.name}, {gen['image_size'][0]}x"
        f"{gen['image_size'][1]} -> {resize[0]}x{resize[1]}, blur "
        f"{data_cfg['preprocessing']['blur_size']}, 9 primitives, cut: "
        f"split_sizes {json.dumps(sizes)}; {9 * per_primitive} samples in "
        f"{first_s:.3f} s; ms per sample: "
        + ", ".join(f"{p} {v:.1f}" for p, v in rates.items())
        + f"; datasets (truncate {json.dumps(truncate)}): "
        f"{n_samples['training']} training, {n_samples['validation']} "
        f"validation; points per sample (min, median, max): "
        + ", ".join(f"{p} {v}" for p, v in points.items())
        + f"; second pass {second_s:.3f} s, {n_files} files byte-identical")


def boot_train(config: Path, cuts: dict, label: str):
    """``cli.main --task train --validate-training`` on ``config`` with
    ``cuts``, the launch counters at 0 before: (state, launches, seconds,
    metrics); the losses finite, the checkpoint written."""
    args = ["--config-path", str(config), "--task", "train",
            "--validate-training", "--device", "cuda"] + set_args(cuts)
    _build.launch_counts.clear()
    t0 = time.perf_counter()
    state = cli.main(args)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = dict(_build.launch_counts)
    name = cuts.get("ckpt_name") or load_config(config)["ckpt_name"]
    steps = cuts["train.num_iters"]
    metrics = read_metrics(name)
    for tag, rows in metrics.items():
        if not all(np.isfinite(v) for _, v in rows):
            raise AssertionError(f"[{label}] {tag} is not finite: {rows}")
    losses = metrics["iter_loss/loss"]
    if state.iteration != steps or [s for s, _ in losses] != [5, 10, 15, 20]:
        raise AssertionError(f"[{label}] {state.iteration} steps, loss "
                             f"logged at {losses}")
    if len(metrics["val/val_loss"]) != 1:
        raise AssertionError(f"[{label}] validation {metrics['val/val_loss']}")
    if not Path(settings.CKPT_PATH, name, f"{name}_{steps}.ckpt").is_file():
        raise AssertionError(f"[{label}] no checkpoint")
    return state, counts, secs, metrics


def boot_line(label, config, cuts, state, counts, secs, metrics, extra=""):
    rates = [v for _, v in metrics["perf/steps_per_sec"]]
    losses = metrics["iter_loss/loss"]
    log(f"[{label}] cli.main --task train --validate-training "
        f"({config.name}, cuts {json.dumps(cuts)}): {state.iteration} steps "
        f"+ validation + checkpoint in {secs:.4f} s (model build, restore "
        f"and loaders included); perf/steps_per_sec (windows of 5): "
        f"{', '.join(f'{r:.2f}' for r in rates)}; loss "
        f"{', '.join(f'{s}: {v:.4f}' for s, v in losses)}; val loss "
        f"{metrics['val/val_loss'][0][1]:.4f}; launches "
        f"{json.dumps(counts, sort_keys=True)}{extra}")


def phase_syn_train() -> str:
    """[syn-train]: 20 steps of magicpoint_syn.yaml at its widths (batch
    32, photometric and homographic augmentation on the card) over
    [syn-gen]'s data, validation and a checkpoint; the loss must fall.
    Returns the checkpoint's path under CKPT_PATH."""
    cuts = dict(SYN_CUTS, **BOOT_TRAIN_CUTS)
    out = boot_train(SYN_CONFIG, cuts, "syn-train")
    losses = out[3]["iter_loss/loss"]
    if not losses[-1][1] < losses[0][1]:
        raise AssertionError(f"[syn-train] the loss did not fall: {losses}")
    boot_line("syn-train", SYN_CONFIG, cuts, *out)
    name = load_config(SYN_CONFIG)["ckpt_name"]
    return f"{name}/{name}_{BOOT_STEPS}.ckpt"


def coco_layout(root: Path) -> None:
    """DATA_PATH/COCO/images/{training,validation}: the fixtures of the
    nine folders that cv2 reads gray (not a colour PFM: the COCO reader
    reads gray, and cv2's gray read of it is None), in turn under distinct
    names, each keeping its suffix (``png_as.jpg`` is a PNG), and one PNG
    more named ``.jpg``; the training split holds every one of them."""
    fixtures = [folder / name for folder in IMAGE_DIRS
                for name, want in sorted(jpeg_digests(folder)[0].items())
                if want is not None]
    fixtures.append(IMAGE_DIRS[1] / "palette.png")
    if len(fixtures) > COCO_IMAGES["training"]:
        raise AssertionError(f"[coco-export] {len(fixtures)} fixtures for "
                             f"{COCO_IMAGES['training']} training images")
    for split, n in COCO_IMAGES.items():
        out = root / "COCO" / "images" / split
        out.mkdir(parents=True)
        for i in range(n):
            j = (i + (split == "validation")) % len(fixtures)
            src = fixtures[j]
            suffix = ".jpg" if j == len(fixtures) - 1 else src.suffix
            shutil.copy(src, out / f"{i:06d}_{src.stem}{suffix}")


def ha_expected(config: dict, n_images: int) -> dict:
    """Launches of one HA export per kernel family (phase_ha_export's
    count: per batch, the warp twice a chunk; with export.serving the int8
    kernels once for the identity view and once a chunk)."""
    ha = config["homography_adaptation"]
    n_chunks = -(-(ha["num"] - 1) // ha["chunk"])
    n_batches = -(-n_images // config["data"]["batch_size"])
    expect = {"warp[bf16]": 2 * n_chunks}
    if (config.get("export") or {}).get("serving"):
        fwd = n_chunks + 1
        expect.update({"conv12_fused": fwd, "double_conv3x3": 3 * fwd,
                       "head": fwd})
    return {k: v * n_batches for k, v in expect.items()}


def phase_coco_export(pretrained: str) -> dict:
    """[coco-export]: ``cli.main --task export_pseudo_labels`` on
    magicpoint_coco_export.yaml at its widths (240 x 320, batch 8, 100
    homographies in chunks of 10) from [syn-train]'s checkpoint over the
    COCO layout: the validation split, then the training split as written
    and with ``export.serving=int8``, the counters at 0 before each;
    labels checked, launches per batch counted. Returns the launches of
    the training-split runs."""
    coco_layout(Path(settings.DATA_PATH))
    base = load_config(COCO_EXPORT)
    all_counts = collections.Counter()
    training_dirs = {}
    for split, serving in (("validation", False), ("training", False),
                           ("training", True)):
        cuts = {"pretrained": pretrained}
        if serving:
            cuts.update({"export.serving": "int8",
                         "data.experiment_name": COCO_INT8_EXPER})
        config = apply_overrides(copy.deepcopy(base),
                                 [f"{k}={json.dumps(v)}"
                                  for k, v in cuts.items()])
        n = COCO_IMAGES[split]
        _build.launch_counts.clear()
        t0 = time.perf_counter()
        out_dir = cli.main(["--config-path", str(COCO_EXPORT), "--task",
                            "export_pseudo_labels", "--split", split,
                            "--device", "cuda"] + set_args(cuts))
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = dict(_build.launch_counts)
        n_pts = check_labels(out_dir, n)
        got = {family: sum(v for k, v in counts.items()
                           if k.startswith(family))
               for family in ha_expected(config, n)}
        if got != ha_expected(config, n):
            raise AssertionError(f"[coco-export] {split} serving={serving}: "
                                 f"launches {got}, expected "
                                 f"{ha_expected(config, n)}")
        if split == "training":
            all_counts.update(counts)
            training_dirs["int8" if serving else "bf16"] = Path(out_dir)
        log(f"[coco-export] cli.main --task export_pseudo_labels --split "
            f"{split} ({COCO_EXPORT.name}, cuts {json.dumps(cuts)}): {n} "
            f"images of the layout (the nine formats) at {HA_SHAPE[0]}x"
            f"{HA_SHAPE[1]}, batch "
            f"{config['data']['batch_size']}, "
            f"{config['homography_adaptation']['num']} views in chunks of "
            f"{config['homography_adaptation']['chunk']}: {secs:.4f} s, "
            f"{n / secs:.2f} images/s (model build and restore included); "
            f"keypoints per image min {min(n_pts)} median "
            f"{statistics.median(n_pts)} max {max(n_pts)}; launches "
            f"{json.dumps(counts, sort_keys=True)}")
    phase_label_tools(training_dirs)
    return dict(all_counts)


def phase_label_tools(dirs: dict) -> None:
    """[label-iou] int8 against bf16, [ha-rate] of both, by the demo's
    tools (host work over the written labels)."""
    t0 = time.perf_counter()
    iou, within2, n = label_iou.agreement(dirs["bf16"], dirs["int8"])
    log(f"[label-iou] int8 labels against bf16 ({n} images of the training "
        f"split): exact IoU {iou:.4f}, within 2 px {within2:.4f}; "
        f"{time.perf_counter() - t0:.3f} s")
    t0 = time.perf_counter()
    for route, out_dir in dirs.items():
        r = ha_rate.rate(out_dir)
        log(f"[ha-rate] {route}: {r['value']:.2f} images/s over the last "
            f"{r['n_measured']} of {r['n_total']} label files' mtimes "
            f"({r['span_s']:.3f} s)")
    log(f"[ha-rate] {time.perf_counter() - t0:.3f} s")


def host_photometric_ms(config: Path) -> float:
    """Median ms of the config's host ``PhotometricAug`` on one 240 x 320
    COCO sample (host clock)."""
    data = load_config(config)["data"]
    aug = photometric.PhotometricAug(data["augmentation"]["photometric"])
    image = coco.COCO(data, "training")[0]["image"][..., 0] * 255.0
    rng = np.random.default_rng(SEED)
    times = []
    for _ in range(PHOTO_REPS):
        t0 = time.perf_counter()
        aug(image, rng)
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


@contextlib.contextmanager
def recorded_batches(out: list):
    """Record the index list of every batch a shuffling (training) loader
    loads, in order."""
    saved = DataLoader._load

    def load(self, batch_idx):
        if self.shuffle:
            out.append([int(i) for i in batch_idx])
        return saved(self, batch_idx)

    DataLoader._load = load
    try:
        yield
    finally:
        DataLoader._load = saved


def worker_runs(config: Path, cuts: dict, label: str, extra: str = "") -> dict:
    """``boot_train`` at each of WORKERS: {workers: {"out": boot_train's
    result, "cuts", "batches": the first BOOT_STEPS training batches'
    indices, "rate": median steps/s}}; the indices must be equal across
    the worker counts."""
    runs = {}
    for workers in WORKERS:
        batches = []
        run_cuts = dict(cuts, **{"data.num_workers": workers,
                                 "ckpt_name": f"{cuts['ckpt_name']}_w"
                                              f"{workers}"})
        with recorded_batches(batches):
            out = boot_train(config, run_cuts, label)
        boot_line(label, config, run_cuts, *out, extra)
        runs[workers] = {
            "out": out, "cuts": run_cuts, "batches": batches[:BOOT_STEPS],
            "rate": statistics.median(v for _, v in
                                      out[3]["perf/steps_per_sec"])}
    indices = [run["batches"] for run in runs.values()]
    if any(i != indices[0] for i in indices) or len(indices[0]) != BOOT_STEPS:
        raise AssertionError(f"[{label}] {config.name}: the training "
                             f"batches differ across data.num_workers "
                             f"{WORKERS}: {indices}")
    return runs


def indices_text(batches: list) -> str:
    flat = json.dumps(batches)
    return (f"sha256 {hashlib.sha256(flat.encode()).hexdigest()[:16]}, "
            f"first {json.dumps(batches[:2])}")


def phase_coco_train(pretrained: str) -> dict:
    """[coco-train]: README step 3, magicpoint_coco_train.yaml for 20 steps
    from [syn-train]'s checkpoint (no kernel of ours) at each of WORKERS;
    step 4, superpoint_coco_train.yaml (240 x 320, batch 2) from the first
    of those runs' checkpoint over [coco-export]'s labels, 20 steps, 2
    validation batches and a checkpoint, with the photometric augmentation
    on the card, and on the host (``on_device=false``) at each of WORKERS;
    rows 10-11 launched once per step (the forward once more per
    validation batch). Returns the launches of the SuperPoint runs."""
    mp_config = CONFIGS / "magicpoint_coco_train.yaml"
    mp_name = load_config(mp_config)["ckpt_name"]
    mp_runs = worker_runs(mp_config, dict(BOOT_TRAIN_CUTS,
                                          pretrained=pretrained,
                                          ckpt_name=mp_name), "coco-train")
    mp_ckpt = mp_runs[WORKERS[0]]["cuts"]["ckpt_name"]
    sp_config = CONFIGS / "superpoint_coco_train.yaml"
    steps, n_val = BOOT_STEPS, BOOT_TRAIN_CUTS["train.val_batches"]
    expect = {"desc_loss[fwd]": steps + n_val, "desc_loss[dA]": steps,
              "desc_loss[dB]": steps}
    all_counts = collections.Counter()

    def check(where, counts):
        got = {k: v for k, v in counts.items() if k.startswith("desc_loss")}
        if got != expect:
            raise AssertionError(f"[coco-train] photometric on the {where}: "
                                 f"launches {got}, expected {expect}")
        all_counts.update(counts)

    sp_cuts = dict(BOOT_TRAIN_CUTS, pretrained=f"{mp_ckpt}/{mp_ckpt}_{steps}"
                   ".ckpt")
    card_cuts = dict(sp_cuts, ckpt_name="superpoint_coco_card")
    card_cuts["data.augmentation.photometric.on_device"] = True
    state, counts, secs, metrics = boot_train(sp_config, card_cuts,
                                              "coco-train")
    check("card", counts)
    card_rate = statistics.median(v for _, v in metrics["perf/steps_per_sec"])
    boot_line("coco-train", sp_config, card_cuts, state, counts, secs,
              metrics)
    host_cuts = dict(sp_cuts, ckpt_name="superpoint_coco_host")
    host_cuts["data.augmentation.photometric.on_device"] = False
    extra = (f"; host PhotometricAug {host_photometric_ms(sp_config):.3f} ms "
             f"per 240x320 image (median of {PHOTO_REPS})")
    host_runs = worker_runs(sp_config, host_cuts, "coco-train", extra)
    for run in host_runs.values():
        check("host", run["out"][1])
    log(f"[coco-train] SuperPoint steps/s (median of the windows): "
        f"photometric on the card {card_rate:.2f}, on the host "
        f"{host_runs[WORKERS[0]]['rate']:.2f}")
    log(f"[coco-train] data.num_workers A/B, steps/s (median of the windows "
        f"of 5): MagicPoint "
        + ", ".join(f"{w} workers {r['rate']:.2f}" for w, r in mp_runs.items())
        + "; SuperPoint photometric on the host "
        + ", ".join(f"{w} workers {r['rate']:.2f}"
                    for w, r in host_runs.items())
        + f"; training batch indices equal across {WORKERS} workers: "
        f"MagicPoint {indices_text(mp_runs[WORKERS[0]]['batches'])}; "
        f"SuperPoint {indices_text(host_runs[WORKERS[0]]['batches'])}")
    return dict(all_counts)


def phase_bootstrap(root: Path):
    """[jpeg] .. [coco-train] under ``root``; returns the launches of the
    COCO export (training split, both routes) and of the SuperPoint runs."""
    saved = (settings.DATA_PATH, settings.CKPT_PATH, settings.EXPER_PATH,
             export.EXPER_PATH)
    settings.DATA_PATH = root / "data"
    settings.CKPT_PATH = root / "ckpt"
    settings.EXPER_PATH = export.EXPER_PATH = root / "exper"
    try:
        phase_jpeg(root)
        phase_process_scene_jpeg(root)
        phase_syn_gen(root / "syn")
        pretrained = phase_syn_train()
        settings.DATA_PATH = root / "coco"
        export_counts = phase_coco_export(pretrained)
        train_counts = phase_coco_train(pretrained)
    finally:
        (settings.DATA_PATH, settings.CKPT_PATH, settings.EXPER_PATH,
         export.EXPER_PATH) = saved
    return export_counts, train_counts
