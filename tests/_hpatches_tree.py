"""A small HPatches-layout tree shared by the port's dataset, evaluation
and CLI tests: three sequences of six 8-bit PPM images (RGB) with their
H_1_i files, at odd source sizes.

- ``i_blocks`` (90 x 119) and ``i_bars`` (75 x 97): illumination, the
  identity with other gains and offsets per channel;
- ``v_shift`` (97 x 131): viewpoint, integer shifts of a larger scene
  (its H_1_i the translations).
"""

from pathlib import Path

import numpy as np

SEQUENCES = {"i_blocks": (90, 119), "i_bars": (75, 97), "v_shift": (97, 131)}
NAMES = {"i": [f"{s}_1_{i}" for s in ("i_bars", "i_blocks")
               for i in range(2, 7)],
         "v": [f"v_shift_1_{i}" for i in range(2, 7)]}


def _scene(rng, shape):
    """Blocks of seeded gray levels with a bright and a dark rectangle:
    corners for the detector at every scale."""
    h, w = shape
    cells = rng.uniform(30, 220, (h // 9 + 1, w // 9 + 1))
    img = np.repeat(np.repeat(cells, 9, 0), 9, 1)[:h, :w]
    img[h // 4:h // 2, w // 5:w // 2] = 250
    img[h // 2:3 * h // 4, w // 2:4 * w // 5] = 10
    return img


def _rgb(gray, rng):
    tint = rng.uniform(-25, 25, 3)
    return np.clip(gray[..., None] + tint, 0, 255).astype(np.uint8)


def write_tree(data_path: Path, write) -> Path:
    """Write the sequences under ``data_path``/HPatches with ``write(path,
    (H, W, 3) uint8 RGB)``; returns the HPatches directory."""
    root = Path(data_path) / "HPatches"
    rng = np.random.default_rng(7)
    for name, shape in SEQUENCES.items():
        folder = root / name
        folder.mkdir(parents=True)
        if name.startswith("i"):
            base = _scene(rng, shape)
            for i in range(1, 7):
                gain, offset = rng.uniform(0.7, 1.2), rng.uniform(-20, 20)
                write(folder / f"{i}.ppm", _rgb(base * gain + offset, rng))
                if i > 1:
                    np.savetxt(folder / f"H_1_{i}", np.eye(3))
        else:
            h, w = shape
            big = _scene(rng, (h + 20, w + 20))
            for i in range(1, 7):
                dy, dx = (0, 0) if i == 1 else rng.integers(-6, 7, 2)
                crop = big[10 + dy:10 + dy + h, 10 + dx:10 + dx + w]
                write(folder / f"{i}.ppm", _rgb(crop, rng))
                if i > 1:
                    # a point (x, y) of image 1 lies at (x - dx, y - dy)
                    np.savetxt(folder / f"H_1_{i}", np.array(
                        [[1, 0, -dx], [0, 1, -dy], [0, 0, 1]], np.float64))
    return root
