"""``cv2.imread(path, cv2.IMREAD_GRAYSCALE)`` for the image formats the
port decodes, chosen by the file's suffix: PNG by ``data/png.py``, binary
PGM / PPM by ``data/pnm.py``, JPEG by ``data/jpeg.py``. Any other suffix
raises naming ROADMAP Queue 1 item 7, before the file is opened."""

from __future__ import annotations

from pathlib import Path

import numpy as np

from spnerf_tpu_torch.data import jpeg, png, pnm

READERS = {".png": png.read_gray, ".pgm": pnm.read_gray,
           ".ppm": pnm.read_gray, ".pnm": pnm.read_gray,
           **{suffix: jpeg.read_gray for suffix in jpeg.SUFFIXES}}


def gray_reader(path):
    """The gray reader of ``path``'s format (the file need not exist)."""
    path = Path(path)
    reader = READERS.get(path.suffix.lower())
    if reader is None:
        raise NotImplementedError(
            f"{path}: {path.suffix or 'this'} decoding is not ported yet "
            "(ROADMAP Queue 1 item 7, image formats beyond 8-bit PNG, PNM "
            "and gray sequential JPEG)")
    return reader


def read_gray(path) -> np.ndarray:
    """(H, W) uint8 gray image of a PNG, PGM / PPM or JPEG file."""
    return gray_reader(path)(path)
