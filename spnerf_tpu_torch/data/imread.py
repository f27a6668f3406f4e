"""``cv2.imread`` for the image formats the port decodes, chosen by the
file's suffix: ``read_gray`` is ``cv2.imread(path, IMREAD_GRAYSCALE)``,
``read_rgb`` is ``cv2.imread(path)[..., ::-1]``. PNG goes through
``data/png.py``, binary PGM / PPM through ``data/pnm.py``, JPEG through
``data/jpeg.py``. Any other suffix raises naming ROADMAP Queue 1 item 7,
before the file is opened."""

from __future__ import annotations

from pathlib import Path

import numpy as np

from spnerf_tpu_torch.data import jpeg, png, pnm

_PNM = (".pgm", ".ppm", ".pnm")
READERS = {".png": png.read_gray, **{s: pnm.read_gray for s in _PNM},
           **{suffix: jpeg.read_gray for suffix in jpeg.SUFFIXES}}
RGB_READERS = {".png": png.read_rgb, **{s: pnm.read_rgb for s in _PNM},
               **{suffix: jpeg.read_rgb for suffix in jpeg.SUFFIXES}}


def _reader(path, readers: dict):
    path = Path(path)
    reader = readers.get(path.suffix.lower())
    if reader is None:
        raise NotImplementedError(
            f"{path}: {path.suffix or 'this'} decoding is not ported yet "
            "(ROADMAP Queue 1 item 7, image formats beyond 8-bit PNG, PNM "
            "and JPEG)")
    return reader


def gray_reader(path):
    """The gray reader of ``path``'s format (the file need not exist)."""
    return _reader(path, READERS)


def read_gray(path) -> np.ndarray:
    """(H, W) uint8 gray image of a PNG, PGM / PPM or JPEG file."""
    return gray_reader(path)(path)


def read_rgb(path) -> np.ndarray:
    """(H, W, 3) uint8 R, G, B image of a PNG, PGM / PPM or JPEG file."""
    return _reader(path, RGB_READERS)(path)
