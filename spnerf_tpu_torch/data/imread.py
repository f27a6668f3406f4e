"""``cv2.imread`` for the image formats the port decodes, chosen as cv2
chooses its decoder: by the signature at the start of the file
(``data/signature.py``, OpenCV's ``findDecoder``), not by its name.
``read_gray`` is ``cv2.imread(path, IMREAD_GRAYSCALE)``, ``read_rgb``
``cv2.imread(path)[..., ::-1]``. JPEG goes through ``data/jpeg.py``, PNG
through ``data/png.py``, PBM / PGM / PPM through ``data/pnm.py``.

A missing file raises ``FileNotFoundError``. A file that no cv2 decoder
claims, or one of a claimed format that cv2 refuses too, raises
``signature.Unreadable`` (a ``ValueError``): ``cv2.imread`` returns None
for it. A format cv2 decodes and the port does not (BMP, TIFF, WebP,
JPEG 2000, AVIF, GIF, HDR, PFM, PAM, Sun raster) raises
``signature.NotPorted`` (a ``NotImplementedError``) naming ROADMAP Queue
1 item 7.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from spnerf_tpu_torch.data import jpeg, png, pnm, signature
from spnerf_tpu_torch.data.signature import NotPorted, Unreadable

_GRAY = {"jpeg": jpeg.decode_gray, "png": png.decode_gray,
         "pnm": pnm.decode_gray}
_RGB = {"jpeg": lambda data, name: np.ascontiguousarray(
            jpeg.decode_bgr(data, name)[..., ::-1]),
        "png": png.decode_rgb, "pnm": pnm.decode_rgb}


def format_of(data: bytes, name: str = "<bytes>") -> str:
    """The ported format of a file's bytes (``"jpeg"``, ``"png"`` or
    ``"pnm"``), by its signature; raises ``Unreadable`` where no cv2
    decoder claims them and ``NotPorted`` for a format only cv2 reads."""
    kind = signature.kind(data[:signature.HEAD])
    if kind is None:
        raise Unreadable(f"{name}: no image decoder claims its first bytes "
                         f"{data[:8]!r}; cv2.imread does not read it either")
    if kind not in signature.PORTED:
        raise NotPorted(f"{name}: {kind} decoding is not ported yet (ROADMAP "
                        "Queue 1 item 7: cv2.imread's formats beyond JPEG, "
                        "PNG and PBM / PGM / PPM)")
    return kind


def read_gray(path) -> np.ndarray:
    """(H, W) uint8: ``cv2.imread(path, IMREAD_GRAYSCALE)`` of a JPEG, PNG
    or PBM / PGM / PPM file, whatever its name."""
    data = Path(path).read_bytes()
    return _GRAY[format_of(data, str(path))](data, str(path))


def read_rgb(path) -> np.ndarray:
    """(H, W, 3) uint8 R, G, B: ``cv2.imread(path)[..., ::-1]`` of a JPEG,
    PNG or PBM / PGM / PPM file, whatever its name."""
    data = Path(path).read_bytes()
    return _RGB[format_of(data, str(path))](data, str(path))

