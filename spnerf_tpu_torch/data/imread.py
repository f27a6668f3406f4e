"""``cv2.imread`` for the image formats the port decodes, chosen as cv2
chooses its decoder: by the signature at the start of the file
(``data/signature.py``, OpenCV's ``findDecoder``), not by its name.
``read_gray`` is ``cv2.imread(path, IMREAD_GRAYSCALE)``, ``read_rgb``
``cv2.imread(path)[..., ::-1]``. JPEG goes through ``data/jpeg.py``, PNG
through ``data/png.py``, PBM / PGM / PPM through ``data/pnm.py``, and
OpenCV's own six decoders through their copies: BMP (``data/bmp.py``),
Sun raster (``sunras.py``), PAM (``pam.py``), PFM (``pfm.py``), Radiance
HDR (``hdr.py``) and GIF (``gif.py``).

A missing file raises ``FileNotFoundError``. A file that no cv2 decoder
claims, or one of a claimed format that cv2 refuses too, raises
``signature.Unreadable`` (a ``ValueError``): ``cv2.imread`` returns None
for it. A format cv2 decodes through a library of its own and the port
does not (TIFF, WebP, JPEG 2000, AVIF) raises ``signature.NotPorted`` (a
``NotImplementedError``) naming ROADMAP Queue 1 item 7.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from spnerf_tpu_torch.data import (bmp, gif, hdr, jpeg, pam, pfm, png, pnm,
                                   signature, sunras)
from spnerf_tpu_torch.data.signature import NotPorted, Unreadable

_READERS = {"png": png, "pnm": pnm, "bmp": bmp, "sunras": sunras,
            "pam": pam, "pfm": pfm, "hdr": hdr, "gif": gif}
_GRAY = dict({kind: module.decode_gray for kind, module in _READERS.items()},
             jpeg=jpeg.decode_gray)
_RGB = dict({kind: module.decode_rgb for kind, module in _READERS.items()},
            jpeg=lambda data, name: np.ascontiguousarray(
                jpeg.decode_bgr(data, name)[..., ::-1]))


def format_of(data: bytes, name: str = "<bytes>") -> str:
    """The ported format of a file's bytes (one of ``signature.PORTED``),
    by its signature; raises ``Unreadable`` where no cv2 decoder claims
    them and ``NotPorted`` for a format only cv2 reads."""
    kind = signature.kind(data[:signature.HEAD])
    if kind is None:
        raise Unreadable(f"{name}: no image decoder claims its first bytes "
                         f"{data[:8]!r}; cv2.imread does not read it either")
    if kind not in signature.PORTED:
        raise NotPorted(f"{name}: {kind} decoding is not ported yet (ROADMAP "
                        "Queue 1 item 7: cv2.imread's formats read through "
                        "libraries of their own, TIFF, WebP, JPEG 2000 and "
                        "AVIF)")
    return kind


def read_gray(path) -> np.ndarray:
    """(H, W) uint8: ``cv2.imread(path, IMREAD_GRAYSCALE)`` of a file of
    any ported format, whatever its name."""
    data = Path(path).read_bytes()
    return _GRAY[format_of(data, str(path))](data, str(path))


def read_rgb(path) -> np.ndarray:
    """(H, W, 3) uint8 R, G, B: ``cv2.imread(path)[..., ::-1]`` of a file
    of any ported format, whatever its name."""
    data = Path(path).read_bytes()
    return _RGB[format_of(data, str(path))](data, str(path))

