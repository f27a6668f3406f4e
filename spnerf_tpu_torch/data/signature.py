"""Which decoder ``cv2.imread`` picks for a file: OpenCV's ``findDecoder``
(``imgcodecs/src/loadsave.cpp``) reads the file's first bytes and asks
each codec in turn whether its signature is there; the name plays no
part. ``kind`` returns the format a signature names, from the codecs of
OpenCV 5.0's build (JPEG, PNG, the PNM family, BMP, TIFF, WebP, JPEG
2000, AVIF, GIF, HDR, PFM, PAM, Sun raster), or None where no codec
claims the bytes, for which ``cv2.imread`` returns None.

``PORTED`` names the formats the port decodes (``data/imread.py``): all
of them but TIFF, WebP, JPEG 2000 and AVIF, which cv2 reads through
libraries of their own. ``Unreadable`` is the ``ValueError`` the port's
readers raise for a file ``cv2.imread`` returns None for too;
``NotPorted`` the ``NotImplementedError`` for a format cv2 decodes and
the port does not (ROADMAP Queue 1 item 7).
"""

from __future__ import annotations

# the longest signature read (OpenCV reads as many bytes as its longest
# one; WebP's check is the longest of these)
HEAD = 32
PORTED = ("jpeg", "png", "pnm", "bmp", "sunras", "pam", "pfm", "hdr", "gif")
_WHITESPACE = b" \t\n\v\f\r"


class Unreadable(ValueError):
    """A file the port refuses and ``cv2.imread`` returns None for."""


class NotPorted(NotImplementedError):
    """A format ``cv2.imread`` decodes that the port does not."""


def _pnm_family(head: bytes, digits: bytes) -> bool:
    return (len(head) >= 3 and head[0:1] == b"P" and head[1:2] != b""
            and head[1:2] in [bytes([d]) for d in digits]
            and head[2:3] in [bytes([c]) for c in _WHITESPACE])


def _avif(head: bytes) -> bool:
    return head[4:8] == b"ftyp" and head[8:12] in (b"avif", b"avis")


# (format, test) in the order OpenCV registers its decoders
_SIGNATURES = (
    ("bmp", lambda h: h[:2] == b"BM"),
    ("hdr", lambda h: h.startswith((b"#?RGBE", b"#?RADIANCE"))),
    ("jpeg", lambda h: h[:3] == b"\xff\xd8\xff"),
    ("webp", lambda h: h[:4] == b"RIFF" and h[8:12] == b"WEBP"),
    ("sunras", lambda h: h[:4] == b"\x59\xa6\x6a\x95"),
    ("pnm", lambda h: _pnm_family(h, b"123456")),
    ("pfm", lambda h: _pnm_family(h, b"fF")),
    ("tiff", lambda h: h[:4] in (b"II*\0", b"MM\0*", b"II+\0", b"MM\0+")),
    ("png", lambda h: h[:8] == b"\x89PNG\r\n\x1a\n"),
    ("jpeg2000", lambda h: h[:12] == b"\0\0\0\x0cjP  \r\n\x87\n"
     or h[:4] == b"\xff\x4f\xff\x51"),
    ("pam", lambda h: _pnm_family(h, b"7")),
    ("avif", _avif),
    ("gif", lambda h: h[:6] in (b"GIF87a", b"GIF89a")),
)


def kind(head: bytes) -> str | None:
    """The format whose signature ``head`` (a file's first bytes) starts
    with, as cv2's ``findDecoder`` decides it; None where none does."""
    for name, test in _SIGNATURES:
        if test(head):
            return name
    return None
