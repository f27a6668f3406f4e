"""PAM (``P7``) reading as ``cv2.imread`` does it (OpenCV's
``grfmt_pam.cpp``, kept apart from the PBM / PGM / PPM reader as OpenCV
keeps it), on numpy.

The header: ``P7`` and a line break (``\\n`` or ``\\r``), then lines
``WIDTH``, ``HEIGHT``, ``DEPTH``, ``MAXVAL`` (each once; ``-`` and
decimal digits only, below 2**31 - 1), ``TUPLTYPE`` (``BLACKANDWHITE``,
``GRAYSCALE``, ``GRAYSCALE_ALPHA``, ``RGB``, ``RGB_ALPHA``, or nothing;
the last one counts), ``#`` comments and ``ENDHDR``, as OpenCV's
``ReadPAMHeaderLine`` reads them: whitespace before an identifier is
skipped, line breaks included, and where a space follows ``ENDHDR`` the
rest of its line is taken as a value and the samples start after the
next line break. With no ``TUPLTYPE``, DEPTH 1 is gray (maxval 1 black
and white) and DEPTH 3 RGB up to maxval 255; anything else is refused,
as is a ``TUPLTYPE`` whose DEPTH is not its own.

The samples, in OpenCV's order:

- maxval 1: every row's first bytes as packed bits, most significant
  first, a set bit 255 (its ``FillGrayRow1``), whatever the DEPTH;
- maxval above 255: big-endian 16-bit samples, their high byte kept;
- a read of as many channels as the file has: the samples as stored, so
  a colour read of an RGB file keeps R, G, B where cv2's B, G, R go (the
  port's R, G, B hold the file's B, G, R);
- a gray read of RGB: the fixed-point colour-to-gray step with R first;
- the other cases (``basic_conversion``): OpenCV walks a row's samples
  by DEPTH but stops after WIDTH samples, so only the first
  ceil(WIDTH / DEPTH) pixels are converted, three bytes each (a gray
  one too, written three times). A gray read of gray + alpha is whole
  (each of the first half's pixels three times over); the bytes cv2
  never writes (a colour read of gray + alpha or RGB + alpha, a gray
  read of RGB + alpha at most widths) are the heap's contents there,
  which the port cannot know: it leaves them 0 (ROADMAP Queue 3).

A file cut short or with a bad header raises ``signature.Unreadable``:
``cv2.imread`` returns None for it (or raises, for a size out of its
limits).
"""

from __future__ import annotations

import numpy as np

from spnerf_tpu_torch.data import cv_codec

_SPACE = b" \t\n\v\f\r"
_FIELDS = ("ENDHDR", "HEIGHT", "WIDTH", "DEPTH", "MAXVAL", "TUPLTYPE")
# TUPLTYPE -> (DEPTH it needs, (red, green, blue) channels of its layout)
_FORMATS = {b"BLACKANDWHITE": (1, (0, 0, 0)), b"GRAYSCALE": (1, (0, 0, 0)),
            b"GRAYSCALE_ALPHA": (2, (0, 0, 0)), b"RGB": (3, (0, 1, 2)),
            b"RGB_ALPHA": (4, (0, 1, 2))}


class _Cut(Exception):
    pass


class _Stream:
    def __init__(self, data: bytes, pos: int):
        self.data, self.pos = data, pos

    def byte(self) -> int:
        if self.pos >= len(self.data):
            raise _Cut
        self.pos += 1
        return self.data[self.pos - 1]


def _line(s: _Stream):
    """OpenCV's ReadPAMHeaderLine: (identifier or None for a comment,
    value); None for a line it refuses."""
    code = s.byte()
    while code in _SPACE:
        code = s.byte()
    if code == 0x23:  # '#'
        while code not in (0x0A, 0x0D):
            code = s.byte()
        return "#", b""
    ident = bytearray()
    for _ in range(8):
        if code in _SPACE:
            break
        ident.append(code)
        code = s.byte()
    if code not in _SPACE:
        return None
    ident = bytes(ident).split(b"\0")[0].decode("latin-1")
    if ident not in _FIELDS:
        return None
    if code in (0x0A, 0x0D):
        return ident, b""
    code = s.byte()
    while code in _SPACE:
        code = s.byte()
    value = bytearray()
    for _ in range(255):
        if code in (0x0A, 0x0D):
            break
        value.append(code)
        code = s.byte()
    if code not in (0x0A, 0x0D):
        return None
    return ident, bytes(value).rstrip(_SPACE).split(b"\0")[0]


def _number(value: bytes):
    """OpenCV's ParseInt: an optional '-', digits below INT_MAX, nothing
    after them; None where it asserts."""
    pos, negative = 0, value[:1] == b"-"
    if negative:
        pos = 1
        if not value[1:2].isdigit():
            return None
    number = 0
    while pos < len(value) and 0x30 <= value[pos] <= 0x39:
        number = number * 10 + value[pos] - 0x30
        if number >= 2**31 - 1:
            return None
        pos += 1
    if pos < len(value):
        return None
    return -number if negative else number


def _header(data: bytes, name: str):
    """(width, height, depth, maxval, TUPLTYPE, offset of the samples)."""
    if len(data) < 3 or data[:2] != b"P7" or data[2] not in (0x0A, 0x0D):
        raise cv_codec.refuse("pam", name, "not a PAM header")
    s = _Stream(data, 3)
    fields, tupltype = {}, None
    try:
        while True:
            line = _line(s)
            if line is None:
                raise cv_codec.refuse("pam", name, "a header line it "
                                      "refuses")
            ident, value = line
            if ident == "ENDHDR":
                break
            if ident == "TUPLTYPE":
                if value and value not in _FORMATS:
                    raise cv_codec.refuse("pam", name, f"TUPLTYPE {value!r}")
                tupltype = value or None
            elif ident != "#":
                number = _number(value)
                if ident in fields or number is None:
                    raise cv_codec.refuse("pam", name, f"bad {ident}")
                if ident == "MAXVAL" and number > 65535:
                    raise cv_codec.refuse("pam", name, f"MAXVAL {number}")
                fields[ident] = number
    except _Cut:
        raise cv_codec.refuse("pam", name, "the header is cut") from None
    if len(fields) != 4:
        raise cv_codec.refuse("pam", name, "a field is missing")
    depth, maxval = fields["DEPTH"], fields["MAXVAL"]
    if tupltype is None:
        if depth == 1:
            tupltype = b"BLACKANDWHITE" if maxval == 1 else (
                b"GRAYSCALE" if maxval < 256 else None)
        elif depth == 3 and maxval < 256:
            tupltype = b"RGB"
        if tupltype is None:
            raise cv_codec.refuse("pam", name, f"DEPTH {depth} at MAXVAL "
                                  f"{maxval} with no TUPLTYPE")
    if _FORMATS[tupltype][0] != depth:
        raise cv_codec.refuse("pam", name, f"{tupltype.decode()} with DEPTH "
                              f"{depth}")
    return (fields["WIDTH"], fields["HEIGHT"], depth, maxval, tupltype,
            s.pos)


def _decode(data: bytes, name: str, target: int) -> np.ndarray:
    """(H, W, target) uint8 in cv2's channel order (B, G, R for a colour
    read)."""
    width, height, depth, maxval, tupltype, pos = _header(data, name)
    cv_codec.check_size("pam", name, width, height)
    wide = maxval > 255
    stride = width * depth * (2 if wide else 1)
    if len(data) - pos < stride * height:
        raise cv_codec.refuse("pam", name, "the samples are cut")
    raw = np.frombuffer(data, np.uint8, stride * height, pos) \
        .reshape(height, stride)
    if maxval == 1:
        bits = np.unpackbits(raw[:, :(width + 7) // 8], axis=1)[:, :width]
        gray = np.where(bits != 0, 255, 0).astype(np.uint8)
        return np.repeat(gray[..., None], target, axis=2)
    samples = raw[:, 0::2] if wide else raw  # (H, W * DEPTH)
    if target == depth:
        return samples.reshape(height, width, depth).copy()
    if target == 1 and depth == 3:
        return cv_codec.gray(samples.reshape(height, width, 3)[..., ::-1]
                             )[..., None]
    # basic_conversion: ceil(W / DEPTH) pixels, 3 bytes each, from the
    # row's start
    red, green, blue = _FORMATS[tupltype][1]
    starts = np.arange(0, width, depth)
    if target == 3:
        picks = np.stack([starts + blue, starts + green, starts + red], 1)
    else:
        picks = np.stack([starts] * 3, 1)
    written = samples[:, picks.reshape(-1)]
    row = np.zeros((height, width * target), np.uint8)
    n = min(written.shape[1], width * target)
    row[:, :n] = written[:, :n]
    return row.reshape(height, width, target)


def decode_gray(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """(H, W) uint8: ``cv2.imdecode(data, IMREAD_GRAYSCALE)``."""
    return np.ascontiguousarray(_decode(data, name, 1)[..., 0])


def decode_rgb(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """(H, W, 3) uint8: ``cv2.imdecode(data)[..., ::-1]``."""
    return np.ascontiguousarray(_decode(data, name, 3)[..., ::-1])
