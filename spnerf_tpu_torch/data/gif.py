"""GIF reading as ``cv2.imread`` does it (OpenCV's own ``grfmt_gif.cpp``,
no giflib), with the LZW codes decoded in the port's own C++
(``native/gif_lzw.cpp``, built by g++ at first use).

OpenCV first walks the whole file to its trailer (``;``), counting the
frames: a block it does not know, a cut file or no trailer is refused.
Then it reads the first frame:

- the Graphic Control Extensions before it set its transparency (the
  last one counts; a block size other than 4, or a disposal method past
  3, is refused);
- the frame must lie inside the logical screen; its indices are
  deinterlaced where it is interlaced, and the codes must fill it
  exactly, as OpenCV's ``lzwDecode`` counts them (``native/gif_lzw.cpp``
  states its rules: codes after an end-of-information code go on as a
  fresh stream, a code after a full frame is allowed only as the last of
  the image data);
- LZW minimum code sizes 2 to 11 are read (an index keeps its low byte);
- the frame is drawn on a canvas of the global table's background colour
  (black where there is no global table; a background index past the
  table is refused): a transparent index leaves the canvas, any other
  takes its colour from the local table, then the global one; an index
  past both is refused. With no table at all OpenCV's default one gives
  index i the gray i, and index 1 white.

A colour read gives the canvas; a gray read converts it with
``cvtColor``'s 15-bit fixed point (``cv_codec.gray15``). What OpenCV
refuses raises ``signature.Unreadable``: ``cv2.imread`` returns None.
"""

from __future__ import annotations

import ctypes

import numpy as np

from spnerf_tpu_torch.data import cv_codec
from spnerf_tpu_torch.utils import native

_DEFAULT_TABLE = np.repeat(np.arange(256, dtype=np.uint8)[:, None], 3, 1)
_DEFAULT_TABLE[1] = 255


class _Cut(Exception):
    pass


class _Stream:
    def __init__(self, data: bytes, pos: int):
        self.data, self.pos = data, pos

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise _Cut
        self.pos += n
        return self.data[self.pos - n:self.pos]

    def byte(self) -> int:
        return self.take(1)[0]

    def word(self) -> int:
        return int.from_bytes(self.take(2), "little")

    def blocks(self) -> bytes:
        """The data sub-blocks up to their terminator, joined."""
        out = []
        size = self.byte()
        while size:
            out.append(self.take(size))
            size = self.byte()
        return b"".join(out)

    def table(self, flags: int) -> np.ndarray:
        n = 2 << (flags & 7)
        return np.frombuffer(self.take(3 * n), np.uint8).reshape(n, 3)


def _application(s: _Stream) -> None:
    """An application extension's sub-blocks as getFrameCount_ reads them:
    an 11-byte one names the application; a 3-byte one is NETSCAPE2.0's
    loop count, and after any other name OpenCV reads two of its bytes
    and takes the third for the next sub-block's length."""
    netscape = False
    size = s.byte()
    while size:
        if size == 11:
            netscape = s.take(11) == b"NETSCAPE2.0"
        else:
            s.take(size if size != 3 or netscape else 2)
        size = s.byte()


def _walk(s: _Stream) -> None:
    """OpenCV's getFrameCount_: walk the blocks to the trailer."""
    kind = s.byte()
    while kind != 0x3B:
        if kind == 0x21:
            if s.byte() == 0xFF:
                _application(s)
            else:
                s.blocks()
        elif kind == 0x2C:
            s.take(8)
            flags = s.byte()
            if flags & 0x80:
                s.table(flags)
            s.take(1)
            s.blocks()
        else:
            raise ValueError(f"block 0x{kind:02x}")
        kind = s.byte()


def _deinterlace(rows: np.ndarray) -> np.ndarray:
    order = np.concatenate([np.arange(start, len(rows), step) for start, step
                            in ((0, 8), (4, 8), (2, 4), (1, 2))])
    out = np.empty_like(rows)
    out[order] = rows
    return out


def _decode(data: bytes, name: str) -> np.ndarray:
    """(H, W, 3) uint8 B, G, R of the first frame on its canvas."""
    if data[:6] not in (b"GIF87a", b"GIF89a"):
        raise cv_codec.refuse("gif", name, "not a GIF file")
    try:
        return _first_frame(data, name)
    except _Cut:
        raise cv_codec.refuse("gif", name, "the file is cut") from None


def _first_frame(data: bytes, name: str) -> np.ndarray:
    s = _Stream(data, 6)
    width, height = s.word(), s.word()
    if not (width > 0 and height > 0):
        raise cv_codec.refuse("gif", name, f"screen {width} x {height}")
    flags, background = s.byte(), s.byte()
    s.take(1)
    global_table = s.table(flags) if flags & 0x80 else None
    if global_table is not None and background >= len(global_table):
        raise cv_codec.refuse("gif", name, f"background {background} past "
                              "the global table")
    try:
        _walk(_Stream(data, s.pos))
    except ValueError as err:
        raise cv_codec.refuse("gif", name, f"an unknown {err}") from None
    cv_codec.check_size("gif", name, width, height)
    transparent, disposal = None, 0
    kind = s.byte()
    while kind == 0x21:
        if s.byte() == 0xF9:
            if s.byte() != 4:
                raise cv_codec.refuse("gif", name, "a Graphic Control "
                                      "Extension of another size than 4")
            packed = s.byte()
            s.word()
            index = s.byte()
            disposal = (packed >> 2) & 7
            transparent = index if packed & 1 else None
        s.blocks()
        kind = s.byte()
    if kind != 0x2C:
        raise cv_codec.refuse("gif", name, "no image")
    left, top, w, h = s.word(), s.word(), s.word(), s.word()
    if not (w > 0 and h > 0 and left + w <= width and top + h <= height):
        raise cv_codec.refuse("gif", name, "a frame outside the screen")
    if disposal > 3:
        raise cv_codec.refuse("gif", name, f"disposal method {disposal}")
    image_flags = s.byte()
    local_table = s.table(image_flags) if image_flags & 0x80 else None
    min_size = s.byte()
    if not 2 <= min_size <= 11:
        raise cv_codec.refuse("gif", name, f"LZW minimum code size "
                              f"{min_size}")
    start = s.pos
    s.blocks()
    fn = native.load("gif_lzw").gif_lzw
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_int64]
    index = np.empty(w * h, np.uint8)
    ok = fn(data[start:], len(data) - start, min_size, index.ctypes.data,
            w * h)
    if ok != 1:
        raise cv_codec.refuse("gif", name, "image data OpenCV's LZW decoder "
                              "refuses")
    index = index.reshape(h, w)
    if image_flags & 0x40:
        index = _deinterlace(index)
    if local_table is not None:
        table = local_table
        if global_table is not None and len(global_table) > len(table):
            table = np.concatenate([table, global_table[len(table):]])
    else:
        table = global_table if global_table is not None else _DEFAULT_TABLE
    # the canvas as OpenCV's BGRA image, a pixel a 4-byte word
    lut = np.zeros((256, 4), np.uint8)
    lut[:len(table), :3] = table[:, ::-1]
    lut = lut.view(np.uint32)[:, 0]
    canvas = np.zeros((height, width), np.uint32)
    if global_table is not None:
        fill = np.zeros(4, np.uint8)
        fill[:3] = global_table[background, ::-1]
        canvas[:] = fill.view(np.uint32)[0]
    patch = canvas[top:top + h, left:left + w]
    past = index >= len(table)
    if transparent is None:
        if past.any():
            raise cv_codec.refuse("gif", name, "an index past the colour "
                                  "tables")
        patch[:] = np.take(lut, index)
    else:
        shown = index != transparent
        if (past & shown).any():
            raise cv_codec.refuse("gif", name, "an index past the colour "
                                  "tables")
        patch[:] = np.where(shown, np.take(lut, index), patch)
    return canvas.view(np.uint8).reshape(height, width, 4)[..., :3]


def decode_gray(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """(H, W) uint8: ``cv2.imdecode(data, IMREAD_GRAYSCALE)``."""
    return cv_codec.gray15(_decode(data, name))


def decode_rgb(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """(H, W, 3) uint8 R, G, B: ``cv2.imdecode(data)[..., ::-1]``."""
    return np.ascontiguousarray(_decode(data, name)[..., ::-1])
