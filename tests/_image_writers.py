"""Test-only writers of the files OpenCV's own decoders read and no encoder
on the test host writes in every variant: BMP (every info header, 1-32
bits, ``BI_BITFIELDS``, ``BI_RLE8`` / ``BI_RLE4`` with their escapes,
OS/2, top-down), Sun raster (colour maps, 1-32 bits), PAM (any DEPTH,
MAXVAL and TUPLTYPE), PFM, Radiance HDR (flat and run-length scanlines)
and GIF (the LZW coder of the GIF89a specification, appendix F, with
clear codes where the caller asks; global and local tables, interlaced
frames, Graphic Control Extensions, animations).

``cv2.imread`` decides whether a written file is right: the tests hold
the port to cv2 on the bytes, whatever they are. The port never imports
this module.
"""

from __future__ import annotations

import struct

import numpy as np

# --------------------------------------------------------------------- BMP


def bmp(width: int, height: int, bits: int, pixels: bytes,
        compression: int = 0, palette: bytes = b"", header_size: int = 40,
        colours: int = 0, header_extra: bytes = b"", after_header: bytes = b"",
        offset: int = None) -> bytes:
    """A BMP file: the 14-byte file header, an info header of
    ``header_size`` bytes (40 and more: Windows; 12: OS/2, 16-bit sizes),
    ``header_extra`` written from byte 40 of it (a V4 / V5 header's
    masks), then ``after_header`` (masks OpenCV reads after the header),
    the palette and the pixels."""
    if header_size == 12:
        info = struct.pack("<IHHHH", 12, width, height, 1, bits)
    else:
        info = struct.pack("<IiiHHIIiiII", header_size, width, height, 1,
                           bits, compression, len(pixels), 2835, 2835,
                           colours, 0) + header_extra
        info = info.ljust(header_size, b"\0")
    start = 14 + len(info) + len(after_header) + len(palette)
    head = b"BM" + struct.pack("<IHHi", start + len(pixels), 0, 0,
                               start if offset is None else offset)
    return head + info + after_header + palette + pixels


def bmp_rows(rows: np.ndarray, bits: int) -> bytes:
    """(H, W) indices or (H, W * bytes) samples, top row first, packed at
    ``bits`` and padded to 4 bytes, bottom row first as BMP stores them."""
    out = b""
    for row in rows[::-1]:
        if bits < 8:
            data = np.packbits(np.unpackbits(
                row.astype(np.uint8)[:, None], axis=1)[:, 8 - bits:])
        else:
            data = row.astype(np.uint8)
        data = data.tobytes()
        out += data + b"\0" * (-len(data) % 4)
    return out


def palette(colours: np.ndarray, entry: int = 4) -> bytes:
    """(N, 3) R, G, B colours as BMP palette entries (B, G, R[, 0])."""
    bgr = np.asarray(colours, np.uint8)[:, ::-1]
    if entry == 4:
        bgr = np.concatenate([bgr, np.zeros((len(bgr), 1), np.uint8)], 1)
    return bgr.tobytes()


def rle(indices: np.ndarray, bits: int, rng, escapes: bool = True) -> bytes:
    """``BI_RLE8`` (bits 8) or ``BI_RLE4`` (bits 4) of (H, W) indices, top
    row first: runs, literal runs and, where ``escapes``, deltas and an
    early end of bitmap (the pixels they skip are OpenCV's palette entry
    0; OpenCV ends only the row at an RLE4 end of bitmap, so an RLE4 file
    with one is cut for it)."""
    height, width = indices.shape
    out = b""
    for y in range(height - 1, -1, -1):
        row, x = indices[y], 0
        while x < width:
            r = rng.random()
            if r < 0.45:
                n = int(rng.integers(1, min(width - x, 255) + 1))
                value = (int(row[x]) if bits == 8 else
                         (int(row[x]) << 4) | int(row[min(x + 1, width - 1)]))
                out += bytes([n, value])
                x += n
            elif r < 0.9 and width - x >= 3:
                n = int(rng.integers(3, min(width - x, 255) + 1))
                if bits == 8:
                    data = bytes(row[x:x + n].astype(np.uint8))
                else:
                    nib = list(row[x:x + n]) + [0]
                    data = bytes((int(nib[i]) << 4) | int(nib[i + 1])
                                 for i in range(0, n, 2))
                out += bytes([0, n]) + data + b"\0" * (len(data) % 2)
                x += n
            elif escapes and r < 0.95:
                dx = int(rng.integers(0, width - x + 1))
                out += bytes([0, 2, dx, 0])
                x += dx
            else:
                break
        out += b"\0\0"
        if escapes and y > 0 and rng.random() < 0.05:
            return out[:-2] + b"\0\1"
    return out + b"\0\1"

# -------------------------------------------------------------- Sun raster


def sunras(width: int, height: int, depth: int, pixels: bytes,
           kind: int = 1, colour_map: bytes = b"", map_type: int = None
           ) -> bytes:
    """A Sun raster file: the 32-byte big-endian header, the colour map
    (R, G, B planes) and the pixels."""
    if map_type is None:
        map_type = 1 if colour_map else 0
    return struct.pack(">8I", 0x59A66A95, width, height, depth, len(pixels),
                       kind, map_type, len(colour_map)) + colour_map + pixels


def sunras_rows(rows: np.ndarray, depth: int) -> bytes:
    """(H, W) indices or (H, W * bytes) samples at ``depth``, each row
    padded to 16 bits."""
    out = b""
    for row in rows:
        data = (np.packbits(row.astype(np.uint8)) if depth == 1
                else row.astype(np.uint8)).tobytes()
        out += data + b"\0" * (len(data) % 2)
    return out

# --------------------------------------------------------------------- PAM


def pam(width: int, height: int, depth: int, maxval: int, samples: bytes,
        tupltype: str = None, eol: str = "\n", extra: str = "") -> bytes:
    """A ``P7`` file; ``samples`` as stored (16-bit ones big-endian)."""
    lines = [f"WIDTH {width}", f"HEIGHT {height}", f"DEPTH {depth}",
             f"MAXVAL {maxval}"]
    if tupltype is not None:
        lines.append(f"TUPLTYPE {tupltype}")
    head = "P7" + eol + eol.join(lines) + eol + extra + "ENDHDR" + eol
    return head.encode() + samples

# --------------------------------------------------------------------- PFM


def pfm(values: np.ndarray, scale: float = -1.0) -> bytes:
    """(H, W) (``Pf``) or (H, W, 3) R, G, B (``PF``) float32 values, top
    row first, little-endian where ``scale`` is negative."""
    values = np.asarray(values, np.float32)
    magic = "PF" if values.ndim == 3 else "Pf"
    order = "<f4" if scale < 0 else ">f4"
    head = f"{magic}\n{values.shape[1]} {values.shape[0]}\n{scale:g}\n"
    return head.encode() + values[::-1].astype(order).tobytes()

# ------------------------------------------------------------ Radiance HDR


def rgbe(rgb: np.ndarray) -> np.ndarray:
    """(..., 3) float R, G, B to (..., 4) uint8 R, G, B, E (Ward's
    float2rgbe)."""
    rgb = np.asarray(rgb, np.float64)
    top = rgb.max(-1)
    mantissa, exponent = np.frexp(top)
    scale = np.where(top > 1e-32, mantissa * 256.0 / np.where(top > 0, top, 1),
                     0.0)
    out = np.zeros(rgb.shape[:-1] + (4,), np.uint8)
    out[..., :3] = np.clip(rgb * scale[..., None], 0, 255).astype(np.uint8)
    out[..., 3] = np.where(top > 1e-32, exponent + 128, 0)
    return out


def hdr_scanline(quads: np.ndarray, rng=None) -> bytes:
    """One new-style run-length scanline of (W, 4) quadruples: each plane
    as runs of 3 or more (count + 128) and literals; random run cuts where
    ``rng`` is given."""
    width = len(quads)
    out = bytes([2, 2, width >> 8, width & 255])
    for k in range(4):
        plane, x = quads[:, k], 0
        while x < width:
            end = x
            while end < width and plane[end] == plane[x] and end - x < 127:
                end += 1
            if end - x >= 3 or (rng is not None and rng.random() < 0.2):
                out += bytes([128 + end - x, plane[x]])
                x = end
            else:
                n = min(width - x, 128 if rng is None else
                        int(rng.integers(1, 129)))
                out += bytes([n]) + plane[x:x + n].tobytes()
                x += n
    return out


def hdr(quads: np.ndarray, run_length: bool = True, magic: str = "RADIANCE",
        extra: str = "", rng=None) -> bytes:
    """A Radiance file of (H, W, 4) R, G, B, E quadruples, ``-Y H +X W``,
    scanlines run-length encoded (where the width allows) or flat."""
    height, width = quads.shape[:2]
    head = (f"#?{magic}\n{extra}FORMAT=32-bit_rle_rgbe\n\n"
            f"-Y {height} +X {width}\n").encode()
    if run_length and 8 <= width <= 0x7FFF:
        body = b"".join(hdr_scanline(row, rng) for row in quads)
    else:
        body = quads.tobytes()
    return head + body

# --------------------------------------------------------------------- GIF


def lzw(indices, min_size: int, clear_at: int = 4096, end: bool = True):
    """The GIF LZW codes of a flat index sequence, as (code, width) pairs:
    a clear code first, widths growing as the decoder's table grows, a
    clear code again when the table reaches ``clear_at`` entries, the end
    code last where ``end``."""
    clear, eoi = 1 << min_size, (1 << min_size) + 1
    codes = [(clear, min_size + 1)]
    size, nxt = min_size + 1, eoi + 1
    table = {(i,): i for i in range(clear)}
    w = ()
    for k in indices:
        wk = w + (int(k),)
        if wk in table:
            w = wk
            continue
        codes.append((table[w], size))
        if nxt < 4096:
            table[wk] = nxt
            nxt += 1
            if nxt > (1 << size) and size < 12:
                size += 1
        if nxt >= clear_at:
            codes.append((clear, size))
            size, nxt = min_size + 1, eoi + 1
            table = {(i,): i for i in range(clear)}
        w = (int(k),)
    if w:
        codes.append((table[w], size))
    if end:
        codes.append((eoi, size))
    return codes


def pack(codes) -> bytes:
    """(code, width) pairs packed least significant bit first."""
    acc = nbits = 0
    out = bytearray()
    for code, width in codes:
        acc |= code << nbits
        nbits += width
        while nbits >= 8:
            out.append(acc & 255)
            acc >>= 8
            nbits -= 8
    if nbits:
        out.append(acc & 255)
    return bytes(out)


def sub_blocks(data: bytes, size: int = 255) -> bytes:
    """Data sub-blocks of ``size`` bytes and the terminator."""
    return b"".join(bytes([len(data[i:i + size])]) + data[i:i + size]
                    for i in range(0, len(data), size)) + b"\0"


def _table_bits(n: int) -> int:
    return max(0, (n - 1).bit_length() - 1)


def gif(width: int, height: int, frames, global_table=None,
        background: int = 0, version: bytes = b"GIF89a",
        extensions: bytes = b"", trailer: bool = True) -> bytes:
    """A GIF file: screen descriptor, global table ((N, 3) R, G, B, N a
    power of two from 2 to 256), ``extensions``, the frames (bytes from
    ``gif_frame``) and the trailer."""
    flags, table = 0, b""
    if global_table is not None:
        table = np.asarray(global_table, np.uint8).tobytes()
        flags = 0xF0 | _table_bits(len(table) // 3)
    out = version + struct.pack("<HHBBB", width, height, flags, background,
                                0) + table + extensions
    return out + b"".join(frames) + (b";" if trailer else b"")


def gif_frame(indices: np.ndarray, left: int = 0, top: int = 0,
              local_table=None, interlace: bool = False, min_size: int = None,
              control: dict = None, codes=None, data: bytes = None,
              block: int = 255, **lzw_options) -> bytes:
    """One frame of (h, w) indices: a Graphic Control Extension where
    ``control`` ({"disposal", "transparent"}) is given, the image
    descriptor, a local table, the LZW data (``lzw`` of the indices, rows
    in interlaced order where ``interlace``, or the given ``codes`` or
    packed ``data``) in sub-blocks of ``block`` bytes."""
    h, w = indices.shape
    out = b""
    if control is not None:
        transparent = control.get("transparent")
        packed = (control.get("disposal", 0) << 2) | (transparent is not None)
        out += b"\x21\xf9\x04" + struct.pack(
            "<BHB", packed, control.get("delay", 0), transparent or 0) + b"\0"
    flags, table = 0x40 if interlace else 0, b""
    if local_table is not None:
        table = np.asarray(local_table, np.uint8).tobytes()
        flags |= 0x80 | _table_bits(len(table) // 3)
    out += b"\x2c" + struct.pack("<HHHHB", left, top, w, h, flags) + table
    if min_size is None:
        min_size = max(2, int(indices.max()).bit_length())
    if interlace:
        rows = np.concatenate([np.arange(s, h, d) for s, d in
                               ((0, 8), (4, 8), (2, 4), (1, 2))])
        indices = indices[rows]
    if data is None:
        data = pack(codes if codes is not None else
                    lzw(indices.reshape(-1), min_size, **lzw_options))
    return out + bytes([min_size]) + sub_blocks(data, block)
