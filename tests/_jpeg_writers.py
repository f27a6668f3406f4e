"""Test-only JPEG writers for the files no encoder on the test host
writes: arithmetic-coded JPEG, sequential (SOF9) and progressive (SOF10),
made by transcoding a baseline file's coefficients.

``baseline_coefficients`` reads a Huffman-coded baseline file (one scan,
any sampling, restart markers allowed) into its quantized coefficients,
as libjpeg's ``jdhuff.c`` decodes them. ``arithmetic`` writes the same
coefficients with the QM coder of ``jcarith.c``: its ``arith_encode``
(Qe table and state machine of ``jaricom.c``, carry handling by stacked
0xFF and pending 0x00 bytes, ``finish_pass``'s termination), the DC
difference coding with its L / U conditioning (Figures F.4-F.9), the AC
coding with its Kx split (Figure F.5), the progressive first and
refinement passes (Section G.1.3, EOBx), and ``emit_restart``'s
restart markers and statistics reset; the DAC marker sets L, U and Kx.
A transcoded file is right when ``cv2.imread`` gives of it what it
gives of its source: the same coefficients decode to the same pixels.
The port never imports this module.
"""

from __future__ import annotations

import struct

import numpy as np

ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])

# jaricom.c: (Qe, Next_Index_LPS, Next_Index_MPS, Switch_MPS)
ARITAB = [
    (0x5a1d, 1, 1, 1), (0x2586, 14, 2, 0), (0x1114, 16, 3, 0),
    (0x080b, 18, 4, 0), (0x03d8, 20, 5, 0), (0x01da, 23, 6, 0),
    (0x00e5, 25, 7, 0), (0x006f, 28, 8, 0), (0x0036, 30, 9, 0),
    (0x001a, 33, 10, 0), (0x000d, 35, 11, 0), (0x0006, 9, 12, 0),
    (0x0003, 10, 13, 0), (0x0001, 12, 13, 0), (0x5a7f, 15, 15, 1),
    (0x3f25, 36, 16, 0), (0x2cf2, 38, 17, 0), (0x207c, 39, 18, 0),
    (0x17b9, 40, 19, 0), (0x1182, 42, 20, 0), (0x0cef, 43, 21, 0),
    (0x09a1, 45, 22, 0), (0x072f, 46, 23, 0), (0x055c, 48, 24, 0),
    (0x0406, 49, 25, 0), (0x0303, 51, 26, 0), (0x0240, 52, 27, 0),
    (0x01b1, 54, 28, 0), (0x0144, 56, 29, 0), (0x00f5, 57, 30, 0),
    (0x00b7, 59, 31, 0), (0x008a, 60, 32, 0), (0x0068, 62, 33, 0),
    (0x004e, 63, 34, 0), (0x003b, 32, 35, 0), (0x002c, 33, 9, 0),
    (0x5ae1, 37, 37, 1), (0x484c, 64, 38, 0), (0x3a0d, 65, 39, 0),
    (0x2ef1, 67, 40, 0), (0x261f, 68, 41, 0), (0x1f33, 69, 42, 0),
    (0x19a8, 70, 43, 0), (0x1518, 72, 44, 0), (0x1177, 73, 45, 0),
    (0x0e74, 74, 46, 0), (0x0bfb, 75, 47, 0), (0x09f8, 77, 48, 0),
    (0x0861, 78, 49, 0), (0x0706, 79, 50, 0), (0x05cd, 48, 51, 0),
    (0x04de, 50, 52, 0), (0x040f, 50, 53, 0), (0x0363, 51, 54, 0),
    (0x02d4, 52, 55, 0), (0x025c, 53, 56, 0), (0x01f8, 54, 57, 0),
    (0x01a4, 55, 58, 0), (0x0160, 56, 59, 0), (0x0125, 57, 60, 0),
    (0x00f6, 58, 61, 0), (0x00cb, 59, 62, 0), (0x00ab, 61, 63, 0),
    (0x008f, 61, 32, 0), (0x5b12, 65, 65, 1), (0x4d04, 80, 66, 0),
    (0x412c, 81, 67, 0), (0x37d8, 82, 68, 0), (0x2fe8, 83, 69, 0),
    (0x293c, 84, 70, 0), (0x2379, 86, 71, 0), (0x1edf, 87, 72, 0),
    (0x1aa9, 87, 73, 0), (0x174e, 72, 74, 0), (0x1424, 72, 75, 0),
    (0x119c, 74, 76, 0), (0x0f6b, 74, 77, 0), (0x0d51, 75, 78, 0),
    (0x0bb6, 77, 79, 0), (0x0a40, 77, 48, 0), (0x5832, 80, 81, 1),
    (0x4d1c, 88, 82, 0), (0x438e, 89, 83, 0), (0x3bdd, 90, 84, 0),
    (0x34ee, 91, 85, 0), (0x2eae, 92, 86, 0), (0x299a, 93, 87, 0),
    (0x2516, 86, 71, 0), (0x5570, 88, 89, 1), (0x4ca9, 95, 90, 0),
    (0x44d9, 96, 91, 0), (0x3e22, 97, 92, 0), (0x3824, 99, 93, 0),
    (0x32b4, 99, 94, 0), (0x2e17, 93, 86, 0), (0x56a8, 95, 96, 1),
    (0x4f46, 101, 97, 0), (0x47e5, 102, 98, 0), (0x41cf, 103, 99, 0),
    (0x3c3d, 104, 100, 0), (0x375e, 99, 93, 0), (0x5231, 105, 102, 0),
    (0x4c0f, 106, 103, 0), (0x4639, 107, 104, 0), (0x415e, 103, 99, 0),
    (0x5627, 105, 106, 1), (0x50e7, 108, 107, 0), (0x4b85, 109, 103, 0),
    (0x5597, 110, 109, 0), (0x504f, 111, 107, 0), (0x5a10, 110, 111, 1),
    (0x5522, 112, 109, 0), (0x59eb, 112, 111, 1), (0x5a1d, 113, 113, 0)]

# libjpeg's jpeg_simple_progression for 3 components (YCbCr) and for 1:
# (component indices, Ss, Se, Ah, Al)
SCRIPT_COLOUR = (((0, 1, 2), 0, 0, 0, 1), ((0,), 1, 5, 0, 2),
                 ((2,), 1, 63, 0, 1), ((1,), 1, 63, 0, 1),
                 ((0,), 6, 63, 0, 2), ((0,), 1, 63, 2, 1),
                 ((0, 1, 2), 0, 0, 1, 0), ((2,), 1, 63, 1, 0),
                 ((1,), 1, 63, 1, 0), ((0,), 1, 63, 1, 0))
SCRIPT_GRAY = (((0,), 0, 0, 0, 1), ((0,), 1, 5, 0, 2), ((0,), 6, 63, 0, 2),
               ((0,), 1, 63, 2, 1), ((0,), 0, 0, 1, 0),
               ((0,), 1, 63, 1, 0))


def _segments(data: bytes):
    """(marker, body, offset of the marker) of the segments up to the
    first scan; the scan's body runs to the end of the file."""
    pos = 2
    while pos < len(data):
        assert data[pos] == 0xFF, pos
        marker = data[pos + 1]
        length = struct.unpack(">H", data[pos + 2:pos + 4])[0]
        if marker == 0xDA:
            yield marker, data[pos + 4:], pos
            return
        yield marker, data[pos + 4:pos + 2 + length], pos
        pos += 2 + length


class _Huffman:
    def __init__(self, body: bytes):
        counts = body[:16]
        values = body[16:16 + sum(counts)]
        self.codes = {}
        code = k = 0
        for length in range(1, 17):
            for _ in range(counts[length - 1]):
                self.codes[(length, code)] = values[k]
                code += 1
                k += 1
            code <<= 1


class _Bits:
    """MSB-first bits of an entropy-coded segment, stuffing removed."""

    def __init__(self, data: bytes):
        self.data, self.pos, self.acc, self.n = data, 0, 0, 0

    def bit(self) -> int:
        if self.n == 0:
            b = self.data[self.pos]
            self.pos += 1
            if b == 0xFF:
                nxt = self.data[self.pos]
                assert nxt == 0, "a marker inside the data"
                self.pos += 1
            self.acc, self.n = b, 8
        self.n -= 1
        return (self.acc >> self.n) & 1

    def bits(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = (v << 1) | self.bit()
        return v

    def huff(self, table: _Huffman) -> int:
        code = length = 0
        while True:
            code = (code << 1) | self.bit()
            length += 1
            if (length, code) in table.codes:
                return table.codes[(length, code)]

    def restart(self) -> None:
        self.n = 0
        assert self.data[self.pos] == 0xFF and 0xD0 <= self.data[self.pos + 1] \
            <= 0xD7, "no restart marker"
        self.pos += 2


def _extend(v: int, t: int) -> int:
    return v - (1 << t) + 1 if v < (1 << (t - 1)) else v


def baseline_coefficients(data: bytes) -> dict:
    """A baseline file's frame and quantized coefficients: {"width",
    "height", "components": [{"id", "h", "v", "tq", "coef": (rows,
    cols, 64) int natural order, MCU-padded}], "header": the segments
    before SOF (APPn, DQT) as bytes}."""
    dc, ac, restart, header = {}, {}, 0, b""
    for marker, body, _ in _segments(data):
        if marker in (0xC0, 0xC1):
            height, width, nc = struct.unpack(">HHB", body[1:6])
            comps = [{"id": body[6 + 3 * i], "h": body[7 + 3 * i] >> 4,
                      "v": body[7 + 3 * i] & 15, "tq": body[8 + 3 * i]}
                     for i in range(nc)]
        elif marker == 0xC4:
            pos = 0
            while pos < len(body):
                table = _Huffman(body[pos + 1:])
                (ac if body[pos] >> 4 else dc)[body[pos] & 15] = table
                pos += 17 + sum(body[pos + 1:pos + 17])
        elif marker == 0xDD:
            restart = struct.unpack(">H", body[:2])[0]
        elif marker == 0xDA:
            ns = body[0]
            tables = [body[2 + 2 * i] for i in range(ns)]
            assert ns == len(comps), "one interleaved scan"
            scan = body[4 + 2 * ns:]
        elif marker != 0xC2:
            header += (b"\xff" + bytes([marker])
                       + struct.pack(">H", len(body) + 2) + body)
    hmax = max(c["h"] for c in comps)
    vmax = max(c["v"] for c in comps)
    if nc == 1:
        comps[0]["h"] = comps[0]["v"] = hmax = vmax = 1
    mcux = -(-width // (8 * hmax))
    mcuy = -(-height // (8 * vmax))
    for c in comps:
        c["coef"] = np.zeros((mcuy * c["v"], mcux * c["h"], 64), np.int64)
        c["bw"] = -(-(-(-width * c["h"] // hmax)) // 8)
        c["bh"] = -(-(-(-height * c["v"] // vmax)) // 8)
    bits, pred = _Bits(scan), [0] * nc
    for m in range(mcux * mcuy):
        if restart and m and m % restart == 0:
            bits.restart()
            pred = [0] * nc
        my, mx = divmod(m, mcux)
        for ci, c in enumerate(comps):
            for by in range(c["v"]):
                for bx in range(c["h"]):
                    block = c["coef"][my * c["v"] + by, mx * c["h"] + bx]
                    t = bits.huff(dc[tables[ci] >> 4])
                    pred[ci] += _extend(bits.bits(t), t) if t else 0
                    block[0] = pred[ci]
                    k = 1
                    while k < 64:
                        rs = bits.huff(ac[tables[ci] & 15])
                        r, s = rs >> 4, rs & 15
                        if s:
                            k += r
                            block[ZIGZAG[k]] = _extend(bits.bits(s), s)
                        elif r != 15:
                            break
                        else:
                            k += 15
                        k += 1
    return {"width": width, "height": height, "components": comps,
            "header": header, "mcux": mcux, "mcuy": mcuy}


class ArithEncoder:
    """``jcarith.c``'s QM encoder: C, A, the stacked 0xFF count (sc),
    the pending 0x00 count (zc), CT and the byte in hand."""

    def __init__(self):
        self.out = bytearray()
        self.reset()

    def reset(self):
        self.c, self.a, self.sc, self.zc, self.ct, self.buffer = \
            0, 0x10000, 0, 0, 11, -1

    def _emit(self, b: int) -> None:
        self.out.append(b)

    def _flush_zeros(self):
        while self.zc:
            self._emit(0)
            self.zc -= 1

    def encode(self, st: bytearray, i: int, val: int) -> None:
        sv = st[i]
        qe, nlps, nmps, switch = ARITAB[sv & 0x7F]
        nl = nlps | (switch << 7)
        self.a -= qe
        if val != (sv >> 7):  # the less probable symbol
            if self.a >= qe:
                self.c += self.a
                self.a = qe
            st[i] = (sv & 0x80) ^ nl
        else:
            if self.a >= 0x8000:
                return
            if self.a < qe:
                self.c += self.a
                self.a = qe
            st[i] = (sv & 0x80) ^ nmps
        while True:  # renormalization and output (Section D.1.6)
            self.a <<= 1
            self.c <<= 1
            self.ct -= 1
            if self.ct == 0:
                temp = self.c >> 19
                if temp > 0xFF:  # a carry over the stacked 0xFF bytes
                    if self.buffer >= 0:
                        self._flush_zeros()
                        self._emit(self.buffer + 1)
                        if self.buffer + 1 == 0xFF:
                            self._emit(0)
                    self.zc += self.sc
                    self.sc = 0
                    self.buffer = temp & 0xFF
                elif temp == 0xFF:
                    self.sc += 1
                else:
                    if self.buffer == 0:
                        self.zc += 1
                    elif self.buffer >= 0:
                        self._flush_zeros()
                        self._emit(self.buffer)
                    if self.sc:
                        self._flush_zeros()
                        for _ in range(self.sc):
                            self._emit(0xFF)
                            self._emit(0)
                        self.sc = 0
                    self.buffer = temp & 0xFF
                self.c &= 0x7FFFF
                self.ct += 8
            if self.a >= 0x8000:
                return

    def finish(self) -> None:
        """``finish_pass``: the shortest tail that decodes right."""
        temp = (self.a - 1 + self.c) & 0xFFFF0000
        self.c = temp + 0x8000 if temp < self.c else temp
        self.c <<= self.ct
        if self.c & 0xF8000000:
            if self.buffer >= 0:
                self._flush_zeros()
                self._emit(self.buffer + 1)
                if self.buffer + 1 == 0xFF:
                    self._emit(0)
            self.zc += self.sc
            self.sc = 0
        else:
            if self.buffer == 0:
                self.zc += 1
            elif self.buffer >= 0:
                self._flush_zeros()
                self._emit(self.buffer)
            if self.sc:
                self._flush_zeros()
                for _ in range(self.sc):
                    self._emit(0xFF)
                    self._emit(0)
                self.sc = 0
        if self.c & 0x7FFF800:
            self._flush_zeros()
            self._emit((self.c >> 19) & 0xFF)
            if ((self.c >> 19) & 0xFF) == 0xFF:
                self._emit(0)
            if self.c & 0x7F800:
                self._emit((self.c >> 11) & 0xFF)
                if ((self.c >> 11) & 0xFF) == 0xFF:
                    self._emit(0)


class _ScanCoder:
    """One scan's MCUs coded as ``jcarith.c``'s encode_mcu* functions."""

    def __init__(self, enc: ArithEncoder, dac, ss, se, ah, al, progressive):
        self.enc, self.dac = enc, dac
        self.ss, self.se, self.ah, self.al = ss, se, ah, al
        self.progressive = progressive
        self.fixed = bytearray([113, 0, 0, 0])
        self.dc_stats = {t: bytearray(64) for t in range(4)}
        self.ac_stats = {t: bytearray(256) for t in range(4)}

    def reset(self, comps):
        for c in comps:
            c["last_dc"], c["dc_context"] = 0, 0
            self.dc_stats[c["td"]][:] = bytes(64)
            self.ac_stats[c["ta"]][:] = bytes(256)

    def _magnitude(self, st, i, v, tbl, ac, k=0):
        """Figures F.8-F.9: v - 1's magnitude category and bits from
        bin i of st; returns m."""
        enc = self.enc
        m = 0
        v -= 1
        if v:
            enc.encode(st, i, 1)
            m, v2 = 1, v
            if ac:
                v2 >>= 1
                if v2:
                    enc.encode(st, i, 1)
                    m <<= 1
                    st, i = self.ac_stats[tbl], \
                        (189 if k <= self.dac["K"][tbl] else 217)
                    v2 >>= 1
                    while v2:
                        enc.encode(st, i, 1)
                        m <<= 1
                        i += 1
                        v2 >>= 1
            else:
                st, i = self.dc_stats[tbl], 20
                v2 >>= 1
                while v2:
                    enc.encode(st, i, 1)
                    m <<= 1
                    i += 1
                    v2 >>= 1
        enc.encode(st, i, 0)
        i += 14
        mm = m
        while mm > 1:
            mm >>= 1
            enc.encode(st, i, 1 if mm & v else 0)
        return m

    def dc(self, c, block) -> None:
        enc, tbl = self.enc, c["td"]
        st = self.dc_stats[tbl]
        value = int(block[0]) >> self.al
        i = c["dc_context"]
        v = value - c["last_dc"]
        if v == 0:
            enc.encode(st, i, 0)
            c["dc_context"] = 0
            return
        c["last_dc"] = value
        enc.encode(st, i, 1)
        if v > 0:
            enc.encode(st, i + 1, 0)
            i += 2
            c["dc_context"] = 4
        else:
            v = -v
            enc.encode(st, i + 1, 1)
            i += 3
            c["dc_context"] = 8
        m = self._magnitude(st, i, v, tbl, ac=False)
        if m < (1 << self.dac["L"][tbl]) >> 1:
            c["dc_context"] = 0
        elif m > (1 << self.dac["U"][tbl]) >> 1:
            c["dc_context"] += 8

    def _shifted(self, block, k, shift):
        v = int(block[ZIGZAG[k]])
        return (v >> shift) if v >= 0 else -((-v) >> shift)

    def ac(self, c, block) -> None:
        enc, tbl, al = self.enc, c["ta"], self.al
        st = self.ac_stats[tbl]
        ke = self.se
        while ke > 0 and self._shifted(block, ke, al) == 0:
            ke -= 1
        k = max(self.ss, 1)  # a sequential scan's AC coefficients from 1
        while k <= ke:
            i = 3 * (k - 1)
            enc.encode(st, i, 0)  # not EOB
            while True:
                v = self._shifted(block, k, al)
                if v:
                    enc.encode(st, i + 1, 1)
                    enc.encode(self.fixed, 0, 1 if v < 0 else 0)
                    break
                enc.encode(st, i + 1, 0)
                i += 3
                k += 1
            self._magnitude(st, i + 2, abs(v), tbl, ac=True, k=k)
            k += 1
        if k <= self.se:
            enc.encode(st, 3 * (k - 1), 1)  # EOB

    def dc_refine(self, block) -> None:
        self.enc.encode(self.fixed, 0, (int(block[0]) >> self.al) & 1)

    def ac_refine(self, c, block) -> None:
        enc, tbl, al, ah = self.enc, c["ta"], self.al, self.ah
        st = self.ac_stats[tbl]
        ke = self.se
        while ke > 0 and self._shifted(block, ke, al) == 0:
            ke -= 1
        kex = ke
        while kex > 0 and self._shifted(block, kex, ah) == 0:
            kex -= 1
        k = self.ss
        while k <= ke:
            i = 3 * (k - 1)
            if k > kex:
                enc.encode(st, i, 0)
            while True:
                v = abs(self._shifted(block, k, al))
                if v:
                    if v >> 1:
                        enc.encode(st, i + 2, v & 1)
                    else:
                        enc.encode(st, i + 1, 1)
                        enc.encode(self.fixed, 0,
                                   1 if block[ZIGZAG[k]] < 0 else 0)
                    break
                enc.encode(st, i + 1, 0)
                i += 3
                k += 1
            k += 1
        if k <= self.se:
            enc.encode(st, 3 * (k - 1), 1)

    def block(self, c, block) -> None:
        if not self.progressive:
            self.dc(c, block)
            self.ac(c, block)
        elif self.ss == 0:
            self.dc_refine(block) if self.ah else self.dc(c, block)
        else:
            self.ac_refine(c, block) if self.ah else self.ac(c, block)


def _segment(marker: int, body: bytes) -> bytes:
    return bytes([0xFF, marker]) + struct.pack(">H", len(body) + 2) + body


def arithmetic(frame: dict, progressive: bool = False, restart: int = 0,
               dac: dict | None = None, script=None) -> bytes:
    """The frame's coefficients as an arithmetic-coded JPEG file: SOF9,
    or SOF10 with ``script`` (libjpeg's simple progression by default);
    ``restart`` MCUs a restart interval; ``dac`` {"L": [..], "U": [..],
    "K": [..]} by table (libjpeg's defaults 0, 1, 5 where None), written
    as a DAC marker when given."""
    comps = frame["components"]
    nc = len(comps)
    for i, c in enumerate(comps):
        c["td"] = c["ta"] = 0 if i == 0 else 1
    conditioning = {"L": [0] * 4, "U": [1] * 4, "K": [5] * 4}
    if dac:
        conditioning.update({k: list(v) for k, v in dac.items()})
    out = bytearray(b"\xff\xd8" + frame["header"])
    sof = struct.pack(">BHHB", 8, frame["height"], frame["width"], nc)
    for c in comps:
        sof += bytes([c["id"], (c["h"] << 4) | c["v"], c["tq"]])
    out += _segment(0xCA if progressive else 0xC9, sof)
    if dac:
        body = b""
        for t in range(2 if nc > 1 else 1):
            body += bytes([t, (conditioning["U"][t] << 4)
                           | conditioning["L"][t]])
            body += bytes([0x10 | t, conditioning["K"][t]])
        out += _segment(0xCC, body)
    if restart:
        out += _segment(0xDD, struct.pack(">H", restart))
    if script is None:
        script = (SCRIPT_COLOUR if nc == 3 else SCRIPT_GRAY) if progressive \
            else ((tuple(range(nc)), 0, 63, 0, 0),)
    for members, ss, se, ah, al in script:
        scan_comps = [comps[i] for i in members]
        hdr = bytes([len(scan_comps)])
        for c in scan_comps:
            hdr += bytes([c["id"], (c["td"] << 4) | c["ta"]])
        out += _segment(0xDA, hdr + bytes([ss, se, (ah << 4) | al]))
        enc = ArithEncoder()
        coder = _ScanCoder(enc, conditioning, ss, se, ah, al, progressive)
        coder.reset(scan_comps)
        if len(scan_comps) > 1:
            blocks = [[(c, c["coef"][my * c["v"] + by, mx * c["h"] + bx])
                       for c in scan_comps for by in range(c["v"])
                       for bx in range(c["h"])]
                      for my in range(frame["mcuy"])
                      for mx in range(frame["mcux"])]
        else:
            c = scan_comps[0]
            blocks = [[(c, c["coef"][by, bx])] for by in range(c["bh"])
                      for bx in range(c["bw"])]
        rst = 0
        for m, mcu in enumerate(blocks):
            if restart and m and m % restart == 0:
                enc.finish()
                enc.out += bytes([0xFF, 0xD0 + rst])
                rst = (rst + 1) & 7
                enc.reset()
                coder.reset(scan_comps)
            for c, block in mcu:
                coder.block(c, block)
        enc.finish()
        out += enc.out
    return bytes(out + b"\xff\xd9")


# the standard luminance DC table (ITU T.81 Table K.3), categories 0-11
_DC_BITS = (0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0)


def lossless(img: np.ndarray, predictor: int = 1, restart: int = 0,
             adobe: int | None = None, sampling=None) -> bytes:
    """A lossless (SOF3) Huffman-coded JPEG of an (H, W) or (H, W, C)
    uint8 image, its C components interleaved: Annex H's predictors 1-7
    (the first row of the image and of each restart interval predicted
    from the left, its first sample from 128; the first column from
    above), differences coded by the standard DC table; an Adobe marker of
    transform ``adobe`` where given. ``sampling`` ((h, v) by component,
    all 1 x 1 by default) subsamples a component by keeping every
    (hmax / h, vmax / v)-th sample; the samples an MCU holds past the
    component's edge repeat its last one. Right when ``cv2.imread`` gives
    back the image (its subsampled components blown up)."""
    codes, code, k = {}, 0, 0
    for length in range(1, 17):
        for _ in range(_DC_BITS[length - 1]):
            codes[k] = (code, length)
            code, k = code + 1, k + 1
        code <<= 1
    x = img.astype(np.int64).reshape(img.shape[0], img.shape[1], -1)
    height, width, nc = x.shape
    sampling = sampling or [(1, 1)] * nc
    hmax = max(h for h, _ in sampling)
    vmax = max(v for _, v in sampling)
    mcux, mcuy = -(-width // hmax), -(-height // vmax)
    planes = []  # each component's samples, its MCUs' padding included
    for ci, (h, v) in enumerate(sampling):
        p = x[::vmax // v, ::hmax // h, ci]
        ph, pw = mcuy * v, mcux * h
        p = np.pad(p, ((0, ph - p.shape[0]), (0, pw - p.shape[1])),
                   mode="edge")
        planes.append(p)

    def diff(ci, r, c, first_row):
        p = planes[ci]
        a = p[r, c - 1] if c else 0
        b = p[r - 1, c] if r else 0
        d = p[r - 1, c - 1] if r and c else 0
        if first_row:
            pred = 128 if c == 0 else a
        elif c == 0:
            pred = b
        else:
            pred = (a, b, d, a + b - d, a + ((b - d) >> 1),
                    b + ((a - d) >> 1), (a + b) >> 1)[predictor - 1]
        return int(p[r, c] - pred)

    segments, bits = [], []
    first_mcu_row = 0  # the MCU row a restart interval starts at
    for my in range(mcuy):
        if restart and my and (my * mcux) % restart == 0:
            segments.append(bits)
            bits, first_mcu_row = [], my
        for mx in range(mcux):
            for ci, (h, v) in enumerate(sampling):
                for dy in range(v):
                    for dx in range(h):
                        r, c = my * v + dy, mx * h + dx
                        d = diff(ci, r, c, r == first_mcu_row * v)
                        size = abs(d).bit_length()
                        bits.append(codes[size])
                        if size:
                            bits.append((d if d > 0 else d + (1 << size) - 1,
                                         size))
    segments.append(bits)
    data = bytearray()
    for i, seg in enumerate(segments):
        if i:
            data += bytes([0xFF, 0xD0 + (i - 1) % 8])
        acc = "".join(format(v, f"0{n}b") for v, n in seg)
        acc += "1" * (-len(acc) % 8)
        for j in range(0, len(acc), 8):
            byte = int(acc[j:j + 8], 2)
            data.append(byte)
            if byte == 0xFF:
                data.append(0)
    out = b"\xff\xd8"
    if adobe is not None:
        out += _segment(0xEE, b"Adobe" + bytes([0, 100, 0, 0, 0, 0, adobe]))
    sof = struct.pack(">BHHB", 8, height, width, nc)
    for ci, (h, v) in enumerate(sampling):
        sof += bytes([ci + 1, (h << 4) | v, 0])
    out += _segment(0xC3, sof)
    out += _segment(0xC4, bytes([0]) + bytes(_DC_BITS) + bytes(range(12)))
    if restart:
        out += _segment(0xDD, struct.pack(">H", restart))
    sos = bytes([nc]) + b"".join(bytes([ci + 1, 0]) for ci in range(nc))
    out += _segment(0xDA, sos + bytes([predictor, 0, 0]))
    return out + bytes(data) + b"\xff\xd9"


def lossless_gray(img: np.ndarray, predictor: int = 1,
                  restart: int = 0) -> bytes:
    """``lossless`` of an (H, W) uint8 image."""
    return lossless(img, predictor, restart)
