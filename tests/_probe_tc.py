"""Models of the probe kernels' tensor-core addressing, for CPU tests.

``csrc/probe_conv.cu`` and ``csrc/probe_chain.cu`` cannot run here. These
models lay shared memory out as bytes exactly as the kernels' index
expressions do, read every wgmma operand as the PTX layouts define it (a
K-major, unswizzled descriptor: row r, byte b of the operand at start +
(r // 8) SBO + (b // 16) LBO + (r % 8) 16 + b % 16; a register fragment:
the m64k16 / m64k32 A fragment and the m64nN accumulator of lane 4 g + t
of warp w), multiply, and apply the kernels' epilogues from their own
expressions, so that a wrong offset, plane, permutation or fragment slot
shows up as a wrong result against the plain versions. Sums are taken in
float64 (bf16) or int64 (int8); the kernels' sum order is not modelled.
"""

from __future__ import annotations

import numpy as np
import torch

from spnerf_tpu_torch.kernels.probe_conv import pack_probe_weights


def desc_read(smem, start, lbo, sbo, rows, kbytes):
    """(rows, kbytes) bytes of a K-major descriptor without swizzle."""
    r = np.arange(rows)[:, None]
    b = np.arange(kbytes)[None, :]
    return smem[start + (r // 8) * sbo + (b // 16) * lbo + (r % 8) * 16 + b % 16]


def values(byts, s8):
    """uint8 (..., 2 n) bytes -> int64 (int8) or float64 (bf16) values."""
    byts = np.ascontiguousarray(byts)
    if s8:
        return byts.view(np.int8).astype(np.int64)
    bits = byts.view(np.uint16).astype(np.uint32) << 16
    return bits.view(np.float32).astype(np.float64)


def _bf16(v):
    return torch.from_numpy(np.asarray(v, np.float32)).to(torch.bfloat16)


def _fragment_rows():
    """(warp, lane, g, t) of the 128 threads of a warpgroup."""
    tid = np.arange(128)
    lane = tid % 32
    return tid // 32, lane, lane // 4, lane % 4


def probe_conv_model(x, w, order):
    """``probe_conv`` as the kernel addresses it: x (n, Hb, W + 2, C) int8
    or bf16 on the CPU, w (9, C, C) -> (n, Hb, W, C)."""
    s8 = x.dtype == torch.int8
    ES = 1 if s8 else 2
    n, Hb, Wp, C = x.shape
    W, R = Wp - 2, n * Hb
    CH, KC = C * ES // 16, min(C * ES, 128) // ES
    KCH = C // KC
    NQ, KP, BN = 9 * KCH, KC * ES // 16, min(C, 128)
    CHUNK = KC * ES * BN
    concat = order == "concat"
    MT, MPB = (1, 1) if concat else (2, 4)
    PLANE = 16 * 64 if concat else 16 * 66
    a_bytes = 9 * CH * PLANE if concat else MPB * CH * PLANE
    PIX = C * ES
    xb = x.contiguous().view(torch.uint8).reshape(R, Wp * PIX).numpy()
    wb = pack_probe_weights(w.reshape(9, C, C), C).view(torch.uint8).reshape(-1).numpy()
    tpr = -(-W // 64)
    n_mt = R * tpr
    out = np.zeros((R, W, C), np.int64 if s8 else np.float64)
    warp, lane, g, t = _fragment_rows()
    for bx in range(-(-n_mt // MPB)):
        for by in range(C // BN):
            smem = np.zeros(a_bytes, np.uint8)
            mt0 = bx * MPB
            for i in range(MPB):
                mt = mt0 + i
                if mt >= n_mt:
                    break
                r, j0 = mt // tpr, (mt % tpr) * 64
                if concat:
                    e = np.arange(9 * CH * 64)
                    c, m, tap = e % CH, (e // CH) % 64, e // (CH * 64)
                    px = j0 + m + tap % 3
                    dst = (tap * CH + c) * PLANE + 16 * m
                else:  # load_planes_async: v = i % V, p = i / V
                    e = np.arange(66 * CH)
                    c, p = e % CH, e // CH
                    px = j0 + p
                    dst = i * CH * PLANE + c * PLANE + 16 * p
                ok = px < W + 2
                src = px * PIX + 16 * c
                for k in range(16):
                    smem[dst[ok] + k] = xb[r, src[ok] + k]
            for wg in range(MPB // MT):
                for i in range(MT):
                    mt = mt0 + wg * MT + i
                    if mt >= n_mt:
                        continue
                    acc = np.zeros((64, BN), out.dtype)
                    for q in range(NQ):
                        tap, kc = q // KCH, q % KCH
                        chunk = wb[(by * NQ + q) * CHUNK:(by * NQ + q + 1) * CHUNK]
                        if concat:
                            a = (tap * CH + kc * KP) * PLANE
                        else:
                            a = ((wg * MT + i) * CH + kc * KP) * PLANE + 16 * (tap % 3)
                        # s8_tap_issue<KC, PLANE, 128, BN> (k-steps of 32 K) /
                        # bf16_tap_issue<KC, PLANE, 128, BN> (of 16 K): A at
                        # a + 2 k PLANE, B at 256 k, SBO KC * 8 or KC * 16
                        for k in range(KC * ES // 32):
                            A = desc_read(smem, a + 2 * k * PLANE, PLANE, 128, 64, 32)
                            B = desc_read(chunk, 256 * k, 128, KC * 8 * ES, BN, 32)
                            acc += values(A, s8) @ values(B, s8).T
                    # epilogue: register 4 j + 2 h + e of thread (warp, g, t)
                    r, j0 = mt // tpr, (mt % tpr) * 64
                    for h in range(2):
                        row = 16 * warp + g + 8 * h
                        px = j0 + row
                        for j in range(BN // 8):
                            for e in range(2):
                                ch = 8 * j + 2 * t + e
                                v = acc[row, ch]
                                keep = px < W
                                out[r, px[keep], by * BN + ch[keep]] = v[keep]
    out = np.maximum(out, 0)
    if s8:
        y = torch.from_numpy(((out & 255) ^ 128) - 128).to(torch.int8)
    else:
        y = _bf16(out)
    return y.reshape(n, Hb, W, C)


def s8_unit(k):
    """probe_chain.cu's ``s8_unit``: the unit A's column k carries."""
    return (32 * (k // 32) + 8 * (2 * ((k % 32) // 16) + (k % 4) // 2)
            + 2 * ((k % 16) // 4) + k % 2)


def probe_chain_model(x, w, depth):
    """``probe_chain`` as the kernel addresses it, on the CPU."""
    s8 = x.dtype == torch.int8
    K = 128
    R = x.shape[0]
    xn = x.contiguous().view(torch.uint8).numpy().reshape(R, K * (1 if s8 else 2))
    wn = w.contiguous().view(torch.uint8).numpy().reshape(K, -1)
    # the staged B operand, bytes
    sw = np.zeros(K * K * (1 if s8 else 2), np.uint8)
    k, nn = np.divmod(np.arange(K * K), K)
    if s8:
        sw[((nn // 8) * (K // 16) + k // 16) * 128 + (nn % 8) * 16 + k % 16] = \
            wn[s8_unit(k), nn]
    else:
        el = ((nn // 8) * (K // 8) + k // 8) * 64 + (nn % 8) * 8 + k % 8
        sw[2 * el], sw[2 * el + 1] = wn[k, 2 * nn], wn[k, 2 * nn + 1]
    warp, lane, g, t = _fragment_rows()
    out = np.zeros((R, K * (1 if s8 else 2)), np.uint8)
    for blk in range(-(-R // 64)):
        rows = [blk * 64 + 16 * warp + g + 8 * h for h in range(2)]
        inside = [r < R for r in rows]
        # registers: a[thread][step][reg] as 32-bit words
        steps = 4 if s8 else 8
        a = np.zeros((128, steps, 4), np.uint32)
        for h in range(2):
            rr = np.where(inside[h], rows[h], 0)
            for s in range(steps):
                for e in range(2):
                    if s8:
                        col = 32 * s + 16 * e + 2 * t
                        lo = xn[rr, col].astype(np.uint32) | (xn[rr, col + 1].astype(np.uint32) << 8)
                        hi = xn[rr, col + 8].astype(np.uint32) | (xn[rr, col + 9].astype(np.uint32) << 8)
                        word = lo | (hi << 16)
                    else:
                        col = 2 * (16 * s + 8 * e + 2 * t)
                        word = sum(xn[rr, col + b].astype(np.uint32) << (8 * b) for b in range(4))
                    a[:, s, 2 * e + h] = np.where(inside[h], word, 0)
        for layer in range(depth):
            # A from the fragments: register 2 e + h of lane (g, t) holds row
            # 16 warp + g + 8 h, columns 16 e + 4 t + {0..3} (int8) or
            # 8 e + 2 t + {0, 1} (bf16) of the k-step
            A = np.zeros((64, K), np.int64 if s8 else np.float64)
            for s in range(steps):
                for e in range(2):
                    for h in range(2):
                        word = a[:, s, 2 * e + h]
                        row = 16 * warp + g + 8 * h
                        if s8:
                            for i in range(4):
                                byte = ((word >> (8 * i)) & 255).astype(np.uint8)
                                A[row, 32 * s + 16 * e + 4 * t + i] = byte.view(np.int8)
                        else:
                            for i in range(2):
                                half = ((word >> (16 * i)) & 0xFFFF).astype(np.uint32) << 16
                                A[row, 16 * s + 8 * e + 2 * t + i] = half.view(np.float32)
            D = np.zeros((64, K), A.dtype)
            if s8:  # 4 x wgmma m64n128k32, B at s * 256, SBO 1024
                for s in range(4):
                    B = desc_read(sw, 256 * s, 128, 1024, K, 32)
                    D += A[:, 32 * s:32 * s + 32] @ values(B, True).T
            else:  # two halves of N, 8 x m64n64k16 each, B at half * 16384 + ks * 256
                for half in range(2):
                    for ks in range(8):
                        B = desc_read(sw, half * 8 * 2048 + ks * 256, 128, 2048, 64, 32)
                        D[:, 64 * half:64 * half + 64] += \
                            A[:, 16 * ks:16 * ks + 16] @ values(B, False).T
                D = D.astype(np.float32).astype(np.float64)
            # accumulators: d[4 j + 2 h + i] (int8, N 128) or d[half][4 jj + 2 h + i]
            # (bf16) is row 16 warp + g + 8 h, column 8 j + 2 t + i
            def acc(j, h, i):
                return D[16 * warp + g + 8 * h, 8 * j + 2 * t + i]

            if s8:
                q = lambda v: (np.clip(v >> 7, -127, 127) & 255).astype(np.uint32)  # noqa: E731
            else:
                q = lambda v: (torch.from_numpy(np.maximum(v, 0).astype(np.float32))  # noqa: E731
                               .to(torch.bfloat16).view(torch.int16).numpy()
                               .astype(np.uint32) & 0xFFFF)
            if layer + 1 == depth:
                for h in range(2):
                    for j in range(16):
                        for i in range(2):
                            col = (8 * j + 2 * t + i) * (1 if s8 else 2)
                            v = q(acc(j, h, i))
                            keep = inside[h]
                            out[rows[h][keep], col[keep]] = v[keep] & 255
                            if not s8:
                                out[rows[h][keep], col[keep] + 1] = (v[keep] >> 8) & 255
                break
            for s in range(steps):
                for e in range(2):
                    for h in range(2):
                        if s8:  # lo = 4 (4 s + 2 e) + 2 h, hi = lo + 4
                            j = 4 * s + 2 * e
                            a[:, s, 2 * e + h] = (q(acc(j, h, 0)) | q(acc(j, h, 1)) << 8
                                                  | q(acc(j + 1, h, 0)) << 16
                                                  | q(acc(j + 1, h, 1)) << 24)
                        else:  # j = 2 ks + e
                            j = 2 * s + e
                            a[:, s, 2 * e + h] = q(acc(j, h, 0)) | q(acc(j, h, 1)) << 16
    y = torch.from_numpy(out)
    return y.view(torch.int8) if s8 else y.view(torch.bfloat16).reshape(R, K)
