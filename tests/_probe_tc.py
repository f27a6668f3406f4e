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

from spnerf_tpu_torch.kernels.probe_conv import (
    MPB,
    kernel_config,
    pack_probe_weights,
    schedule,
)


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


def tma_box(xb, R, Wp, PIX, c1, c2, r, box_p, box_c):
    """The kernel's tensor-map copy: x as bytes (16 of a chunk, Wp pixels,
    PIX / 16 chunks, R rows), the box (16, box_p, box_c, 1) at (0, c1, c2,
    r), as it lands in shared memory: chunk-major, then pixel, then the
    16 bytes; zeros outside the tensor."""
    c = c2 + np.arange(box_c)[:, None, None]
    p = c1 + np.arange(box_p)[None, :, None]
    b = np.arange(16)[None, None, :]
    ok = (p < Wp) & (c < PIX // 16) & (r < R)
    src = np.where(ok, r * Wp * PIX + p * PIX + c * 16 + b, 0)
    return np.where(ok, xb[src], 0).astype(np.uint8).reshape(-1)


def swizzle(addr, sw):
    """TMA's and wgmma's 128B / 64B swizzle of shared address addr: bits
    4-6 (4-5) XOR bits 7-9 (7-8)."""
    return addr ^ (((addr >> 7) & (7 if sw == 128 else 3)) << 4)


def tma_box_swizzled(smem, dst, xb, R, Wp, PIX, c0, c1, r, sw):
    """The kernel's concat copy: x as bytes (PIX of a pixel, Wp pixels, R
    rows), the box (sw, 64, 1) at (c0, c1, r) into smem at dst, row p
    (pixel c1 + p) at dst + p sw, swizzled; zeros outside."""
    p = np.arange(64)[:, None]
    b = np.arange(sw)[None, :]
    ok = (c1 + p < Wp) & (c0 + b < PIX) & (r < R)
    src = np.where(ok, r * Wp * PIX + (c1 + p) * PIX + c0 + b, 0)
    smem[swizzle(dst + p * sw + b, sw)] = np.where(ok, xb[src], 0)


def desc_read_swizzled(smem, start, sw, rows, kbytes):
    """(rows, kbytes) bytes of a K-major operand with the 128B / 64B
    swizzle (stride byte offset 8 sw): row r, byte b at swizzle(start +
    r sw + b)."""
    r = np.arange(rows)[:, None]
    b = np.arange(kbytes)[None, :]
    return smem[swizzle(start + r * sw + b, sw)]


def quad_words(v, t):
    """store_tile's quad_transpose over the 128 lanes: v (128, 4) words,
    t the lane % 4 of each; the shuffles and selects as the kernel does
    them."""
    o = v.copy()
    lanes = np.arange(128)
    for x in range(1, 4):
        send = v[lanes, t ^ x]
        got = send[lanes ^ x]
        o[lanes, t ^ x] = got
    return o


def byte_perm(x, y, sel):
    """__byte_perm: byte n of the result is byte (sel >> 4 n) & 7 of y:x."""
    both = [(x >> (8 * i)) & 255 for i in range(4)] + [(y >> (8 * i)) & 255 for i in range(4)]
    return sum(both[(sel >> (4 * n)) & 7] << (8 * n) for n in range(4))


def probe_conv_model(x, w, order, blocks=None):
    """``probe_conv`` as the kernel addresses it: x (n, Hb, W + 2, C) int8
    or bf16 on the CPU, w (9, C, C) -> (n, Hb, W, C). Every block of the
    persistent grid (``blocks``, default a few clusters) walks its items
    as ``probe_conv.schedule`` states; the producer's copies land in the
    block's shared memory (resident weights, acc9's input stages in
    planes, the ring's slots with concat's swizzled A slices and the
    weight parts of every block of the cluster) at the kernel's offsets, each consumer
    warpgroup reads its two M-tiles' operands through the descriptors,
    and the epilogue writes 16-byte groups as ``store_tile`` builds
    them."""
    s8 = x.dtype == torch.int8
    ES = 1 if s8 else 2
    n, Hb, Wp, C = x.shape
    W, R = Wp - 2, n * Hb
    concat = order == "concat"
    cfg = kernel_config(ES, C, concat)
    KC, KCH, NQ, KP, BN, NB = (cfg[k] for k in ("kc", "kch", "nq", "kp", "bn", "nb"))
    CHUNK, CL, AST, S = cfg["chunk"], cfg["cl"], cfg["ast"], cfg["s"]
    PLANE = 16 * 66
    PIX = C * ES
    xb = x.contiguous().view(torch.uint8).reshape(-1).numpy()
    wb = pack_probe_weights(w.reshape(9, C, C), C).view(torch.uint8).reshape(-1).numpy()
    tpr = -(-W // 64)
    n_mt = R * tpr
    out = np.zeros(R * W * PIX, np.uint8)
    written = np.zeros(R * W * PIX, np.int64)
    warp, lane, g, t = _fragment_rows()
    if blocks is None:
        blocks = 3 * CL
    for block, _ in schedule(n_mt, cfg, blocks):
        rank, smem = block % CL, np.zeros(cfg["smem"], np.uint8)
        if cfg["res"]:
            smem[:cfg["w_bytes"]] = wb[:cfg["w_bytes"]]
        na = nc = 0
        n_items = -(-n_mt // (CL * MPB))
        for it in range(block // CL, n_items, blocks // CL):
            mt0 = (it * CL + rank) * MPB
            live = max(0, min(MPB, n_mt - mt0))
            if not concat:  # the producer: this item's tiles into stage na % AST
                stage = cfg["off_a"] + (na % AST) * cfg["a_stage"]
                for i in range(live):
                    mt = mt0 + i
                    box = tma_box(xb, R, Wp, PIX, (mt % tpr) * 64, 0, mt // tpr, 66,
                                  cfg["ch"])
                    at = stage + i * cfg["a_tile"]
                    smem[at:at + box.size] = box
            for nb in range(NB):
                acc = np.zeros((MPB, 64, BN), np.int64 if s8 else np.float64)
                for q in range(NQ):
                    tap, kc = q // KCH, q % KCH
                    slot = cfg["off_ring"] + (nc % S) * cfg["slot"] if cfg["ring"] else 0
                    if concat:
                        for i in range(live):
                            mt = mt0 + i
                            tma_box_swizzled(smem, slot + i * cfg["slice"], xb, R, Wp, PIX,
                                             kc * cfg["sw"], (mt % tpr) * 64 + tap % 3,
                                             mt // tpr, cfg["sw"])
                    if not cfg["res"]:  # every block's part of the chunk
                        part = CHUNK // CL
                        for p in range(CL):
                            src = (nb * NQ + q) * CHUNK + p * part
                            dst = slot + cfg["slot_a"] + p * part
                            smem[dst:dst + part] = wb[src:src + part]
                    b = q * CHUNK if cfg["res"] else slot + cfg["slot_a"]
                    for i in range(live):  # M-tile wg * MT + ii of the block
                        # k-steps of 32 bytes of K; B at b + 256 k, SBO KC * 8 ES.
                        # acc9: s8_tap_issue / bf16_tap_issue<KC, PLANE, 128, BN>,
                        # A at a + 2 k PLANE; concat: swizzled_issue, A at a + 32 k
                        for k in range(KC * ES // 32):
                            if concat:
                                A = desc_read_swizzled(smem, slot + i * cfg["slice"] + 32 * k,
                                                       cfg["sw"], 64, 32)
                            else:
                                a = stage + i * cfg["a_tile"] + kc * KP * PLANE + 16 * (tap % 3)
                                A = desc_read(smem, a + 2 * k * PLANE, PLANE, 128, 64, 32)
                            B = desc_read(smem, b + 256 * k, 128, KC * 8 * ES, BN, 32)
                            acc[i] += values(A, s8) @ values(B, s8).T
                    nc += 1
                for i in range(live):
                    _store_tile(acc[i], out, written, mt0 + i, nb, tpr, W, C, BN, s8,
                                warp, g, t)
            na += 1
    assert (written == 1).all(), "every output byte written once"
    y = torch.from_numpy(out.reshape(R, W, PIX))
    y = y.view(torch.int8) if s8 else y.view(torch.bfloat16)
    return y.reshape(n, Hb, W, C)


def _store_tile(acc, out, written, mt, nb, tpr, W, C, BN, s8, warp, g, t):
    """store_tile: per row half h, the words of each lane (ReLU, the cast
    or bf16 rounding), the quad transpose, and lane t's 16-byte groups
    4 m + t of its pixel's N-block."""
    ES = 1 if s8 else 2
    NW = BN // 16 if s8 else BN // 8
    r, j0 = mt // tpr, (mt % tpr) * 64
    for h in range(2):
        row = 16 * warp + g + 8 * h
        px = j0 + row
        val = acc[row]  # (128, BN): the lane's row of the accumulator

        def a(j, e):  # register 4 j + 2 h + e: channel 8 j + 2 t + e
            return val[np.arange(128), 8 * j + 2 * t + e]

        for m in range(NW // 4):
            v = np.zeros((128, 4), np.int64)
            for i in range(4):
                k = 4 * m + i
                if s8:
                    parts = [a(2 * k, 0), a(2 * k, 1), a(2 * k + 1, 0), a(2 * k + 1, 1)]
                    v[:, i] = sum((np.maximum(p, 0) & 255) << (8 * n) for n, p in enumerate(parts))
                else:
                    lo, hi = (torch.from_numpy(np.maximum(a(k, e), 0).astype(np.float32))
                              .to(torch.bfloat16).view(torch.int16).numpy()
                              .astype(np.int64) & 0xFFFF for e in (0, 1))
                    v[:, i] = lo | (hi << 16)
            v = quad_words(v, t)
            if s8:
                words = [byte_perm(v[:, 0], v[:, 1], 0x5410), byte_perm(v[:, 2], v[:, 3], 0x5410),
                         byte_perm(v[:, 0], v[:, 1], 0x7632), byte_perm(v[:, 2], v[:, 3], 0x7632)]
            else:
                words = [v[:, i] for i in range(4)]
            for lane_id in np.nonzero(px < W)[0]:
                at = ((r * W + px[lane_id]) * C + nb * BN) * ES + (4 * m + t[lane_id]) * 16
                for wi, word in enumerate(words):
                    for byte in range(4):
                        out[at + 4 * wi + byte] = (int(word[lane_id]) >> (8 * byte)) & 255
                written[at:at + 16] += 1


def s8_unit(k):
    """probe_chain.cu's ``s8_unit``: the unit A's column k carries."""
    return (32 * (k // 32) + 8 * (2 * ((k % 32) // 16) + (k % 4) // 2)
            + 2 * ((k % 16) // 4) + k % 2)


def chain_ops(depth, nk):
    """``csrc/probe_chain.cu``'s sequence of one block for ``depth`` layers
    of ``nk`` k-steps (bf16 8, int8 4): ``("issue", half, k-steps,
    parity)`` (a product into accumulator half ``half``; k-step ks reads
    register set ``("lo", parity)`` for ks < nk / 2, ``"hi"`` else; ks 0
    overwrites the accumulators), ``("commit",)``, ``("wait", n)``
    (wgmma.wait_group n), ``("epilogue", half, parity)`` (half 0 writes
    ``("lo", parity)``, half 1 ``"hi"``) and ``("store", half)``:
    ``bf16_layer`` / ``s8_layer`` for layers 1, 2, ... (parity l % 2),
    then the last layer's stores."""
    ops = []
    for layer in range(1, depth + 1):
        p = layer % 2
        ops += [("issue", 0, range(nk), 1 - p), ("commit",), ("issue", 1, range(nk), 1 - p),
                ("commit",), ("wait", 1)]
        if layer == depth:
            return ops + [("store", 0), ("wait", 0), ("store", 1)]
        ops += [("epilogue", 0, p), ("wait", 0), ("epilogue", 1, p)]
    return ops


def _chain_regs(ks, p, m):
    return ("lo", p) if ks < m else ("hi",)


def chain_hazards(ops, nk):
    """Run ``ops`` symbolically: every product of layer l must read x_(l-1)
    (as the registers hold it when its group completes: wgmma reads its A
    registers until then) into an accumulator half that holds layer l's
    sums; an epilogue or store reads a half only with no group pending on
    it and all nk k-steps of one layer summed; an epilogue writes
    registers no pending group reads. Returns the layers stored; raises
    AssertionError on a hazard."""
    m = nk // 2
    held = {("lo", 0): 0, ("lo", 1): None, ("hi",): 0}  # the x_l each set holds
    acc = [None, None]  # (layer, k-steps summed) of each half
    issued, pending, group, stored = [0, 0], [], [], []
    for op in ops:
        if op[0] == "issue":
            _, half, steps, p = op
            steps = list(steps)
            if steps[0] == 0:
                issued[half] += 1
            group += [(half, ks, p, issued[half]) for ks in steps]
        elif op[0] == "commit":
            pending.append(group)
            group = []
        elif op[0] == "wait":
            while len(pending) > op[1]:
                for half, ks, p, layer in pending.pop(0):
                    assert held[_chain_regs(ks, p, m)] == layer - 1, (op, half, ks, layer)
                    if ks == 0:
                        acc[half] = (layer, set())
                    assert acc[half][0] == layer and ks not in acc[half][1]
                    acc[half][1].add(ks)
        else:
            half = op[1]
            busy = [g for grp in pending + [group] for g in grp]
            assert all(g[0] != half for g in busy), op
            assert acc[half] is not None and acc[half][1] == set(range(nk)), op
            if op[0] == "store":
                stored.append(acc[half][0])
                continue
            dst = ("lo", op[2]) if half == 0 else ("hi",)
            assert all(_chain_regs(ks, p, m) != dst for _, ks, p, _ in busy), op
            held[dst] = acc[half][0]
    assert not pending and not group
    return stored


def probe_chain_model(x, w, depth):
    """``probe_chain`` as the kernel addresses it, on the CPU: the staged B
    halves, the register fragments and the epilogues from the kernel's
    expressions, run in ``chain_ops``' order; each product reads its A
    registers when its group completes (the latest the card may), so an
    epilogue that overwrote them early would show in the result."""
    s8 = x.dtype == torch.int8
    K = 128
    R = x.shape[0]
    ES = 1 if s8 else 2
    nk = 4 if s8 else 8
    m, kw = nk // 2, 32 if s8 else 16  # k-steps a register set, K columns a k-step
    xn = x.contiguous().view(torch.uint8).numpy().reshape(R, K * ES)
    wn = w.contiguous().view(torch.uint8).numpy().reshape(K, -1)
    # the staged B operand, bytes, as stage_w writes it: thread n's 16-byte
    # row c at ((n / 8) chunks + c) 128 + (n % 8) 16, byte b of it from
    # row s8_unit(16 c + b) of w (int8) or half-word b / 2 of row 8 c + b / 2
    chunks = K * K * ES // 16 // 128
    sw = np.zeros(K * K * ES, np.uint8)
    nn, c, b = np.meshgrid(np.arange(K), np.arange(chunks), np.arange(16), indexing="ij")
    at = ((nn // 8) * chunks + c) * 128 + (nn % 8) * 16 + b
    if s8:
        sw[at] = wn[s8_unit(16 * c + b), nn]
    else:
        sw[at] = wn[8 * c + b // 2, 2 * nn + b % 2]
    # B of (half, k-step): m64n64, half c at 8 core-matrix rows of N on
    sbo = 1024 if s8 else 2048
    B = {(c, ks): values(desc_read(sw, c * 8 * sbo + ks * 256, 128, sbo, 64, 32), s8)
         for c in range(2) for ks in range(nk)}
    warp, lane, g, t = _fragment_rows()
    if s8:
        q = lambda v: (np.clip(v >> 7, -127, 127) & 255).astype(np.uint32)  # noqa: E731
    else:
        q = lambda v: (torch.from_numpy(np.maximum(v, 0).astype(np.float32))  # noqa: E731
                       .to(torch.bfloat16).view(torch.int16).numpy()
                       .astype(np.uint32) & 0xFFFF)
    out = np.zeros((R, K * ES), np.uint8)
    for blk in range(-(-R // 64)):
        rows = [blk * 64 + 16 * warp + g + 8 * h for h in range(2)]
        inside = [r < R for r in rows]
        # register sets: word [thread, k-step of the set, register 2 e + h]
        regs = {("lo", 0): np.zeros((128, m, 4), np.uint32),
                ("lo", 1): np.zeros((128, m, 4), np.uint32),
                ("hi",): np.zeros((128, m, 4), np.uint32)}
        for h in range(2):
            rr = np.where(inside[h], rows[h], 0)
            for ks in range(nk):
                for e in range(2):
                    if s8:
                        col = 32 * ks + 16 * e + 2 * t
                        word = sum(xn[rr, col + b].astype(np.uint32) << (8 * i)
                                   for i, b in enumerate((0, 1, 8, 9)))
                    else:
                        col = 2 * (16 * ks + 8 * e + 2 * t)
                        word = sum(xn[rr, col + b].astype(np.uint32) << (8 * b) for b in range(4))
                    regs[_chain_regs(ks, 0, m)][:, ks % m, 2 * e + h] = np.where(inside[h], word, 0)

        def a_matrix(ks, p):
            """A of k-step ks from the registers: register 2 e + h of lane
            (g, t) holds row 16 warp + g + 8 h, columns 16 e + 4 t + {0..3}
            (int8) or 8 e + 2 t + {0, 1} (bf16) of the k-step"""
            A = np.zeros((64, kw), np.int64 if s8 else np.float64)
            for e in range(2):
                for h in range(2):
                    word = regs[_chain_regs(ks, p, m)][:, ks % m, 2 * e + h]
                    row = 16 * warp + g + 8 * h
                    if s8:
                        for i in range(4):
                            byte = ((word >> (8 * i)) & 255).astype(np.uint8)
                            A[row, 16 * e + 4 * t + i] = byte.view(np.int8)
                    else:
                        for i in range(2):
                            half = ((word >> (16 * i)) & 0xFFFF).astype(np.uint32) << 16
                            A[row, 8 * e + 2 * t + i] = half.view(np.float32)
            return A

        D = [np.zeros((64, 64), np.int64 if s8 else np.float64) for _ in range(2)]
        pending, group = [], []

        def acc(c, j, h, i):  # d[c][4 j + 2 h + i]: row 16 warp + g + 8 h, column 8 j + 2 t + i
            v = D[c][16 * warp + g + 8 * h, 8 * j + 2 * t + i]
            return v if s8 else v.astype(np.float32).astype(np.float64)

        for op in chain_ops(depth, nk):
            if op[0] == "issue":
                group += [(op[1], ks, op[3]) for ks in op[2]]
            elif op[0] == "commit":
                pending.append(group)
                group = []
            elif op[0] == "wait":
                while len(pending) > op[1]:
                    for c, ks, p in pending.pop(0):
                        if ks == 0:
                            D[c][:] = 0
                        D[c] += a_matrix(ks, p) @ B[(c, ks)].T
            elif op[0] == "epilogue":
                c, p = op[1], op[2]
                dst = regs[("lo", p) if c == 0 else ("hi",)]
                for qq in range(m):  # s8_epilogue / bf16_epilogue of half c
                    for e in range(2):
                        for h in range(2):
                            if s8:
                                j = 4 * qq + 2 * e
                                parts = (acc(c, j, h, 0), acc(c, j, h, 1),
                                         acc(c, j + 1, h, 0), acc(c, j + 1, h, 1))
                                word = sum(q(v) << (8 * i) for i, v in enumerate(parts))
                            else:
                                j = 2 * qq + e
                                word = q(acc(c, j, h, 0)) | q(acc(c, j, h, 1)) << 16
                            dst[:, qq, 2 * e + h] = word
            else:  # the last layer's store of half c
                c = op[1]
                for h in range(2):
                    keep = inside[h]
                    for j in range(8):
                        for i in range(2):
                            col = (64 * c + 8 * j + 2 * t + i) * ES
                            v = q(acc(c, j, h, i))
                            out[rows[h][keep], col[keep]] = v[keep] & 255
                            if not s8:
                                out[rows[h][keep], col[keep] + 1] = (v[keep] >> 8) & 255
    y = torch.from_numpy(out)
    return y.view(torch.int8) if s8 else y.view(torch.bfloat16).reshape(R, K)
