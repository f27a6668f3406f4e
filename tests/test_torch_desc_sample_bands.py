"""The ring instance's band plan (``spnerf_tpu_torch/kernels/
desc_sample.py``'s Python statement of ``csrc/desc_sample.cu``'s row
bucketing, band split and load schedule), on the CPU: every point lands
in exactly one band, its four clamped tap rows lie in the rows that band
loads, the ring never overwrites a row that a pending point still needs
(with the producer as far ahead as its barriers let it run), and the
bands share the work.
"""

import numpy as np
import pytest
import torch

from spnerf_tpu_torch.kernels.desc_sample import (
    RING,
    RING_ROW_COST,
    RING_SLOTS,
    RING_SMEM_MAX,
    axis_taps,
    band_rows,
    base_rows,
    default_bands,
    instance,
    ring_bytes,
    ring_loads,
)

G = 8


def _points(kind, rng, B, Hc, K):
    """(B, K) y pixel coordinates of one kind of point set."""
    h = Hc * G - 1
    if kind == "random":
        return rng.uniform(0, h, (B, K))
    if kind == "crowded":  # four fifths in the top quarter
        top = rng.uniform(0, h / 4, (B, K))
        return np.where(rng.uniform(size=(B, K)) < 0.8, top,
                        rng.uniform(0, h, (B, K)))
    if kind == "border":  # the first and last rows, on and near the edge
        return rng.choice([0.0, 0.5, 3.5, h - 3.5, h - 0.5, h], (B, K))
    if kind == "out-of-map":  # beyond either border, far and near
        return rng.choice([-1e6, -40.0, -12.0, -4.5, h + 4.5, h + 12.0,
                           h + 40.0, 1e6], (B, K))
    if kind == "single-row":  # one bucket holds every point
        return np.full((B, K), G * (Hc // 2) + 3.25)
    raise ValueError(kind)


def _simulate(r0, r1, lo, hi, Hc, taps_by_base):
    """Run the band's schedule with the producer loading every row its
    barriers allow before each base row; assert each point's tap rows are
    resident (copied) when its base row is processed."""
    counts = [len(taps_by_base.get(r, [])) for r in range(r0, r1)]
    loads = ring_loads(r0, r1, Hc, counts)
    assert [y for y, *_ in loads] == list(range(lo, hi + 1))
    slots = [None] * RING_SLOTS
    released, issued = set(), 0
    for r in range(r0, r1):
        while issued < len(loads):
            y, slot, replaces, copied = loads[issued]
            if replaces is not None and replaces not in released:
                break
            # the slot holds the row this one replaces, released by now
            assert (slots[slot] or (None,))[0] == replaces
            slots[slot] = (y, copied)
            issued += 1
        # the consumers wait on rows up to r + 2: they must be issued
        assert issued == len(loads) or loads[issued][0] > min(r + 2, hi)
        for rows in taps_by_base.get(r, []):
            for y in rows:
                assert slots[(y - lo) % RING_SLOTS] == (y, True), (r, y)
        if r - 1 >= lo:
            released.add(r - 1)
    assert issued == len(loads)


@pytest.mark.parametrize("kind", ["random", "crowded", "border",
                                  "out-of-map", "single-row"])
@pytest.mark.parametrize("B,Hc,bands", [(1, 60, 60), (2, 60, 7), (3, 60, 2),
                                        (2, 30, 1), (1, 3, 1), (1, 3, 3),
                                        (2, 7, 2), (1, 5, 4)])
def test_ring_band_plan(kind, B, Hc, bands):
    rng = np.random.default_rng(Hc * 100 + bands)
    K = 97
    y = torch.from_numpy(_points(kind, rng, B, Hc, K).astype(np.float32))
    base = base_rows(y, Hc, G)
    iy = torch.stack(axis_taps(y, Hc, G)[0], -1)  # (B, K, 4) tap rows
    for b in range(B):
        counts = torch.bincount(base[b], minlength=Hc).tolist()
        plan = band_rows(counts, bands)
        # the bands tile [0, Hc), each with at least one base row
        assert len(plan) == bands
        assert plan[0][0] == 0 and plan[-1][1] == Hc
        assert all(a[1] == c[0] for a, c in zip(plan, plan[1:]))
        assert all(r1 > r0 for r0, r1, _, _ in plan)
        owners = torch.zeros(K, dtype=torch.int64)
        for r0, r1, lo, hi in plan:
            mine = (base[b] >= r0) & (base[b] < r1)
            owners += mine
            rows = iy[b][mine]
            assert bool(((rows >= lo) & (rows <= hi)).all())
            taps = {}
            for k in torch.nonzero(mine).flatten().tolist():
                taps.setdefault(int(base[b, k]), []).append(
                    sorted(set(iy[b, k].tolist())))
            _simulate(r0, r1, lo, hi, Hc, taps)
        assert bool((owners == 1).all())


def test_bands_balance_points_and_rows():
    """Points spread evenly: the bands split the rows evenly. Points
    crowded into the top quarter: the top band holds few rows, and no
    band holds more than its share of the work (points plus
    RING_ROW_COST a row) by more than one row's weight."""
    assert [r[:2] for r in band_rows([17] * 60, 2)] == [(0, 30), (30, 60)]
    assert [r[:2] for r in band_rows([0] * 60, 4)] == [
        (0, 15), (15, 30), (30, 45), (45, 60)]
    counts = [48] * 15 + [4] * 45
    plan = band_rows(counts, 2)
    assert plan[0][1] < 30
    weights = [sum(counts[r0:r1]) + RING_ROW_COST * (r1 - r0)
               for r0, r1, _, _ in plan]
    assert max(weights) - sum(weights) / 2 <= 48 + RING_ROW_COST


def test_default_bands_and_instances():
    """Two bands at the path's B 64 on 132 SMs; at most one a base row;
    the ring takes the path's bf16 map; a float32 map, C % 8 != 0 or rows
    too wide for five slots go to the gather."""
    assert default_bands(64, 60, 132) == 2
    assert default_bands(1, 60, 132) == 60
    assert default_bands(200, 60, 132) == 1
    assert default_bands(2, 3, 132) == 3
    assert instance(torch.bfloat16, 60, 80, 256, 1024) == RING
    assert ring_bytes(60, 80, 256, 1024) == (
        128 + 5 * 40960 + 4 * (2 * 61 + 1024))
    assert instance(torch.bfloat16, 60, 80, 256, 1024)[0] == \
        "desc_sample[bf16]"
    assert instance(torch.float32, 60, 80, 256, 1024)[0] == \
        "desc_sample[f32]"
    assert instance(torch.bfloat16, 6, 5, 20, 50)[0] == \
        "desc_sample[bf16-gather]"
    wide = instance(torch.bfloat16, 10, 120, 256, 64)
    assert wide[0] == "desc_sample[bf16-gather]"
    assert ring_bytes(10, 120, 256, 64) > RING_SMEM_MAX
