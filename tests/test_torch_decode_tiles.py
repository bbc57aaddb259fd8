"""The index math of the bf16 decode kernels' tensor-core matrix phase
(``midi_model_tpu_torch/csrc/decode.cuh`` ``tc_phase``), emulated on the CPU.

The kernels cannot run here, so these tests rebuild what their lanes do from
the constants in the CUDA source:

- the weight box as TMA writes it with the 128-byte swizzle, the staged
  activation segment with its 16-byte XOR swizzle, the ``ldmatrix`` lane
  addresses the kernel computes, and the ``mma.sync.m16n8k16`` fragment
  layout of the PTX ISA, which together must reproduce W @ x;
- the tile plan (which block takes which item, which warp which k) and the
  order of the reduction, which must give the same bits for any grid size;
- the staging of an activation segment by a thread-block cluster
  (``stage_segment``, ``row_scales``): each block loads and norms its share
  of the rows and writes each unit once into every block, which must end
  with the bits one block staging every row holds;
- the host-side helpers the phase clock added (``phase_kinds``,
  ``phase_clock``, and ``chip_smoke.phase_clock_summary``).
"""

from __future__ import annotations

import re
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "midi_model_tpu_torch" / "csrc"


def _constants() -> dict:
    src = (CSRC / "decode.cuh").read_text() + (CSRC / "common.cuh").read_text()
    found = {}
    for name in ("kDecThreads", "kTcRows", "kTcBoxK", "kTcBoxRows", "kTcSegK", "kDecCluster",
                 "kTcMaxCluster"):
        m = re.search(rf"constexpr (?:int|size_t) {name} = (\d+);", src)
        assert m, f"{name} not found in decode.cuh"
        found[name] = int(m.group(1))
    return found


C = _constants()
WARPS = C["kDecThreads"] // 32
ROWS, BOX_K, BOX_ROWS, SEG_K = C["kTcRows"], C["kTcBoxK"], C["kTcBoxRows"], C["kTcSegK"]
CHUNK_K = BOX_K * WARPS
LANES = np.arange(32)
CLUSTERS = (1, 2, 4)  # the cluster sizes stage_segment takes (kTcMaxCluster)


def bf16_values(rng, shape) -> np.ndarray:
    """Random values that bf16 holds exactly, as float32."""
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(
        torch.bfloat16).float().numpy()


# ---- shared memory as the kernel lays it out -----------------------------------

def tma_box(w: np.ndarray, row0: int, k0: int) -> np.ndarray:
    """The 2048 bytes (as 1024 bf16 slots) a 16 x 64 TMA box of w lands as
    with CU_TENSOR_MAP_SWIZZLE_128B: the 16-byte chunk c of row r at chunk
    c ^ (r % 8) of the row's 128 bytes; reads past w's edges are zeros."""
    box = np.zeros(BOX_ROWS * BOX_K, np.float32)
    for r in range(BOX_ROWS):
        for k in range(BOX_K):
            rr, kk = row0 + r, k0 + k
            v = w[rr, kk] if rr < w.shape[0] and kk < w.shape[1] else 0.0
            box[(r * 128 + ((k // 8) ^ (r % 8)) * 16 + (k % 8) * 2) // 2] = v
    return box


def act_offset(n: int, u: int) -> int:
    """decode.cuh act_offset: byte offset of unit u of row n."""
    return n * SEG_K * 2 + ((u ^ (n & 7)) << 4)


def staged_segment(x: np.ndarray, r0: int, k0: int) -> np.ndarray:
    """decode.cuh stage_segment: rows r0.. of x [B, K], k0.., as bf16 slots."""
    b, k_total = x.shape
    kn = min(SEG_K, -(-k_total // BOX_K) * BOX_K - k0)
    seg = np.full(ROWS * SEG_K, np.nan, np.float32)  # unstaged bytes poison a read
    for n in range(ROWS):
        for u in range(kn // 8):
            for i in range(8):
                k = k0 + 8 * u + i
                v = x[r0 + n, k] if r0 + n < b and k < k_total else 0.0
                seg[(act_offset(n, u) + 2 * i) // 2] = v
    return seg


def ldmatrix_x4(mem: np.ndarray, byte_addr: np.ndarray) -> np.ndarray:
    """ldmatrix.m8n8.x4 (no .trans): lanes 8i .. 8i+7 give the rows of matrix
    i; register i of lane t holds row t // 4, elements 2(t % 4) and +1 of
    matrix i.  Returns [32 lanes, 4 registers, 2 values]."""
    out = np.empty((32, 4, 2), np.float32)
    for t in range(32):
        for i in range(4):
            row = byte_addr[8 * i + t // 4] // 2
            out[t, i] = mem[row + 2 * (t % 4): row + 2 * (t % 4) + 2]
    return out


def mma_16816(c: np.ndarray, a: np.ndarray, b0: np.ndarray, b1: np.ndarray) -> None:
    """mma.sync.m16n8k16 .row.col on lane fragments (PTX ISA layouts):
    a[t] = (a0, a1, a2, a3) at A rows g, g+8, g, g+8 and k 2q.., 2q.., 2q+8..,
    2q+8..; b0[t] / b1[t] at B k 2q.. / 2q+8.. and column g; c[t] = (c0..c3)
    at C row g (c0, c1) and g + 8 (c2, c3), columns 2q, 2q+1; g = t // 4,
    q = t % 4.  Accumulates in f32 in place."""
    A = np.zeros((16, 16), np.float32)
    B = np.zeros((16, 8), np.float32)
    for t in range(32):
        g, q = t // 4, t % 4
        A[g, 2 * q:2 * q + 2] = a[t, 0]
        A[g + 8, 2 * q:2 * q + 2] = a[t, 1]
        A[g, 2 * q + 8:2 * q + 10] = a[t, 2]
        A[g + 8, 2 * q + 8:2 * q + 10] = a[t, 3]
        B[2 * q:2 * q + 2, g] = b0[t]
        B[2 * q + 8:2 * q + 10, g] = b1[t]
    D = (A.astype(np.float64) @ B.astype(np.float64)).astype(np.float32)
    for t in range(32):
        g, q = t // 4, t % 4
        c[t, 0:2] += D[g, 2 * q:2 * q + 2]
        c[t, 2:4] += D[g + 8, 2 * q:2 * q + 2]


# ---- the tile plan ----------------------------------------------------------------

def block_items(n_items: int, block: int, grid: int) -> list:
    """decode.cuh block_items: item i belongs to block i % grid."""
    return list(range(block, n_items, grid))


def chunk_order(n_items: int, k_total: int, mt: int, rows: int, block: int, grid: int):
    """The chunks a block streams through its ring, in Tc::issue's order:
    pass by pass, item by item, k-chunk by k-chunk, m-tile by m-tile."""
    nkc = -(-k_total // CHUNK_K)
    return [(p, g, kc, m) for p in range(-(-rows // ROWS))
            for g in block_items(n_items, block, grid)
            for kc in range(nkc) for m in range(mt)]


def emulate_phase(ws, x: np.ndarray, grid: int) -> np.ndarray:
    """out[b, col, m] = sum_k x[b, k] * ws[m][col, k] for the MT = len(ws)
    weights, as tc_phase computes it on `grid` blocks: every block's items,
    every warp's boxes, the lanes' fragments, the partial sums per warp in
    f32 and their reduction in warp order."""
    mt = len(ws)
    n_cols, k_total = ws[0].shape
    rows = x.shape[0]
    n_items = -(-n_cols // BOX_ROWS)
    out = np.full((rows, n_cols, mt), np.nan, np.float32)
    for block in range(grid):
        chunks = chunk_order(n_items, k_total, mt, rows, block, grid)
        acc = None
        for p, g, kc, m in chunks:
            if kc == 0 and m == 0:  # a new item
                acc = np.zeros((mt, WARPS, 32, ROWS // 8, 4), np.float32)
            r0 = p * ROWS
            nt = min(ROWS // 8, -(-(rows - r0) // 8))
            seg = kc * CHUNK_K // SEG_K
            act = staged_segment(x, r0, seg * SEG_K)
            for warp in range(WARPS):
                k0 = kc * CHUNK_K + warp * BOX_K
                if k0 >= k_total:
                    continue
                box = tma_box(ws[m], g * BOX_ROWS, k0)
                ku = (k0 - seg * SEG_K) // 8
                mi, mr = LANES >> 3, LANES & 7
                for kk in range(BOX_K // 16):
                    ar = (mi & 1) * 8 + mr
                    a = ldmatrix_x4(box, ar * 128 + (((2 * kk + (mi >> 1)) ^ (ar & 7)) << 4))
                    for j in range(0, ROWS // 8, 2):
                        if j >= nt:
                            continue
                        bn = 8 * (j + (mi >> 1)) + mr
                        b = ldmatrix_x4(act, np.array([act_offset(n, u) for n, u in zip(
                            bn, ku + 2 * kk + (mi & 1))]))
                        mma_16816(acc[m, warp, :, j], a, b[:, 0], b[:, 1])
                        if j + 1 < nt:
                            mma_16816(acc[m, warp, :, j + 1], a, b[:, 2], b[:, 3])
            last = kc == -(-k_total // CHUNK_K) - 1 and m == mt - 1
            if last:  # the reduction in warp order, then the epilogue
                for mm in range(mt):
                    red = np.zeros((WARPS, BOX_ROWS, ROWS), np.float32)
                    for t in range(32):
                        row, col = t >> 2, 2 * (t & 3)
                        for j in range(ROWS // 8):
                            red[:, row, 8 * j + col:8 * j + col + 2] = acc[mm, :, t, j, 0:2]
                            red[:, row + 8, 8 * j + col:8 * j + col + 2] = acc[mm, :, t, j, 2:4]
                    total = red[0].copy()
                    for w in range(1, WARPS):
                        total = (total + red[w]).astype(np.float32)
                    for mcol in range(BOX_ROWS):
                        for n in range(ROWS):
                            col, b = g * BOX_ROWS + mcol, r0 + n
                            if col < n_cols and b < rows:
                                out[b, col, mm] = total[mcol, n]
    return out


# ---- staging by a cluster ------------------------------------------------------

def bf16_round(a) -> np.ndarray:
    """f32 values rounded to bf16 (to nearest, ties to even), as f32."""
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(
        torch.bfloat16).float().numpy()


def fma_chain(values: np.ndarray) -> np.ndarray:
    """sum of v * v over the last axis in order, one rounding to f32 a term
    (the kernels' fused multiply-adds)."""
    s = np.zeros(values.shape[:-1], np.float32)
    for j in range(values.shape[-1]):
        s = (s.astype(np.float64) + values[..., j].astype(np.float64) ** 2).astype(np.float32)
    return s


def butterfly(lanes: np.ndarray) -> np.ndarray:
    """warp_sum over the last axis (32 lanes): xor-shuffle adds in f32; every
    lane ends with the same value (a + b == b + a), lane 0's returned."""
    x = lanes.astype(np.float32)
    for off in (16, 8, 4, 2, 1):
        x = (x + x[..., LANES ^ off]).astype(np.float32)
    assert (x == x[..., :1]).all()
    return x[..., 0]


def rsqrt_mean(s: np.ndarray, k_total: int, eps: float) -> np.ndarray:
    return (1.0 / np.sqrt((s / np.float32(k_total)).astype(np.float32) + np.float32(eps))
            ).astype(np.float32)


def whole_row_scales(x: np.ndarray, eps: float) -> np.ndarray:
    """stage_segment's rs of each row of x [B, K <= kTcSegK]: each unit's
    sum of squares, lane l adds units l, l + 32, .. in order, the butterfly."""
    units_ss = fma_chain(x.reshape(x.shape[0], -1, 8))  # [B, units]
    lanes = np.zeros((x.shape[0], 32), np.float32)
    for v in range(units_ss.shape[1]):
        lanes[:, v % 32] = (lanes[:, v % 32] + units_ss[:, v]).astype(np.float32)
    return rsqrt_mean(butterfly(lanes), x.shape[1], eps)


def wide_row_scales(x: np.ndarray, eps: float) -> np.ndarray:
    """row_scales' rs of each row of x [B, K]: lane l takes k = 8l + 256j ..
    8l + 256j + 7 for j = 0, 1, .. in order; the butterfly."""
    b, k_total = x.shape
    per_lane = x.reshape(b, k_total // 256, 32, 8).transpose(0, 2, 1, 3).reshape(b, 32, -1)
    return rsqrt_mean(butterfly(fma_chain(per_lane)), k_total, eps)


def block_units(rank: int, ranks: int, units: int) -> list:
    """The units (row, unit) each thread of block `rank` of a cluster of
    `ranks` stages (stage_segment), in order: its rows rank * 32 / ranks ..
    in rounds of the whole rows whose units fit 8 a thread, units e = tid +
    256 i of a round's rows."""
    threads = C["kDecThreads"]
    per = ROWS // ranks
    round_rows = min(per, 8 * threads // units)
    out = []
    for n0 in range(rank * per, (rank + 1) * per, round_rows):
        owned = min(round_rows, (rank + 1) * per - n0) * units
        for t in range(threads):
            for i in range(8):
                e = t + threads * i
                if e < owned:
                    out.append((n0 + e // units, e % units))
    assert len(out) == per * units  # every unit of the block's rows, once
    return out


def row_scales_rows(rows: int, rank: int, ranks: int) -> list:
    """decode.cuh row_scales: the rows the warps of block `rank` take."""
    per = ROWS // ranks
    got = []
    for warp in range(WARPS):
        i = warp
        while (b := i // per * ROWS + rank * per + i % per) < rows:
            got.append(b)
            i += WARPS
    return got


def slots(n: np.ndarray, u: np.ndarray) -> np.ndarray:
    """The bf16 slots of units (n, u) of the staged segment: [..., 8]."""
    return (n * SEG_K * 2 + ((u ^ (n & 7)) << 4))[..., None] // 2 + np.arange(8)


def stage_by_cluster(x: np.ndarray, w, eps: float, r0: int, k0: int, ranks: int):
    """Every block of a cluster of `ranks` running stage_segment for the pass
    at r0 and the segment at k0 of x [B, K] (norm weight w, or None), with
    the row scales of row_scales (rows wider than a segment) or of its own
    staged sums.  Returns each block's segment (bf16 slots; NaN where
    nothing was written), the writes of finished units [block written to,
    row, unit] and the blocks that took each row's scale {row: [block]}."""
    b, k_total = x.shape
    kn = min(SEG_K, -(-k_total // BOX_K) * BOX_K - k0)
    units = kn // 8
    whole = w is not None and k_total <= SEG_K
    per = ROWS // ranks
    # the loads: zeros past B and past K
    raw = np.zeros((ROWS, kn), np.float32)
    rows_in = max(0, min(ROWS, b - r0))
    k_in = max(0, min(kn, k_total - k0))
    raw[:rows_in, :k_in] = x[r0:r0 + rows_in, k0:k0 + k_in]
    raw = raw.reshape(ROWS, units, 8)
    segs = np.full((ranks, ROWS * SEG_K), np.nan, np.float32)
    writes = np.zeros((ranks, ROWS, units), np.int64)
    scaled = {}
    if w is not None and not whole:
        for rank in range(ranks):
            for row in row_scales_rows(b, rank, ranks):
                scaled.setdefault(row, []).append(rank)
        rs = wide_row_scales(x, eps)
    for rank in range(ranks):
        walk = np.array(block_units(rank, ranks, units))
        n, u = walk[:, 0], walk[:, 1]
        vals = raw[n, u]
        if w is not None:
            if whole:  # a warp per per / 8 rows, from this block's own sums
                got = sorted({(nn, uu) for nn, uu in zip(n, u)})
                assert got == [(nn, uu) for nn in range(rank * per, rank * per + per)
                               for uu in range(units)], "a row's units staged elsewhere"
                for warp in range(WARPS):
                    for r in range(per // WARPS):
                        row = r0 + rank * per + warp * (per // WARPS) + r
                        if row < b:
                            scaled.setdefault(row, []).append(rank)
                rs = np.zeros(r0 + ROWS, np.float32)
                rs[r0:r0 + rows_in] = whole_row_scales(raw[:rows_in].reshape(rows_in, -1)[
                    :, :k_total], eps)
            live = (r0 + n < b) & (k0 + 8 * u < k_total)
            r = rs[np.minimum(r0 + n, len(rs) - 1)][:, None]
            wk = (w if whole else w[k0:])[np.minimum(8 * u, k_total - k0 - 8)[:, None]
                                          + np.arange(8)]
            normed = bf16_round(bf16_round(vals * r).astype(np.float64) * wk)
            vals = np.where(live[:, None], normed, vals)
        for dest in range(ranks):
            segs[dest][slots(n, u)] = vals
            np.add.at(writes[dest], (n, u), 1)
    return segs, writes, scaled


def one_block_segment(x: np.ndarray, w, eps: float, r0: int, k0: int) -> np.ndarray:
    """The segment one block stages, from the plain RMSNorm rounding points
    (T(w * T(x * rs))) and each row's scale taken over the whole row."""
    b, k_total = x.shape
    kn = min(SEG_K, -(-k_total // BOX_K) * BOX_K - k0)
    units = kn // 8
    seg = np.full(ROWS * SEG_K, np.nan, np.float32)
    n, u = np.meshgrid(np.arange(ROWS), np.arange(units), indexing="ij")
    vals = np.zeros((ROWS, kn), np.float32)
    rows_in = max(0, min(ROWS, b - r0))
    k_in = max(0, min(kn, k_total - k0))
    vals[:rows_in, :k_in] = x[r0:r0 + rows_in, k0:k0 + k_in]
    if w is not None and rows_in:
        rs = (whole_row_scales if k_total <= SEG_K else wide_row_scales)(x, eps)
        normed = bf16_round(bf16_round(vals[:rows_in, :k_in] * rs[r0:r0 + rows_in, None])
                            .astype(np.float64) * w[k0:k0 + k_in])
        vals[:rows_in, :k_in] = normed
    seg[slots(n, u)] = vals.reshape(ROWS, units, 8)
    return seg


def test_cluster_constants():
    assert C["kDecCluster"] in CLUSTERS and C["kTcMaxCluster"] == max(CLUSTERS)
    assert all(ROWS % c == 0 and ROWS // c % WARPS == 0 for c in CLUSTERS)


@pytest.mark.parametrize("norm", [False, True], ids=["raw", "normed"])
@pytest.mark.parametrize("k_total", [1024, 2048, 4096])
@pytest.mark.parametrize("b", [1, 7, 32, 33, 64])
@pytest.mark.parametrize("ranks", CLUSTERS)
def test_cluster_staging_matches_one_block(ranks, b, k_total, norm):
    """Every block of a cluster ends each pass holding the segment one block
    stages, bit for bit; each (row, unit) lands once in each block; every
    row's scale is taken once in the cluster, by the block that stages the
    row, in the order one block takes it (so the scales are the same)."""
    rng = np.random.default_rng(b * 7919 + k_total + ranks)
    x = bf16_values(rng, (b, k_total))
    w = bf16_values(rng, (k_total,)) + 1.0 if norm else None
    eps = 1e-5
    # the whole-row path stages one segment; a wider row's every segment
    segments = [0] if norm and k_total <= SEG_K else range(0, k_total, SEG_K)
    for r0 in range(0, b, ROWS):
        for k0 in segments:
            want = one_block_segment(x, w, eps, r0, k0)
            segs, writes, scales = stage_by_cluster(x, w, eps, r0, k0, ranks)
            written = ~np.isnan(want)
            for blk in range(ranks):
                assert (~np.isnan(segs[blk]) == written).all()
                assert segs[blk][written].tobytes() == want[written].tobytes()
            assert (writes == 1).all()
            if not norm:
                assert not scales
                continue
            # whole rows: this pass's rows; row_scales: every row, once a phase
            want_rows = range(r0, min(b, r0 + ROWS)) if k_total <= SEG_K else range(b)
            assert sorted(scales) == list(want_rows)
            for row, blocks in scales.items():
                assert blocks == [row % ROWS // (ROWS // ranks)]


@pytest.mark.parametrize("ranks", CLUSTERS)
@pytest.mark.parametrize("n_items,grid", [(192, 132), (64, 132), (64, 128), (256, 132),
                                          (5, 8)])
def test_cluster_blocks_stage_in_step(ranks, n_items, grid):
    """tc_phase: every block of a cluster runs the items of the cluster's
    first block (the most in the cluster), so they stage the same segments
    in the same order, and no block has more items than that."""
    grid -= grid % ranks
    for lead in range(0, grid, ranks):
        steps = len(block_items(n_items, lead, grid))
        for block in range(lead, lead + ranks):
            assert len(block_items(n_items, block, grid)) <= steps
    # the cluster's blocks together own every item once
    owned = sorted(i for blk in range(grid) for i in block_items(n_items, blk, grid))
    assert owned == list(range(n_items))


@pytest.mark.parametrize("n_cols,k_total,rows,mt", [
    (40, 1024, 37, 1),   # a ragged item (rows past the weight read as zeros), two passes
    (16, 2048, 8, 1),    # two staged segments
    (20, 576, 12, 2),    # gate/up items; K not a multiple of the chunk
])
def test_fragments_reproduce_the_product(n_cols, k_total, rows, mt):
    rng = np.random.default_rng(n_cols + k_total + rows)
    ws = [bf16_values(rng, (n_cols, k_total)) for _ in range(mt)]
    x = bf16_values(rng, (rows, k_total))
    got = emulate_phase(ws, x, grid=2)
    for m in range(mt):
        ref = x.astype(np.float64) @ ws[m].astype(np.float64).T
        # f32 partial sums: the only difference from the f64 product
        np.testing.assert_allclose(got[..., m], ref, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("grids", [(1, 3), (2, 5)])
def test_plan_and_reduction_do_not_depend_on_the_grid(grids):
    rng = np.random.default_rng(7)
    ws = [bf16_values(rng, (48, 1536)) for _ in range(2)]
    x = bf16_values(rng, (9, 1536))
    first, second = (emulate_phase(ws, x, grid=g) for g in grids)
    assert not np.isnan(first).any()
    assert first.tobytes() == second.tobytes()


@pytest.mark.parametrize("n_items,grid", [(192, 132), (64, 132), (213, 97), (5, 8)])
def test_every_item_belongs_to_one_block(n_items, grid):
    owners = [b for b in range(grid) for _ in block_items(n_items, b, grid)]
    assert sorted(i for b in range(grid) for i in block_items(n_items, b, grid)) == list(
        range(n_items))
    assert len(owners) == n_items
    # an even spread: no block has more than one item above another
    counts = [len(block_items(n_items, b, grid)) for b in range(grid)]
    assert max(counts) - min(counts) <= 1


@pytest.mark.parametrize("b", [1, 8, 32, 37, 128, 256])
def test_chunk_order_covers_each_pass_item_and_chunk_once(b):
    grid, n_items = 132, 4096 // BOX_ROWS  # the event net's gate/up
    seen = set()
    for block in range(grid):
        chunks = chunk_order(n_items, 1024, 2, b, block, grid)
        assert len(chunks) == len(set(chunks))
        seen.update(chunks)
    assert len(seen) == -(-b // ROWS) * n_items * 2 * 2


def test_swizzles_are_conflict_free():
    """The 8 row addresses of each ldmatrix 8x8 matrix fall in distinct
    16-byte bank groups, in the weight box and in the staged segment."""
    mi, mr = LANES >> 3, LANES & 7
    for kk in range(BOX_K // 16):
        ar = (mi & 1) * 8 + mr
        addr = ar * 128 + (((2 * kk + (mi >> 1)) ^ (ar & 7)) << 4)
        for i in range(4):
            assert len({(a % 128) // 16 for a in addr[8 * i:8 * i + 8]}) == 8
    for ku in range(0, SEG_K // 8, 2):
        for j in range(0, ROWS // 8, 2):
            addr = [act_offset(8 * (j + (i >> 1)) + r, ku + (i & 1))
                    for i in range(4) for r in range(8)]
            for i in range(4):
                assert len({(a % 128) // 16 for a in addr[8 * i:8 * i + 8]}) == 8


def test_phase_kinds_count_the_kernels_barriers():
    from midi_model_tpu_torch.ops import fused_step as fs
    from midi_model_tpu_torch.ops import token_loop as tl

    kinds = tl.phase_kinds(3, 8)
    assert len(kinds) == 8 * (3 * 5 + 2)  # token_row.cuh: 5 phases a layer, 2 a step
    assert kinds[:5] == ["norm+qkv", "attention", "o-proj", "gate/up", "down"]
    assert kinds[15:17] == ["lm_head", "sample"]
    assert fs.phase_kinds(12) == ["norm+qkv", "attention", "o-proj", "gate/up", "down"] * 12
    clock = tl.phase_clock(len(kinds) - 1, "cpu")
    assert clock.dtype == torch.int64 and clock.shape == (2 * len(kinds),)
    assert int(clock.abs().sum()) == 0


def test_phase_clock_summary():
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    kinds = ["a", "b", "a"]
    # starts 1000, 5000, 9000 ns; last arrivals 4000, 8000, 10000
    clock = torch.tensor([1000, 4000, 5000, 8000, 9000, 10000], dtype=torch.int64)
    got = chip_smoke.phase_clock_summary(clock, kinds)
    assert got["us_per_phase"] == {"a": 2.0, "b": 3.0}
    assert got["barrier_wait_us"] == 1.0
    assert got["phases"] == 3 and got["total_us"] == 9.0
    assert got["work_us"] == 7.0 and got["wait_us"] == 2.0
    with pytest.raises(RuntimeError):
        chip_smoke.phase_clock_summary(torch.zeros(6, dtype=torch.int64), kinds)

