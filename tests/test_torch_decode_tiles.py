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
    for name in ("kDecThreads", "kTcRows", "kTcBoxK", "kTcBoxRows", "kTcSegK"):
        m = re.search(rf"constexpr (?:int|size_t) {name} = (\d+);", src)
        assert m, f"{name} not found in decode.cuh"
        found[name] = int(m.group(1))
    return found


C = _constants()
WARPS = C["kDecThreads"] // 32
ROWS, BOX_K, BOX_ROWS, SEG_K = C["kTcRows"], C["kTcBoxK"], C["kTcBoxRows"], C["kTcSegK"]
CHUNK_K = BOX_K * WARPS
LANES = np.arange(32)


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

