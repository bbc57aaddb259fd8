"""The paged flash-decode kernels' design, emulated on the CPU.

Both paged kernels (``csrc/paged_decode.cu``, the cell kernel, and
``csrc/paged_decode_stream.cu``, the streaming kernel) run one device
routine (``csrc/paged_decode.cuh``).  They cannot run here, so these tests
rebuild what its blocks and lanes do, from the constants in the source and
the wrapper's partition helpers (``ops/paged_allheads.py``):

- the work items: the cell kernel's (slot, chunk) grid sized from the
  longest length (its last chunk open-ended), the streaming kernel's flat
  list and ``find_item``'s warp scan, each covering every row once and
  giving an empty slot one item of no rows;
- one item's partial flash state over staged sub-tiles in f32: one pass
  of the scores a sub-tile, each lane its 16-byte pieces of a row's head
  slice and the xor butterfly that joins a row's lanes, the online softmax
  whose max moves only when a score passes it (each lane its row's share
  of the exp-sum), P.V row by row;
- the last block's merge of a slot's partials in item order, whatever order
  the blocks arrive in, and its append after every item of the slot has
  read (the capacity clip);
- the sub-tile sizes and the shared memory they take, ``kBlocksPerSm`` blocks to
  an SM.

The emulation is held against the plain version (``decode_reference`` +
``kv_append``) and the JAX package's ``_decode_xla`` + ``kv_append``: o, m
within 1e-5, l rtol 1e-5 (f32 sums in another order; an int8 value
dequantizes to the same exact product on every side), the pools bit for
bit.
"""

from __future__ import annotations

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from midi_model_tpu.ops import paged_allheads as jpa
from midi_model_tpu_torch.ops import paged_allheads as pa

from _torch_helpers import one_torch_thread  # noqa: F401 (autouse; also sets full fp32)

ROOT = Path(__file__).resolve().parents[1]
CUH = ROOT / "midi_model_tpu_torch" / "csrc" / "paged_decode.cuh"
F32 = np.float32


def _constants() -> dict:
    src = CUH.read_text()
    found = {}
    for name in ("kWarps", "kBlocksPerSm", "kStages", "kMaxHeadsPerWarp", "kLane"):
        m = re.search(rf"constexpr int {name} = (\d+);", src)
        assert m, f"{name} not found in paged_decode.cuh"
        found[name] = int(m.group(1))
    # rows of a staged sub-tile: the default, and f32's specialisation
    m = re.search(r"template <typename T> struct Tile \{ static constexpr int rows = (\d+); \};",
                  src)
    f = re.search(r"template <> struct Tile<float> \{ static constexpr int rows = (\d+); \};", src)
    assert m and f, "Tile not found in paged_decode.cuh"
    found["rows"] = {1: int(m.group(1)), 2: int(m.group(1)), 4: int(f.group(1))}
    return found


C = _constants()
SMEM_PER_SM = 233472  # H100: 228 KB of shared memory an SM, 1 KB reserved per block
PS, PPS = 16, 8
CAP = PS * PPS
# an empty slot, an inactive one (length 0, still appending), one row, a
# page edge and one row past it, mid-page, and a slot at capacity whose
# clipped append lands on a row its items read
LENGTHS = np.array([0, 0, 1, PS, PS + 1, 37, CAP], np.int32)
B = len(LENGTHS)
N_PAGES = B * PPS + 3


def _fma(a, b, c):
    """fmaf in f32 (the product exact in f64, one rounding of the sum)."""
    return (np.asarray(a, np.float64) * np.asarray(b, np.float64)
            + np.asarray(c, np.float64)).astype(F32)


def _xor_sum(x: np.ndarray, width: int) -> np.ndarray:
    """The shuffle butterfly over the last axis (``x += shfl_xor(x, off)``
    for off = width/2 .. 1): every lane ends with the same f32 sum."""
    lanes = np.arange(x.shape[-1])
    off = width // 2
    while off:
        x = (x + x[..., lanes ^ off]).astype(F32)
        off //= 2
    return x


# ---- the work items ---------------------------------------------------------

def cell_items(length: int, item_rows: int, chunks: int):
    """Block (j, s) of the cell grid: (j, r0, n) of each live chunk of a
    slot of ``length`` rows (as ``paged_decode_kernel``)."""
    n_items = min(chunks, pa.chunks_of(length, item_rows))
    out = []
    for j in range(n_items):
        r0 = j * item_rows
        n = length - r0 if j == chunks - 1 else min(item_rows, length - r0)
        out.append((j, r0, max(n, 0)))
    return out, n_items


def warp_scan(values: np.ndarray) -> np.ndarray:
    """``find_item``'s inclusive scan: ``cum += shfl_up(cum, off)`` for lanes
    >= off, off = 1, 2, 4, 8, 16."""
    cum = values.copy()
    for off in (1, 2, 4, 8, 16):
        up = np.concatenate([cum[:off], cum[:-off]])  # lanes < off keep their own
        cum = np.where(np.arange(32) >= off, cum + up, cum)
    return cum


def find_item(lengths, rows: int, item: int):
    """``find_item`` of ``paged_decode_stream.cu``: (slot, chunk, the slot's
    chunk count) of work item ``item``, slot -1 past the list's end."""
    before = 0
    for s0 in range(0, len(lengths), 32):
        nb = np.array([pa.chunks_of(int(lengths[s0 + i]), rows) if s0 + i < len(lengths) else 0
                       for i in range(32)])
        cum = warp_scan(nb)
        hit = np.nonzero(before + cum > item)[0]
        if len(hit):
            src = hit[0]
            end = before + cum[src]
            return s0 + src, item - (end - nb[src]), nb[src]
        before += cum[31]
    return -1, 0, 0


def stream_items(lengths, rows: int, capacity: int):
    """Every block of the streaming grid: {slot: [(j, r0, n, item, the slot's
    item count)]} and the number of blocks that found no item."""
    grid = len(lengths) * pa.chunks_of(capacity, rows)
    slots, idle = {}, 0
    for item in range(grid):
        s, j, n_items = find_item(lengths, rows, item)
        if s < 0:
            idle += 1
            continue
        r0 = j * rows
        slots.setdefault(s, []).append((j, r0, max(0, min(rows, int(lengths[s]) - r0)), item,
                                        n_items))
    return slots, idle


@pytest.mark.parametrize("lengths,item_rows,longest", [
    ([0, 1, 16, 17, 128], 8, 128), ([5, 300, 0], 24, 300), ([40, 7], 16, 20),
    ([0, 0], 8, 0), ([192] * 32, 24, 192)])
def test_cell_grid_covers_every_row_once(lengths, item_rows, longest):
    """Each slot's chunks tile [0, length) once, in order; an empty slot is
    one chunk of no rows; a slot longer than the grid was sized for (an
    understated longest length) is still covered by the open last chunk."""
    chunks = pa.chunks_of(longest, item_rows)
    for length in lengths:
        items, n_items = cell_items(length, item_rows, chunks)
        assert len(items) == n_items >= 1
        covered = []
        for _, r0, n in items:
            covered += list(range(r0, r0 + n))
        assert covered == list(range(length))


@pytest.mark.parametrize("b,rows,seed", [(7, 16, 0), (40, 64, 1), (33, 16, 2)])
def test_stream_list_and_warp_scan(b, rows, seed):
    """``find_item`` walks the slots slot-major, 32 to a warp: every chunk of
    every slot once, an empty slot once, then idle blocks; the shuffle scan
    is the inclusive prefix sum."""
    rng = np.random.default_rng(seed)
    capacity = 8 * rows
    lengths = rng.integers(0, capacity + 1, b)
    lengths[rng.integers(0, b, 3)] = 0
    vals = rng.integers(0, 9, 32)
    np.testing.assert_array_equal(warp_scan(vals), np.cumsum(vals))
    slots, idle = stream_items(lengths, rows, capacity)
    expect = sum(pa.chunks_of(int(n), rows) for n in lengths)
    assert idle == b * pa.chunks_of(capacity, rows) - expect
    order = []
    for s in range(b):
        items = slots[s]
        assert [j for j, *_ in items] == list(range(pa.chunks_of(int(lengths[s]), rows)))
        assert all(n_items == len(items) for *_, n_items in items)
        assert sum(n for _, _, n, _, _ in items) == lengths[s]
        order += [item for *_, item, _ in items]
    assert order == list(range(expect))  # slot-major, consecutive scratch rows


# ---- sub-tiles and shared memory ---------------------------------------------

def smem_bytes(h: int, d: int, w: int, hkv: int, elt: int, quantized: bool) -> int:
    """``layout<T>(...).total`` of ``paged_decode.cuh``."""
    def up(x, to):
        return -(-x // to) * to
    rows = C["rows"][elt]
    tile = up(rows * w * elt, 128)
    stage = 2 * tile + (up(rows * up(2 * hkv * 2, 16), 128) if quantized else 0)
    return C["kStages"] * stage + up(h * d * 4, 16) + C["kStages"] * 8 + 16


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32, torch.int8])
def test_sub_tiles_fit_the_blocks_an_sm(dtype):
    """At tv2o-medium's event net (16 heads x 64, one row 1,024 wide) a
    sub-tile is ~32 KB of k and v (the wrapper's ``stage_rows`` mirrors the
    kernel's ``Tile``), ``kBlocksPerSm`` blocks' rings fit an SM, and the
    lanes of a warp cover one sub-tile in one pass of the scores."""
    h, hkv, d = 16, 16, 64
    w = hkv * pa.head_stride(d, hkv)
    elt = torch.empty((), dtype=dtype).element_size()
    quantized = dtype == torch.int8
    rows = pa.stage_rows(elt)
    assert rows == C["rows"][elt] and 32 % rows == 0
    assert 16 * 1024 <= 2 * w * elt * rows <= 32 * 1024
    per_block = smem_bytes(h, d, w, hkv, elt, quantized) + 1024
    assert C["kBlocksPerSm"] * per_block <= SMEM_PER_SM
    assert h <= C["kWarps"] * C["kMaxHeadsPerWarp"] and d in pa.HEAD_DIMS


@pytest.mark.parametrize("longest,rows,chunks", [(64, 8, 8), (192, 24, 8), (256, 32, 8),
                                                 (2047, 232, 9), (1, 8, 1)])
def test_cell_chunks_give_about_two_blocks_an_sm(longest, rows, chunks):
    """B=32 on 132 SMs: about ``CELL_BLOCKS_PER_SM`` items an SM, whole sub-tiles."""
    got = pa.cell_item_rows(32, longest, 8, 132)
    assert got == rows and got % 8 == 0
    assert pa.chunks_of(longest, got) == chunks


# ---- one item's partial, the merge, the append --------------------------------

def item_partial(q, k_rows, v_rows, k_sc, v_sc, *, hkv, d, stride, elt):
    """The routine's partial over one item's rows (values already as f32;
    int8 with their bf16 scales per row and kv head): unnormalised P.V
    [H, D], the running max m [H] and the exp-sum l [H].  A sub-tile's
    scores take one pass: row r on lanes r * lpr .. r * lpr + lpr - 1, each
    summing its ppl 16-byte pieces (each an f32 fma chain), then the xor
    butterfly over the row's lanes."""
    rows = C["rows"][elt]
    h_all = q.shape[0]
    groups = h_all // hkv
    epc = 16 // elt
    cpr = d // epc
    lpr = 32 // rows
    ppl = max(1, cpr // lpr)
    n = k_rows.shape[0]
    m = np.full(h_all, -np.inf, F32)
    l_lane = np.zeros((h_all, 32), F32)
    acc = np.zeros((h_all, d), F32)
    for r0 in range(0, n, rows):
        ns = min(rows, n - r0)
        for h in range(h_all):
            kv = h // groups
            x = k_rows[r0:r0 + ns, kv * stride:kv * stride + d]
            if k_sc is not None:
                x = (x * k_sc[r0:r0 + ns, kv, None]).astype(F32)  # exact
            lanes = np.zeros((ns, lpr), F32)  # lane (row, piece0 / ppl)
            for li in range(lpr):
                for pp in range(ppl):
                    c = li * ppl + pp
                    if c >= cpr:
                        continue
                    part = np.zeros(ns, F32)
                    for e in range(epc):
                        part = _fma(q[h, c * epc + e], x[:, c * epc + e], part)
                    lanes[:, li] = (lanes[:, li] + part).astype(F32)
            score = _xor_sum(lanes, lpr)[:, 0]
            if (score > m[h]).any():  # the vote: the max moves, the state rescales
                m_new = F32(max(m[h], score.max()))
                corr = F32(np.exp(np.float64(m[h]) - m_new)) if m[h] > -np.inf else F32(0)
                l_lane[h] = (l_lane[h] * corr).astype(F32)
                acc[h] = (acc[h] * corr).astype(F32)
                m[h] = m_new
            p = np.exp(score - m[h]).astype(F32)
            l_lane[h, :ns] = (l_lane[h, :ns] + p).astype(F32)
            vx = v_rows[r0:r0 + ns, kv * stride:kv * stride + d]
            if v_sc is not None:
                vx = (vx * v_sc[r0:r0 + ns, kv, None]).astype(F32)
            for r in range(ns):
                acc[h] = _fma(p[r], vx[r], acc[h])
    return acc, m, _xor_sum(l_lane, 32)[:, 0]


def merge(partials):
    """The last block's merge, in item order: lane i weighs items i, i + 32,
    ...; each dim sums the items in order."""
    m_all = np.stack([p[1] for p in partials])  # [items, H]
    big = m_all.max(axis=0)
    h_all = m_all.shape[1]
    total_lane = np.zeros((h_all, 32), F32)
    sums = np.zeros_like(partials[0][0])
    for i, (acc, m, l) in enumerate(partials):
        w = np.exp(m - big).astype(F32)
        total_lane[:, i % 32] = _fma(l, w, total_lane[:, i % 32])
        sums = _fma(acc, w[:, None], sums)
    total = _xor_sum(total_lane, 32)[:, 0]
    o = np.where(total[:, None] > 0, sums / np.where(total > 0, total, 1)[:, None], 0)
    return o.astype(F32), big, total


def emulate(kernel, q, pools, lengths, base, write, *, elt, hkv, d, small, seed):
    """Both kernels' blocks in a random arrival order: each reads its item,
    and the slot's last arrival merges and appends.  ``elt``: the pools'
    element size (the values arrive as f32).  Returns (o, m, l) and the
    pools after the appends (numpy copies)."""
    k, v, sc = (None if t is None else t.copy() for t in pools)
    new_k, new_v, new_s, wpages, woffs = write
    b, h_all, _ = q.shape
    w = k.shape[2]
    stride = w // hkv
    quantized = sc is not None
    stage_rows = pa.stage_rows(elt)
    if kernel == "cell":
        longest = int(lengths.max())
        rows = pa.cell_item_rows(b, longest, stage_rows, 4 if small else 132)
        chunks = pa.chunks_of(longest, rows)
        blocks = []
        for s in range(b):
            items, n_items = cell_items(int(lengths[s]), rows, chunks)
            blocks += [(s, j, r0, n, n_items) for j, r0, n in items]
    else:
        rows = 16 if small else pa.STREAM_ITEM_ROWS
        slots, _ = stream_items(lengths, rows, PPS * PS)
        blocks = [(s, j, r0, n, n_items) for s, items in slots.items()
                  for j, r0, n, _, n_items in items]
    sb = -(-4 * hkv // 16) * 16 // 2  # bf16 lanes of a staged scale row
    assert 2 * hkv <= sb
    o = np.zeros((b, h_all, d), F32)
    m = np.zeros((b, h_all), F32)
    l = np.zeros((b, h_all), F32)
    partials, arrivals = {}, np.zeros(b, int)
    for idx in np.random.default_rng(seed).permutation(len(blocks)):
        s, j, r0, n, n_items = blocks[idx]
        first = int(base[s]) * PS + r0
        flat = slice(first, first + n)
        kr = k.reshape(-1, w)[flat].astype(F32)
        vr = v.reshape(-1, w)[flat].astype(F32)
        ks = vs = None
        if quantized:
            staged = sc.reshape(-1, C["kLane"])[flat, :sb].astype(F32)
            ks, vs = staged[:, :hkv], staged[:, hkv:2 * hkv]
        partials[s, j] = item_partial(q[s], kr, vr, ks, vs, hkv=hkv, d=d, stride=stride,
                                      elt=elt)
        arrivals[s] += 1
        if arrivals[s] < n_items:
            continue
        if n_items == 1:
            acc, m[s], l[s] = partials[s, 0]
            o[s] = np.where(l[s][:, None] > 0, acc / np.where(l[s] > 0, l[s], 1)[:, None], 0)
        else:
            o[s], m[s], l[s] = merge([partials[s, i] for i in range(n_items)])
        # the append: every item of slot s has read its rows
        k[wpages[s], woffs[s]] = new_k[s]
        v[wpages[s], woffs[s]] = new_v[s]
        if quantized:
            sc[wpages[s], woffs[s]] = new_s[s]
    return (o, m, l), (k, v, sc)


def _inputs(dtype, h, hkv, d, seed):
    """Pools, fresh rows and q, in numpy (values the pool dtype holds) and in
    both packages."""
    rng = np.random.default_rng(seed)
    w = hkv * pa.head_stride(d, hkv)
    if dtype == "int8":
        k, v = (rng.integers(-127, 128, (N_PAGES, PS, w)).astype(np.int8) for _ in range(2))
        sc = jnp.asarray(rng.uniform(1e-3, 0.05, (N_PAGES, PS, pa.LANE)), jnp.bfloat16)
        sc = np.asarray(sc, F32)
        x = rng.normal(size=(2, B, hkv, d)).astype(F32)
        (kq, ks), (vq, vs) = (jpa.quantize_packed(jnp.asarray(t), hkv, d) for t in x)
        rows = (np.array(kq), np.array(vq), np.array(jpa.combine_scales(ks, vs, hkv), F32))
        pools = (k, v, sc)
    else:
        jdt = jnp.float32 if dtype == "f32" else jnp.bfloat16
        raw = rng.normal(size=(2, N_PAGES, PS, hkv, d)).astype(F32)
        k, v = (np.asarray(jpa.pack_heads(jnp.asarray(t, jdt), hkv, d), F32) for t in raw)
        x = rng.normal(size=(2, B, hkv, d)).astype(F32)
        rows = tuple(np.array(jpa.pack_heads(jnp.asarray(t, jdt), hkv, d), F32)
                     for t in x) + (None,)
        pools = (k, v, None)
    q = (rng.normal(size=(B, h, d)) * d ** -0.5).astype(F32)
    base = (np.arange(B) * PPS).astype(np.int32)
    write_pos = np.clip(LENGTHS, 0, CAP - 1)
    write_pos[1] = 9  # the inactive slot appends too (decode_paged's rule)
    wpages = (base + write_pos // PS).astype(np.int32)
    woffs = (write_pos % PS).astype(np.int32)
    return pools, rows + (wpages, woffs), q, base


def _torch_pools(pools, dtype):
    tdt = {"f32": torch.float32, "bf16": torch.bfloat16, "int8": torch.int8}[dtype]
    k, v, sc = pools
    return pa.PagedPools(torch.from_numpy(k.copy()).to(tdt), torch.from_numpy(v.copy()).to(tdt),
                         None if sc is None else torch.from_numpy(sc.copy()).to(torch.bfloat16))


CASES = [(8, 4, 64), (4, 4, 64), (4, 1, 16)]  # GQA, MHA, padded head stride


@pytest.mark.parametrize("small", [False, True], ids=["wrapper_items", "small_items"])
@pytest.mark.parametrize("kernel", ["cell", "stream"])
@pytest.mark.parametrize("dtype", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("h,hkv,d", CASES)
def test_emulated_kernel_matches_plain_and_jax(h, hkv, d, dtype, kernel, small):
    """The emulated blocks (in two arrival orders) against the port's plain
    version and the JAX package's ``_decode_xla`` + ``kv_append``:
    ``wrapper_items`` with the wrapper's item sizes, ``small_items`` with
    16-row items (streaming) or 4 SMs' worth of cell chunks (many sub-tiles
    an item, many items to merge)."""
    pools, write, q, base = _inputs(dtype, h, hkv, d, seed=1)
    kw = dict(elt={"f32": 4, "bf16": 2, "int8": 1}[dtype], hkv=hkv, d=d, small=small)
    (o, m, l), after = emulate(kernel, q, pools, LENGTHS, base, write, seed=2, **kw)
    (o2, m2, l2), after2 = emulate(kernel, q, pools, LENGTHS, base, write, seed=3, **kw)
    # the merge runs in item order: the arrival order moves no bit
    for a, b_ in zip((o, m, l, *after[:2]), (o2, m2, l2, *after2[:2])):
        np.testing.assert_array_equal(a, b_)

    geometry = dict(page_size=PS, pages_per_slot=PPS, kv_heads=hkv, head_dim=d)
    tpools = _torch_pools(pools, dtype)
    tdt = tpools.k.dtype
    new_k, new_v, new_s, wpages, woffs = write
    twrite = (torch.from_numpy(new_k).to(tdt), torch.from_numpy(new_v).to(tdt),
              None if new_s is None else torch.from_numpy(new_s).to(torch.bfloat16),
              torch.from_numpy(wpages), torch.from_numpy(woffs))
    o_r, m_r, l_r, ref_pools = pa._plain(torch.from_numpy(q), tpools, torch.from_numpy(LENGTHS),
                                         torch.from_numpy(base), twrite, geometry)
    jdt = {"f32": jnp.float32, "bf16": jnp.bfloat16, "int8": jnp.int8}[dtype]
    jpools = jpa.PagedPools(k=jnp.asarray(pools[0], jdt), v=jnp.asarray(pools[1], jdt),
                            scales=None if pools[2] is None else jnp.asarray(pools[2],
                                                                             jnp.bfloat16))
    o_x, m_x, l_x = jpa._decode_xla(jnp.asarray(q), jpools, jnp.asarray(LENGTHS),
                                    jnp.asarray(base), **geometry)
    jout = jpa.kv_append(jpools, jnp.asarray(new_k, jdt), jnp.asarray(new_v, jdt),
                         jnp.asarray(wpages), jnp.asarray(woffs),
                         new_scales=None if new_s is None else jnp.asarray(new_s, jnp.bfloat16))

    live = LENGTHS > 0
    for o_ref, m_ref, l_ref in ((o_r.numpy(), m_r.numpy(), l_r.numpy()),
                                (np.asarray(o_x), np.asarray(m_x), np.asarray(l_x))):
        np.testing.assert_allclose(o, o_ref, atol=1e-5)
        np.testing.assert_allclose(m[live], m_ref[live], atol=1e-5)
        np.testing.assert_allclose(l, l_ref, rtol=1e-5, atol=1e-6)
    # an empty or inactive slot: m = -inf, l = 0, o = 0
    assert np.all(m[~live] == -np.inf) and np.all(l[~live] == 0) and np.all(o[~live] == 0)
    for ours, plain, theirs in zip(after, ref_pools, jout):
        if ours is None:
            continue
        np.testing.assert_array_equal(ours.astype(F32), plain.float().numpy())
        np.testing.assert_array_equal(ours.astype(F32), np.asarray(theirs, F32))
