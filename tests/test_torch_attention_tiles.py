"""The index math of the f32 causal attention kernels, emulated on the CPU.

The kernels cannot run here, so these tests rebuild what their lanes do from
the constants in the CUDA sources (``midi_model_tpu_torch/csrc``):

- the 3xTF32 split (``hopper.cuh`` ``tf32_rna``): the kernels' two-integer
  rounding against round-to-nearest-away to a 10-bit mantissa computed
  another way, and what the split keeps of a 64-long dot product;
- the f32 tiles in shared memory and the ``mma.sync.m16n8k8`` tf32 fragments
  (``attention_tf32.cuh``: ``load_tile``, ``ld_a``, ``ld_b_nrows``,
  ``ld_b_krows``, ``a_from_acc``) with the PTX ISA's fragment layouts: whole
  blocks of the forward (``fwd_tf32_kernel``: Q.K^T, the online softmax,
  P.V) and of the backward (``dkdv_tf32_kernel``: S^T, dP^T, dv, dk;
  ``dq_tf32_kernel``: S, dP, dq) on a ragged 64-row tile reproduce the
  plain formulas, and every fragment read falls on 32 banks;
- the grids: the tf32 kernels' blocks and the packed-rows kernels' warps
  (``fwd_rows256_kernel``, ``dkdv_rows256_kernel``, ``dq_rows256_kernel``)
  cover every (sequence, head, row) and every causal (row, key) pair once.

The emulated products are exact (float64, no split): the layouts are under
test here, the split's error in its own test.
"""

from __future__ import annotations

import collections
import math
import re
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "midi_model_tpu_torch" / "csrc"


def _constants(name: str, names) -> dict:
    src = (CSRC / name).read_text()
    found = {}
    for n in names:
        m = re.search(rf"constexpr (?:int|size_t) {n} = (\d+);", src)
        assert m, f"{n} not found in {name}"
        found[n] = int(m.group(1))
    return found


TILE = _constants("attention_tf32.cuh", ("kR", "kPitch", "kThreads"))
FWD_ROWS = _constants("causal_attention.cu", ("kWarps", "kWarpRows"))
BWD_ROWS = _constants("causal_attention_bwd.cu", ("kWarps", "kRows"))
R, PITCH = TILE["kR"], TILE["kPitch"]
WARPS = TILE["kThreads"] // 32
DH = 64
SCALE = DH ** -0.5
SCALE_LOG2 = SCALE * math.log2(math.e)
LANES = np.arange(32)
G, T = LANES >> 2, LANES & 3


def _rna_constants():
    m = re.search(r"return \(__float_as_uint\(x\) \+ (0x[0-9a-f]+)u\) & (0x[0-9a-f]+)u;",
                  (CSRC / "hopper.cuh").read_text())
    assert m, "tf32_rna's constants not found in hopper.cuh"
    return int(m.group(1), 16), int(m.group(2), 16)


HALF_ULP, MASK = _rna_constants()


# ---- the split ---------------------------------------------------------------

def tf32_rna(x: np.ndarray) -> np.ndarray:
    """hopper.cuh tf32_rna on float32 values: the kernels' integer form."""
    bits = np.asarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(HALF_ULP)) & np.uint32(MASK)).view(np.float32)


def rna_reference(x: np.ndarray) -> np.ndarray:
    """Round to nearest, ties away from zero, to 11 significant bits (a
    10-bit mantissa), from the value: x = m 2^e with 1/2 <= |m| < 1."""
    m, e = np.frexp(np.asarray(x, np.float64))
    r = np.floor(np.abs(m) * 2.0 ** 11 + 0.5)
    return (np.sign(m) * r * np.exp2(e - 11.0)).astype(np.float32)


def split(x: np.ndarray):
    hi = tf32_rna(x)
    return hi, tf32_rna(np.asarray(x, np.float32) - hi)


def test_tf32_rna_is_round_to_nearest_away():
    rng = np.random.default_rng(0)
    x = (rng.standard_normal(200_000) * np.exp2(rng.integers(-60, 60, 200_000))).astype(
        np.float32)
    # exact ties (the 13 dropped bits 1 0...0), both signs, and a carry into
    # the exponent (all 23 mantissa bits set)
    ties = ((rng.integers(0x00800000, 0x7f000000, 1000, dtype=np.uint32) & ~np.uint32(0x1fff))
            | np.uint32(0x1000)).view(np.float32)
    carry = np.array([0x3fffffff, 0x407fffff, 0x3f7ff000], np.uint32).view(np.float32)
    for v in (x, ties, -ties, carry, -carry):
        np.testing.assert_array_equal(tf32_rna(v), rna_reference(v))
    assert np.all(tf32_rna(ties) != ties) and np.all(np.abs(tf32_rna(ties)) > np.abs(ties))
    # a tf32 value keeps only the top 19 bits, and rounding it again is exact
    assert np.all(tf32_rna(x).view(np.uint32) & np.uint32(~MASK & 0xffffffff) == 0)
    np.testing.assert_array_equal(tf32_rna(tf32_rna(x)), tf32_rna(x))


def test_split_keeps_a_dot_product_within_its_bound():
    """hi.hi + hi.lo + lo.hi of 64-long dot products of seeded normal inputs
    against the float64 result: the dropped lo.lo and the rounding of the lo
    parts are each at most 2^-22 |a b|, so the bound is 2^-20 sum |a b|; with
    the kernels' f32 sums over the 64 terms, (2^-20 + 64 * 2^-24) sum |a b|.
    Plain TF32 (hi.hi alone) misses that bound on most rows."""
    rng = np.random.default_rng(1)
    a = rng.standard_normal((4096, 64)).astype(np.float32)
    b = rng.standard_normal((4096, 64)).astype(np.float32)
    (ah, al), (bh, bl) = split(a), split(b)
    exact = (a.astype(np.float64) * b).sum(-1)
    scale = np.abs(a.astype(np.float64) * b).sum(-1)
    f64 = [x.astype(np.float64) for x in (ah, al, bh, bl)]
    terms = f64[1] * f64[2] + f64[0] * f64[3] + f64[0] * f64[2]  # each product exact
    err = np.abs(terms.sum(-1) - exact)
    assert np.all(err <= 2.0 ** -20 * scale)
    f32_sum = np.zeros(len(a), np.float32)
    for i in range(64):  # in the mma's k order, rounded to f32 at every add
        f32_sum = (f32_sum + terms[:, i].astype(np.float32)).astype(np.float32)
    assert np.all(np.abs(f32_sum - exact) <= (2.0 ** -20 + 64 * 2.0 ** -24) * scale)
    plain_tf32 = np.abs((f64[0] * f64[2]).sum(-1) - exact)
    assert np.mean(plain_tf32 > 2.0 ** -20 * scale) > 0.9


# ---- shared memory and fragments as the kernels address them --------------------

def load_tile(rows: np.ndarray, r0: int, s: int) -> np.ndarray:
    """attention_tf32.cuh load_tile: rows r0 .. r0+63 of one head ([S, 64])
    at a pitch of kPitch floats; rows at or past S zero; the padding columns
    NaN, so a fragment that reads one poisons its product."""
    tile = np.full(R * PITCH, np.nan)
    for rr in range(R):
        row = r0 + rr
        tile[rr * PITCH:rr * PITCH + DH] = rows[row] if row < s else 0.0
    return tile


def ld_a(tile, m0, k0):
    p = (m0 + G) * PITCH + k0 + T
    return np.stack([tile[p], tile[p + 8 * PITCH], tile[p + 4], tile[p + 8 * PITCH + 4]], 1)


def ld_b_nrows(tile, n0, k0):
    p = (n0 + G) * PITCH + k0 + T
    return np.stack([tile[p], tile[p + 4]], 1)


def ld_b_krows(tile, k0, n0):
    p = (k0 + 2 * T) * PITCH + n0 + G
    return np.stack([tile[p], tile[p + PITCH]], 1)


def a_from_acc(c):
    return c[:, [0, 2, 1, 3]]


# mma.sync.m16n8k8 .tf32 fragments (PTX ISA): per register, the lane's row and column
A_AT = [(G, T), (G + 8, T), (G, T + 4), (G + 8, T + 4)]
B_AT = [(T, G), (T + 4, G)]
C_AT = [(G, 2 * T), (G, 2 * T + 1), (G + 8, 2 * T), (G + 8, 2 * T + 1)]


def _gather(shape, frag, at):
    m = np.full(shape, np.nan)
    count = np.zeros(shape, int)
    for i, (r, c) in enumerate(at):
        m[r, c] = frag[:, i]
        np.add.at(count, (r, c), 1)
    assert np.all(count == 1), "a fragment element held by no lane or by two"
    return m


def mma(c, a, b):
    """c[16 x 8] += a[16 x 8] b[8 x 8] in the lanes' registers."""
    d = _gather((16, 8), c, C_AT) + _gather((16, 8), a, A_AT) @ _gather((8, 8), b, B_AT)
    return np.stack([d[r, col] for r, col in C_AT], 1)


def zeros():
    return [np.zeros((32, 4)) for _ in range(8)]


def product(c, a_frag, b_frag):
    """attention_tf32.cuh product: 8 k steps x 8 column tiles."""
    for kk in range(8):
        a = a_frag(kk)
        for nt in range(8):
            c[nt] = mma(c[nt], a, b_frag(kk, nt))
    return c


def to_matrix(c) -> np.ndarray:
    """A warp's 16 x 64 accumulator block as a matrix."""
    m = np.zeros((16, 64))
    for nt in range(8):
        for i, (r, col) in enumerate(C_AT):
            m[r, 8 * nt + col] = c[nt][:, i]
    return m


def quad(x, op):
    """The shuffles over lanes 4g .. 4g+3 (xor 1, then xor 2)."""
    return np.repeat(op(x.reshape(8, 4), axis=1), 4)


# ---- the kernels' blocks ------------------------------------------------------

def fwd_block(q, k, v, qt, s):
    """fwd_tf32_kernel, one block: query tile qt of one (b, h); q, k, v
    [S, 64].  Returns (out rows, lse rows) of the tile's rows below S."""
    q0 = qt * R
    qtile = load_tile(q, q0, s)
    out, lse = np.zeros((R, DH)), np.zeros(R)
    for warp in range(WARPS):
        qa = [ld_a(qtile, 16 * warp, 8 * kk) for kk in range(8)]
        row0, col0 = q0 + 16 * warp + G, 2 * T
        o = zeros()
        m = [np.full(32, -np.inf) for _ in range(2)]
        l = [np.zeros(32) for _ in range(2)]
        for j in range(qt + 1):
            ktile, vtile = load_tile(k, j * R, s), load_tile(v, j * R, s)
            sc = product(zeros(), lambda kk: qa[kk],
                         lambda kk, nt: ld_b_nrows(ktile, 8 * nt, 8 * kk))
            if j == qt:
                for nt in range(8):
                    for e in range(4):
                        key = j * R + 8 * nt + col0 + (e & 1)
                        sc[nt][:, e] = np.where(key > row0 + 8 * (e >> 1), -np.inf, sc[nt][:, e])
            corr = []
            for r in range(2):
                mx = np.max([sc[nt][:, e] for nt in range(8) for e in (2 * r, 2 * r + 1)], 0)
                m_new = np.maximum(m[r], quad(mx, np.max) * SCALE_LOG2)
                corr.append(np.exp2(m[r] - m_new))
                m[r] = m_new
            for nt in range(8):
                for e in range(4):
                    sc[nt][:, e] = np.exp2(sc[nt][:, e] * SCALE_LOG2 - m[e >> 1])
            for r in range(2):
                l[r] = l[r] * corr[r] + sum(sc[nt][:, e] for nt in range(8)
                                            for e in (2 * r, 2 * r + 1))
            pv = product(zeros(), lambda kk: a_from_acc(sc[kk]),
                         lambda kk, nt: ld_b_krows(vtile, 8 * kk, 8 * nt))
            for nt in range(8):
                for e in range(4):
                    o[nt][:, e] = o[nt][:, e] * corr[e >> 1] + pv[nt][:, e]
        block = to_matrix(o)
        for r in range(2):
            lr = quad(l[r], np.sum)
            rows = 16 * warp + G + 8 * r
            out[rows] = block[G + 8 * r] / lr[:, None]
            lse[rows] = m[r] * math.log(2) + np.log(lr)
    n = min(s - q0, R)
    return out[:n], lse[:n]


def lse_rows(lse2, r0, s):
    """tc::load_rows: the lse in log2 units (+inf past S) and D of rows r0 .. r0+63."""
    return np.array([lse2[r0 + r] if r0 + r < s else np.inf for r in range(R)])


def dkdv_block(q, k, v, dout, lse, delta, kt, s):
    """dkdv_tf32_kernel, one block: key tile kt of one kv head, walking the
    query tiles on or below the diagonal of each of its query heads; q,
    dout, lse, delta per query head (lists), k, v [S, 64].  Returns dk, dv
    of the tile's rows below S."""
    k0, n_t = kt * R, -(-s // R)
    ktile, vtile = load_tile(k, k0, s), load_tile(v, k0, s)
    dk, dv = np.zeros((R, DH)), np.zeros((R, DH))
    steps = [(g, qt) for g in range(len(q)) for qt in range(kt, n_t)]
    for warp in range(WARPS):
        dka, dva = zeros(), zeros()
        key0, col0 = k0 + 16 * warp + G, 2 * T
        for g, qt in steps:
            q0 = qt * R
            qtile, gtile = load_tile(q[g], q0, s), load_tile(dout[g], q0, s)
            lvec = lse_rows(lse[g] * math.log2(math.e), q0, s)
            dvec = np.array([delta[g][q0 + r] if q0 + r < s else 0.0 for r in range(R)])
            pt = product(zeros(), lambda kk: ld_a(ktile, 16 * warp, 8 * kk),
                         lambda kk, nt: ld_b_nrows(qtile, 8 * nt, 8 * kk))
            dst = product(zeros(), lambda kk: ld_a(vtile, 16 * warp, 8 * kk),
                          lambda kk, nt: ld_b_nrows(gtile, 8 * nt, 8 * kk))
            for nt in range(8):
                for e in range(4):
                    qc = 8 * nt + col0 + (e & 1)
                    with np.errstate(invalid="ignore"):
                        p = np.exp2(pt[nt][:, e] * SCALE_LOG2 - lvec[qc])
                    p = np.where(q0 + qc < key0 + 8 * (e >> 1), 0.0, p)
                    pt[nt][:, e] = p
                    dst[nt][:, e] = p * (dst[nt][:, e] - dvec[qc])
            part = product(zeros(), lambda kk: a_from_acc(pt[kk]),
                           lambda kk, nt: ld_b_krows(gtile, 8 * kk, 8 * nt))
            dva = [x + y for x, y in zip(dva, part)]
            part = product(zeros(), lambda kk: a_from_acc(dst[kk]),
                           lambda kk, nt: ld_b_krows(qtile, 8 * kk, 8 * nt))
            dka = [x + y for x, y in zip(dka, part)]
        dk[16 * warp:16 * warp + 16] = to_matrix(dka) * SCALE
        dv[16 * warp:16 * warp + 16] = to_matrix(dva)
    n = min(s - k0, R)
    return dk[:n], dv[:n]


def dq_block(q, k, v, dout, lse, delta, qt, s):
    """dq_tf32_kernel, one block: query tile qt of one (b, h)."""
    q0 = qt * R
    qtile, gtile = load_tile(q, q0, s), load_tile(dout, q0, s)
    lvec = lse_rows(lse * math.log2(math.e), q0, s)
    dvec = np.array([delta[q0 + r] if q0 + r < s else 0.0 for r in range(R)])
    dq = np.zeros((R, DH))
    for warp in range(WARPS):
        rl, col0 = 16 * warp + G, 2 * T
        acc = zeros()
        for kt in range(qt + 1):
            ktile, vtile = load_tile(k, kt * R, s), load_tile(v, kt * R, s)
            sc = product(zeros(), lambda kk: ld_a(qtile, 16 * warp, 8 * kk),
                         lambda kk, nt: ld_b_nrows(ktile, 8 * nt, 8 * kk))
            ds = product(zeros(), lambda kk: ld_a(gtile, 16 * warp, 8 * kk),
                         lambda kk, nt: ld_b_nrows(vtile, 8 * nt, 8 * kk))
            for nt in range(8):
                for e in range(4):
                    r = e >> 1
                    key = kt * R + 8 * nt + col0 + (e & 1)
                    with np.errstate(invalid="ignore"):
                        p = np.exp2(sc[nt][:, e] * SCALE_LOG2 - lvec[rl + 8 * r])
                    p = np.where(key > q0 + rl + 8 * r, 0.0, p)
                    ds[nt][:, e] = p * (ds[nt][:, e] - dvec[rl + 8 * r])
            part = product(zeros(), lambda kk: a_from_acc(ds[kk]),
                           lambda kk, nt: ld_b_krows(ktile, 8 * kk, 8 * nt))
            acc = [x + y for x, y in zip(acc, part)]
        dq[16 * warp:16 * warp + 16] = to_matrix(acc) * SCALE
    n = min(s - q0, R)
    return dq[:n]


# ---- the plain formulas (float64) -------------------------------------------------

def reference(q, k, v, dout):
    """Causal attention of one head and its FlashAttention-2 backward."""
    s = len(q)
    scores = q @ k.T * SCALE
    scores[np.triu_indices(s, 1)] = -np.inf
    lse = np.logaddexp.reduce(scores, axis=1)
    p = np.exp(scores - lse[:, None])
    out = p @ v
    delta = (dout * out).sum(1)
    ds = p * (dout @ v.T - delta[:, None])
    return dict(out=out, lse=lse, delta=delta, dv=p.T @ dout, dq=ds @ k * SCALE,
                dk=ds.T @ q * SCALE)


S_RAGGED = 300  # four whole 64-row tiles and a ragged fifth of 44 rows


def _head(seed, s=S_RAGGED):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((s, DH)) for _ in range(4)]


@pytest.mark.parametrize("qt", [0, 2, 4])
def test_forward_block_reproduces_attention(qt):
    q, k, v, _ = _head(qt)
    out, lse = fwd_block(q, k, v, qt, S_RAGGED)
    ref = reference(q, k, v, np.zeros_like(q))
    rows = slice(qt * R, qt * R + len(out))
    np.testing.assert_allclose(out, ref["out"][rows], rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(lse, ref["lse"][rows], rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("kt,groups", [(0, 1), (3, 1), (4, 1), (2, 2)])
def test_dkdv_block_reproduces_the_gradients(kt, groups):
    """A kv head's dk, dv sum over its query heads (GQA at groups 2)."""
    heads = [_head(10 * kt + g) for g in range(groups)]
    k, v = heads[0][1], heads[0][2]
    refs = [reference(hq[0], k, v, hq[3]) for hq in heads]
    dk, dv = dkdv_block([hq[0] for hq in heads], k, v, [hq[3] for hq in heads],
                        [r["lse"] for r in refs], [r["delta"] for r in refs], kt, S_RAGGED)
    rows = slice(kt * R, kt * R + len(dk))
    np.testing.assert_allclose(dk, sum(r["dk"] for r in refs)[rows], rtol=1e-9, atol=1e-11)
    np.testing.assert_allclose(dv, sum(r["dv"] for r in refs)[rows], rtol=1e-9, atol=1e-11)


@pytest.mark.parametrize("qt", [1, 4])
def test_dq_block_reproduces_the_gradient(qt):
    q, k, v, dout = _head(20 + qt)
    ref = reference(q, k, v, dout)
    dq = dq_block(q, k, v, dout, ref["lse"], ref["delta"], qt, S_RAGGED)
    rows = slice(qt * R, qt * R + len(dq))
    np.testing.assert_allclose(dq, ref["dq"][rows], rtol=1e-9, atol=1e-11)


def test_fragment_reads_are_conflict_free_and_rows_aligned():
    """Each of a fragment's 32-lane reads falls on 32 distinct banks (4-byte
    words mod 32); every tile row starts on 16 bytes (cp.async)."""
    assert PITCH * 4 % 16 == 0 and PITCH >= DH
    for m0, k0 in ((0, 0), (16, 8), (48, 56)):
        p = (m0 + G) * PITCH + k0 + T  # ld_a and ld_b_nrows
        for off in (0, 4, 8 * PITCH, 8 * PITCH + 4):
            assert len(set((p + off) % 32)) == 32
        p = (k0 + 2 * T) * PITCH + m0 + G  # ld_b_krows
        for off in (0, PITCH):
            assert len(set((p + off) % 32)) == 32


# ---- the grids --------------------------------------------------------------------

@pytest.mark.parametrize("s", [1, 8, 9, 300, 2047])
def test_tf32_grids_cover_every_tile_once(s):
    """fwd / dq: blockIdx -> (query tile, longest first; b, h); dkdv:
    blockIdx -> (key tile, the first first; b, kv head), then the query
    tiles on or below the diagonal of each of its query heads."""
    b, h, hkv = 2, 4, 2
    groups, n_t = h // hkv, -(-s // R)
    bh_count = b * h
    order = [n_t - 1 - blk // bh_count for blk in range(bh_count * n_t)]
    assert order == sorted(order, reverse=True)
    tiles = collections.Counter((n_t - 1 - blk // bh_count, blk % bh_count)
                                for blk in range(bh_count * n_t))
    assert set(tiles.values()) == {1} and len(tiles) == bh_count * n_t
    pairs = collections.Counter()
    kv_count = b * hkv
    for blk in range(kv_count * n_t):
        kt, bh = blk // kv_count, blk % kv_count
        bb, hk = bh // hkv, bh % hkv
        n_q = n_t - kt
        for step in range(groups * n_q):
            hq = hk * groups + step // n_q
            pairs[(bb, hq, kt + step % n_q, kt)] += 1
    want = {(bb, hq, qt, kt) for bb in range(b) for hq in range(h) for qt in range(n_t)
            for kt in range(qt + 1)}
    assert set(pairs) == want and set(pairs.values()) == {1}


def _rows_forward(s, rows, warps, b=1, h=3):
    n_qt = -(-s // rows)
    bh_count = b * h
    items = bh_count * n_qt
    written, pairs = collections.Counter(), collections.Counter()
    last_qt = n_qt
    for blk in range(-(-items // warps)):
        for warp in range(warps):
            item = blk * warps + warp
            if item >= items:
                continue
            qt = n_qt - 1 - item // bh_count
            assert qt <= last_qt  # the longest tiles first
            last_qt = qt
            bh = item % bh_count
            q0, last = qt * rows, min(s, qt * rows + rows) - 1
            for i in range(rows):
                if q0 + i < s:
                    written[(bh, q0 + i)] += 1
                    for j in range(last + 1):
                        if j <= q0 + i:
                            pairs[(bh, q0 + i, j)] += 1
    return written, pairs, b * h


def _rows_backward(s, rows, warps, b, h, hkv):
    """dkdv_rows256_kernel's keys and dq_rows256_kernel's rows, and the
    (query head, row, key) pairs each pass visits."""
    groups, n_t = h // hkv, -(-s // rows)
    dkdv, dkdv_pairs = collections.Counter(), collections.Counter()
    kv_count = b * hkv
    for item in range(kv_count * n_t):  # a warp's item; blocks of `warps` items
        kt, bh = item // kv_count, item % kv_count
        bb, hk = bh // hkv, bh % hkv
        k0 = kt * rows
        for j in range(rows):
            if k0 + j < s:
                dkdv[(bb, hk, k0 + j)] += 1
        for g in range(groups):
            for i in range(k0, s):
                for j in range(rows):
                    if k0 + j > i:
                        break
                    dkdv_pairs[(bb, hk * groups + g, i, k0 + j)] += 1
    dq, dq_pairs = collections.Counter(), collections.Counter()
    for item in range(b * h * n_t):
        qt, bh = n_t - 1 - item // (b * h), item % (b * h)
        q0, last = qt * rows, min(s, qt * rows + rows) - 1
        for i in range(rows):
            if q0 + i < s:
                dq[(bh, q0 + i)] += 1
        for j in range(last + 1):
            for i in range(rows):
                if j > q0 + i or q0 + i >= s:
                    continue
                dq_pairs[(bh // h, bh % h, q0 + i, j)] += 1
    return dkdv, dkdv_pairs, dq, dq_pairs


@pytest.mark.parametrize("s", [1, 8, 9, 300])
@pytest.mark.parametrize("rows", [FWD_ROWS["kWarpRows"], 4])
def test_packed_rows_forward_covers_each_row_once(s, rows):
    """The kernel's rows a warp (both dtypes), and 4: the plan holds for any."""
    written, pairs, bh = _rows_forward(s, rows, FWD_ROWS["kWarps"])
    assert set(written.values()) == {1} and len(written) == bh * s
    assert set(pairs.values()) == {1} and len(pairs) == bh * s * (s + 1) // 2


@pytest.mark.parametrize("s", [1, 8, 9, 300])
def test_packed_rows_backward_covers_each_row_and_pair_once(s):
    b, h, hkv = 1, 4, 2  # GQA: two query heads a kv head
    dkdv, dkdv_pairs, dq, dq_pairs = _rows_backward(s, BWD_ROWS["kRows"], BWD_ROWS["kWarps"],
                                                    b, h, hkv)
    causal = {(bb, hq, i, j) for bb in range(b) for hq in range(h) for i in range(s)
              for j in range(i + 1)}
    assert set(dkdv.values()) == {1} and len(dkdv) == b * hkv * s
    assert set(dq.values()) == {1} and len(dq) == b * h * s
    for pairs in (dkdv_pairs, dq_pairs):
        assert set(pairs) == causal and set(pairs.values()) == {1}
