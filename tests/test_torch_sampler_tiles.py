"""The top-p / top-k sampler's selection, emulated on the CPU.

``csrc/sampler.cuh`` ``sample_top_p_k_block`` (the standalone sampler kernel
and the fused decode kernels' sample phase) cannot run here, so these tests
rebuild what its threads do, with the constants read from the source:

- the keys: a positive entry's f32 bit pattern above its inverted index, so
  that one unsigned order is the stable descending sort (value desc, index
  asc); entries that are not positive stay out (they never win and add
  nothing to the running mass);
- the lead round: each thread's top ``kSampleLead`` keys over its strided
  entries, each warp's top ``kSampleLead`` by as many tournaments of its
  lanes, and the merge of the warps' lists into the ranks they settle
  exactly: up to the first rank held by the last listed key of a warp that
  has more positive entries than it listed;
- a selection window: ``kSampleDigit``-bit digit rounds on the keys below
  the last window's smallest until the bucket and the keys above it number
  at most ``kSampleWin + kSampleSlack``, each thread counting its digits in
  its own bytes of a shared array (a swizzle spreads a warp over the banks;
  the bytes summed per 32 threads, then per digit); while the digit lies in
  the value bits, the bucket is a range of values and the digit comes from
  the f32 bits; the candidates counted per thread, placed by a block scan of
  those counts, compacted in thread order, each ranked by counting the
  candidates before it (larger, or equal with a lower id);
- the finish: the exclusive running mass summed rank by rank in f32, the
  noise indexed by rank, the first maximum of log(p) + g over the kept
  ranks (scores ordered as unsigned integers), 0 when none beats -inf.

The emulation is held against ``sample_top_p_k_reference`` and the JAX
package's Pallas sampler in interpret mode: the ids are equal on every case.
"""

from __future__ import annotations

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from midi_model_tpu.ops.sampler import sample_top_p_k_tpu
from midi_model_tpu_torch.ops import token_loop as tl
from midi_model_tpu_torch.ops.sampler import sample_top_p_k_reference

from _torch_helpers import one_torch_thread  # noqa: F401 (autouse; also sets full fp32)

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "midi_model_tpu_torch" / "csrc"
F32 = np.float32
U64 = np.uint64


def _constants() -> dict:
    src = (CSRC / "sampler.cuh").read_text()
    found = {}
    for name in ("kSampleLead", "kSampleWin", "kSampleSlack", "kSampleDigit"):
        m = re.search(rf"constexpr int {name} = (\d+);", src)
        assert m, f"{name} not found in sampler.cuh"
        found[name] = int(m.group(1))
    m = re.search(r"constexpr int kThreads = (\d+);", (CSRC / "sampler.cu").read_text())
    d = re.search(r"constexpr int kDecThreads = (\d+);", (CSRC / "decode.cuh").read_text())
    assert m and d and m.group(1) == d.group(1), "one routine serves both block sizes"
    found["threads"] = int(m.group(1))
    return found


C = _constants()
LEAD, WIN, SLACK, DIGIT = C["kSampleLead"], C["kSampleWin"], C["kSampleSlack"], C["kSampleDigit"]
THREADS = C["threads"]
WARPS = THREADS // 32
CAP = WIN + SLACK  # a warp's candidate region


# ---- keys and the block's layout ----------------------------------------------

def keys_of(x: np.ndarray):
    """(keys [S, WARPS, 32] with 0 where there is no entry or it is not
    positive, index bits b): entry i = 256 s + 32 w + lane lies at [s, w,
    lane], as thread 32 w + lane reads it in its pass s."""
    v = len(x)
    b = (v - 1).bit_length()
    bits = x.astype(F32).view(np.uint32).astype(U64)
    k = (bits << U64(b)) | (U64((1 << b) - 1) - np.arange(v, dtype=U64))
    k = np.where(x > 0, k, U64(0))
    s = -(-v // THREADS)
    out = np.zeros(s * THREADS, U64)
    out[:v] = k
    return out.reshape(s, WARPS, 32), b


def key_of(v, i: int, b: int) -> int:
    return (int(np.array([v], F32).view(np.uint32)[0]) << b) | (((1 << b) - 1) - i)


def value_of(k, b: int) -> F32:
    return np.array([int(k) >> b], np.uint32).view(F32)[0]


def index_of(k, b: int) -> int:
    return ((1 << b) - 1) - (int(k) & ((1 << b) - 1))


# ---- the lead round ------------------------------------------------------------

def lead_round(kk: np.ndarray):
    """Each warp's top LEAD keys (0 past its positive entries), its count of
    positive entries and its smallest positive key.  (A thread's top two
    come from value compares: its ids grow, so a strict '>' keeps the lower
    id of equal values, the same two keys.)"""
    top = np.zeros((LEAD, WARPS, 32), U64)
    for s in range(kk.shape[0]):  # each thread's insertion, a max/min chain
        cur = kk[s].copy()
        for q in range(LEAD):
            hi, lo = np.maximum(top[q], cur), np.minimum(top[q], cur)
            top[q], cur = hi, lo
    lists = np.zeros((WARPS, LEAD), U64)
    for r in range(LEAD):  # the lanes' tournaments: the winner pops its head
        best = top[0].max(axis=1)
        lists[:, r] = best
        win = top[0] == best[:, None]
        for q in range(LEAD - 1):
            top[q] = np.where(win, top[q + 1], top[q])
        top[LEAD - 1] = np.where(win, U64(0), top[LEAD - 1])
    npos = (kk > 0).sum(axis=(0, 2))
    kmin = np.where(kk > 0, kk, U64(2**64 - 1)).min(axis=(0, 2))
    return lists, npos, kmin


# ---- one selection window ------------------------------------------------------

def hist_address(t, d):
    """Byte address of thread t's count of digit d: byte t % 4 of word
    32 (t // 4) + (d ^ (t // 4)) % 32."""
    grp = t // 4
    return 4 * (32 * grp + ((d ^ grp) % 32)) + t % 4


def digit_hist(el: np.ndarray, d: np.ndarray) -> np.ndarray:
    """The shared byte array after a round's pass: each thread adds 1 at
    ``hist_address`` of each of its eligible entries' digits."""
    hist = np.zeros(THREADS * 32, np.uint8)
    for s in range(el.shape[0]):
        for w in range(WARPS):
            for lane in range(32):
                if el[s, w, lane]:
                    hist[hist_address(32 * w + lane, int(d[s, w, lane]))] += 1
    return hist


def bin_totals(hist: np.ndarray) -> np.ndarray:
    """Lane d of warp w sums the 4 bytes of each of the words of rows 8 w ..
    8 w + 7 that hold digit d (``__dp4a`` with 0x01010101); then each lane
    sums its digit over the warps."""
    words = hist.reshape(THREADS // 4, 32, 4).astype(np.int64)
    part = np.zeros((WARPS, 32), np.int64)
    for w in range(WARPS):
        for d in range(32):
            for j in range(8):
                row = 8 * w + j
                part[w, d] += words[row, (d ^ row) % 32].sum()
    return part.sum(axis=0)


def suffix_scan(tot: np.ndarray) -> np.ndarray:
    """``S += shfl_down(S, off)`` for lanes with lane + off < 32: lane L ends
    with the sum over lanes >= L."""
    s = tot.copy()
    for off in (1, 2, 4, 8, 16):
        down = np.concatenate([s[off:], s[32 - off:]])  # past the end: own value
        s = np.where(np.arange(32) + off < 32, s + down, s)
    return s


def select_window(x, kk, b: int, k_hi: int, kmin: int, n_elig: int, n_win: int):
    """The digit rounds and the compaction: (candidate values and ids in
    thread order, rounds, the key bits left unsplit)."""
    xs = np.zeros(kk.size, F32)
    xs[:len(x)] = x
    xs = xs.reshape(kk.shape)
    idx = np.arange(kk.size).reshape(kk.shape)
    vh, ih = value_of(k_hi, b), index_of(k_hi, b)
    after = (xs < vh) | ((xs == vh) & (idx > ih))  # ranks_after
    top = k_hi - 1
    h = (top ^ kmin).bit_length()
    p = top >> h
    above, bucket, rounds = 0, n_elig, 0
    eligible = (kk > 0) & (kk < U64(k_hi))
    np.testing.assert_array_equal(eligible, (xs > 0) & after)
    while above + bucket > n_win + SLACK and h > 0:
        sft = max(h - DIGIT, 0)
        width = h - sft
        el = eligible & ((kk >> U64(h)) == U64(p))
        d = (kk >> U64(sft)) & U64((1 << width) - 1)
        if sft >= b:  # the value path: a range of values, the digit from the f32 bits
            vs = h - b
            lo = p << vs
            hi = lo + (1 << vs) - 1
            lo_v = np.array([lo], np.uint32).view(F32)[0]
            hi_v = F32(np.inf) if hi >= 0x7F800000 else np.array([hi], np.uint32).view(F32)[0]
            el_v = (xs > 0) & (xs >= lo_v) & (xs <= hi_v) & after
            d_v = (xs.view(np.uint32) >> np.uint32(sft - b)) & np.uint32((1 << width) - 1)
            np.testing.assert_array_equal(el_v, el)
            np.testing.assert_array_equal(d_v[el], d[el])
        tot = bin_totals(digit_hist(el, d))
        assert tot.sum() == bucket and above < n_win <= above + bucket
        s = suffix_scan(tot)
        dsel = int(np.nonzero(above + s >= n_win)[0].max())
        above += int(s[dsel + 1]) if dsel < 31 else 0
        bucket = int(tot[dsel])
        p = (p << width) | dsel
        h = sft
        rounds += 1
    floor = p << h
    vf, i_f = value_of(floor, b), index_of(floor, b)
    c = (xs > 0) & after & ((xs > vf) | ((xs == vf) & (idx <= i_f)))  # is_cand
    np.testing.assert_array_equal(c, eligible & (kk >= U64(floor)))
    mine = c.sum(axis=0).reshape(-1)  # each thread's candidates
    place = np.cumsum(mine) - mine  # the block scan: each thread's place
    cands = [None] * int(mine.sum())
    for w in range(WARPS):
        for lane in range(32):
            pos = int(place[32 * w + lane])
            for s_ in np.nonzero(c[:, w, lane])[0]:  # the thread's passes in order
                cands[pos] = (xs[s_, w, lane], int(idx[s_, w, lane]))
                pos += 1
    assert len(cands) == above + bucket <= n_win + SLACK
    return cands, rounds, h


def rank_by_count(cands: list, n_win: int) -> list:
    """Each candidate's rank: the candidates before it, read four at a time
    (values 0-padded: before none), larger or equal with a lower id; the
    first n_win ranks fill the ordered list of (value, id)."""
    pad = -len(cands) % 4
    vals = np.array([v for v, _ in cands] + [0.0] * pad, F32)
    ids = np.array([i for _, i in cands] + [-1] * pad)
    out = [None] * n_win
    for v, i in cands:
        r = int(((vals > v) | ((vals == v) & (ids < i))).sum())
        if r < n_win:
            out[r] = (v, i)
    assert all(k is not None for k in out)
    return out


def ordered(s: F32) -> int:
    """A score as an unsigned integer in the same order (-0 as +0)."""
    bits = int(np.array([F32(s) + F32(0)], F32).view(np.uint32)[0])
    return (~bits & 0xFFFFFFFF) if bits & 0x80000000 else bits | 0x80000000


def first_best(scores: np.ndarray, kept: np.ndarray):
    """(best score, its rank) over the kept ranks by the warp's two
    reductions: the largest ordered score (0 for a rank not kept, NaN or
    -inf), then the lowest rank holding it; (-inf, 0) when none."""
    keys = [ordered(sc) if k and sc > -np.inf else 0 for sc, k in zip(scores, kept)]
    top = max(keys, default=0)
    if top == 0:
        return F32(-np.inf), 0
    r = keys.index(top)
    return scores[r], r


def emulate_row(x: np.ndarray, top_p: float, n_iter: int, g: np.ndarray,
                order: str = "sequential"):
    """One block's draw: (id, stats).  ``order="tree"`` sums each window's
    running mass by a pairwise tree instead of rank by rank (the order the
    kernel must not take)."""
    top_p = F32(top_p)
    kk, b = keys_of(x)
    stats = {"lead_settled": False, "windows": []}
    if n_iter <= 0:
        return 0, stats
    lists, npos, kmin = lead_round(kk)
    n_pos = int(npos.sum())
    if n_pos == 0:
        return 0, stats
    n_need = min(n_iter, n_pos)
    entries = lists.reshape(-1)
    rank = np.array([(entries > e).sum() for e in entries])
    last = [w * LEAD + LEAD - 1 for w in range(WARPS) if npos[w] > LEAD]
    e_exact = min(int(rank[i]) + 1 for i in last) if last else n_pos
    m = min(e_exact, n_need)
    lead_keys = [int(entries[int(np.nonzero(rank == r)[0][0])]) for r in range(m)]

    seen = []  # every ordered value so far, for the tree order

    def finish(ordered_keys, t, r0):
        vals = np.array([value_of(k, b) for k in ordered_keys], F32)
        if order == "tree":
            texcl = np.array([_tree_sum(seen + list(vals[:r])) for r in range(len(vals))],
                             F32)
            t_end = _tree_sum(seen + list(vals))
            seen.extend(vals)
        else:
            texcl = np.zeros(len(vals), F32)
            for r, v in enumerate(vals):
                texcl[r] = t
                t = F32(t + v)
            t_end = t
        kept = texcl <= top_p
        with np.errstate(divide="ignore"):
            scores = (np.log(vals).astype(F32) + g[r0:r0 + len(vals)]).astype(F32)
        best, r = first_best(scores, kept)
        return t_end, best, index_of(ordered_keys[r], b) if len(vals) else 0

    t, best, bidx = finish(lead_keys, F32(0), 0)
    if n_need <= e_exact or not t <= top_p:
        stats["lead_settled"] = True
        return (bidx if best > -np.inf else 0), stats
    if best == -np.inf:
        bidx = 0
    vmin = F32(x[x > 0].min())  # the smallest positive entry, at the last id: a lower bound
    r0, k_hi, kmin_all = m, lead_keys[-1], key_of(vmin, len(x) - 1, b)
    assert kmin_all <= int(kmin.min())
    while True:
        n_win = min(WIN, n_need - r0)
        cands, rounds, h = select_window(x, kk, b, k_hi, kmin_all, n_pos - r0, n_win)
        stats["windows"].append({"rounds": rounds, "n_cand": len(cands),
                                 "index_bits_split": h < b})
        win_keys = [key_of(v, i, b) for v, i in rank_by_count(cands, n_win)]
        t, wbest, widx = finish(win_keys, t, r0)
        if wbest > best:
            best, bidx = wbest, widx
        if r0 + n_win == n_need or not t <= top_p:
            return bidx, stats
        r0, k_hi = r0 + n_win, win_keys[-1]


def _tree_sum(v: np.ndarray) -> F32:
    """A pairwise (tree) f32 sum, as a warp or block reduction takes it."""
    v = np.asarray(v, F32)
    if len(v) == 0:
        return F32(0)
    while len(v) > 1:
        if len(v) % 2:
            v = np.concatenate([v, [F32(0)]]).astype(F32)
        v = (v[0::2] + v[1::2]).astype(F32)
    return v[0]


def emulate(probs: np.ndarray, top_p, top_k, g: np.ndarray, **kw):
    b = probs.shape[0]
    tp = np.broadcast_to(np.asarray(top_p, F32), (b,))
    tk = np.broadcast_to(np.asarray(top_k, np.int64), (b,))
    out = [emulate_row(probs[r], tp[r], min(int(tk[r]), g.shape[1]), g[r], **kw)
           for r in range(b)]
    return np.array([i for i, _ in out], np.int32), [s for _, s in out]


# ---- the cases -----------------------------------------------------------------

B = 8
TOP_P = np.array([0.98, 0.5, 1.0, 0.1, 0.9, 0.7, 0.999, 1.0], F32)


def probs_of(kind: str, v: int, rng) -> np.ndarray:
    if kind == "peaked":
        logits = rng.normal(size=(B, v)) * 6.0
    elif kind in ("flat", "no_mass"):
        logits = np.zeros((B, v))
    elif kind == "ties":
        logits = np.round(rng.normal(size=(B, v)) * 2.0)
    else:  # masked: grammar-style zeros, mass < 1
        logits = rng.normal(size=(B, v))
    p = np.exp(logits - logits.max(-1, keepdims=True))
    p = (p / p.sum(-1, keepdims=True)).astype(F32)
    if kind == "masked":
        p = p * (rng.random((B, v)) < 0.1)
    if kind == "no_mass":  # rows with no mass at all, one all-negative zero
        p[:] = 0.0
        p[1] = -0.0
        p[2, 5] = 0.5  # one positive entry beside them
    return p.astype(F32)


def gumbel(key, k_cap: int):
    return np.array(jax.random.gumbel(key, (B, k_cap), jnp.float32))


def reference(probs, top_p, top_k, g) -> np.ndarray:
    b = probs.shape[0]
    return sample_top_p_k_reference(
        torch.from_numpy(probs), torch.as_tensor(np.broadcast_to(top_p, (b,)).copy()),
        torch.full((b,), int(top_k), dtype=torch.int32), torch.from_numpy(g)).numpy()


@pytest.mark.parametrize("v", [300, 3406])
@pytest.mark.parametrize("top_k", [0, 1, 5, 20, 64, 128, 200])
@pytest.mark.parametrize("kind", ["peaked", "flat", "ties", "masked", "no_mass"])
def test_emulation_matches_reference_and_pallas(kind, top_k, v):
    rng = np.random.default_rng([v, top_k, len(kind)])
    probs = probs_of(kind, v, rng)
    key = jax.random.PRNGKey(top_k * 7 + v)
    g = gumbel(key, 128)
    ids, stats = emulate(probs, TOP_P, top_k, g)
    np.testing.assert_array_equal(ids, reference(probs, TOP_P, top_k, g))
    pallas = sample_top_p_k_tpu(jnp.asarray(probs), jnp.asarray(TOP_P), top_k, key,
                                k_cap=128, interpret=True)
    np.testing.assert_array_equal(ids, np.asarray(pallas))
    for s in stats:
        for w in s["windows"]:
            assert w["rounds"] <= -(-(31 + (v - 1).bit_length()) // DIGIT)


@pytest.mark.parametrize("n_tied", [30, 150])
def test_ties_at_the_boundary_straddle_warps(n_tied):
    """The n_iter-th value is shared by entries of every warp and several
    passes: the kept ones are the lowest indices among the ties, in index
    order.  With 150 ties the digit rounds go on into the index bits."""
    v, n_iter = 3406, 20
    x = np.full(v, 1e-5, F32)
    leaders = [3, 900, 2001]
    x[leaders] = [0.3, 0.2, 0.1]  # three clear leaders
    rng = np.random.default_rng(n_tied)
    tied = rng.choice(np.setdiff1d(np.arange(v), leaders), n_tied, replace=False)
    assert len({(i % THREADS) // 32 for i in tied}) == WARPS  # every warp holds ties
    assert len({i // THREADS for i in tied}) > 1  # and several passes
    x[tied] = 0.3 / n_tied
    probs = np.stack([x] * B)
    g = np.zeros((B, 128), F32)
    for r in range(B):  # each row's noise favours another rank among the ties
        g[r, 3 + (r * 5) % 17] = 50.0
    ids, stats = emulate(probs, F32(1.0), n_iter, g)
    lowest = np.sort(tied)[:n_iter - 3]
    for r in range(B):
        assert ids[r] == lowest[(r * 5) % 17]
        assert not stats[r]["lead_settled"]
        if n_tied > n_iter + SLACK:  # past the value bits: the index bits decide
            assert stats[r]["windows"][0]["index_bits_split"]
    np.testing.assert_array_equal(ids, reference(probs, F32(1.0), n_iter, g))


def _tree_flip_row(rng):
    """A row and top_p where the exclusive running mass at some rank equals
    top_p summed rank by rank but exceeds it summed as a tree: (x, top_p,
    the rank)."""
    v = 3406
    for _ in range(2000):
        x = np.zeros(v, F32)
        idx = rng.choice(v, 96, replace=False)
        x[idx] = rng.random(96).astype(F32) * F32(0.02) + F32(1e-4)
        vals = np.sort(x[x > 0])[::-1]
        t = F32(0)
        for r, val in enumerate(vals):
            if r >= 8 and _tree_sum(vals[:r]) > t:
                return x, t, r
            t = F32(t + val)
    raise AssertionError("no row found")


def test_running_mass_is_summed_rank_by_rank():
    """top_p equals the sequential exclusive mass at rank r, so rank r is
    kept; a tree-ordered sum lands above top_p there and would drop it.
    The noise favours rank r: the kernel's order draws it."""
    rng = np.random.default_rng(11)
    x, top_p, r = _tree_flip_row(rng)
    order = np.argsort(-x, kind="stable")
    probs = np.stack([x] * B)
    g = np.zeros((B, 128), F32)
    g[:, r] = 50.0
    ids, _ = emulate(probs, top_p, 128, g)
    assert (ids == order[r]).all()
    np.testing.assert_array_equal(ids, reference(probs, top_p, 128, g))
    tree, _ = emulate(probs, top_p, 128, g, order="tree")
    assert (tree != order[r]).all()  # the case does tell the orders apart


@pytest.mark.parametrize("kind", ["flat", "ties", "masked"])
def test_windows_beyond_one(kind):
    """k_cap above a window's ranks: the later windows select below the last
    window's smallest key and carry the running mass and the best score."""
    k_cap, top_k, v = 300, 260, 3406
    rng = np.random.default_rng(5)
    probs = probs_of(kind, v, rng)
    key = jax.random.PRNGKey(9)
    g = gumbel(key, k_cap)
    top_p = F32(1.0)
    ids, stats = emulate(probs, top_p, top_k, g)
    np.testing.assert_array_equal(ids, reference(probs, top_p, top_k, g))
    pallas = sample_top_p_k_tpu(jnp.asarray(probs), top_p, top_k, key, k_cap=k_cap,
                                interpret=True)
    np.testing.assert_array_equal(ids, np.asarray(pallas))
    if kind != "masked":  # the masked rows hold fewer than 128 + 260 positives
        assert any(len(s["windows"]) > 1 for s in stats)


def test_lead_round_settles_peaked_rows():
    """Rows whose top one or two entries pass top_p never reach a window."""
    rng = np.random.default_rng(2)
    probs = probs_of("peaked", 3406, rng)
    g = gumbel(jax.random.PRNGKey(0), 128)
    top_p = F32(0.5)
    ids, stats = emulate(probs, top_p, 20, g)
    np.testing.assert_array_equal(ids, reference(probs, top_p, 20, g))
    top2 = np.sort(probs, axis=1)[:, -2:].sum(axis=1)
    assert (top2 > top_p).sum() >= 4
    for r in range(B):
        if top2[r] > top_p:
            assert stats[r]["lead_settled"]


def test_digit_bytes_sums_and_suffix_scan():
    """Each (thread, digit) has its own byte; a warp's lanes at one digit
    hit 32 banks when counting and when summing; the sums per 32 threads
    and per digit, the warp's suffix scan and the scores' unsigned order
    against plain counting and comparing."""
    addr = {hist_address(t, d) for t in range(THREADS) for d in range(32)}
    assert len(addr) == THREADS * 32 and max(addr) < THREADS * 32
    for w in range(WARPS):  # counting one digit: distinct words share no bank
        for d in (0, 5, 31):
            words = {hist_address(32 * w + lane, d) // 4 for lane in range(32)}
            assert len({wd % 32 for wd in words}) == len(words)
        for j in range(8):  # summing: lane d reads word 32 row + (d ^ row) % 32
            row = 8 * w + j
            assert len({(32 * row + ((d ^ row) % 32)) % 32 for d in range(32)}) == 32
    rng = np.random.default_rng(4)
    el = rng.random((14, WARPS, 32)) < 0.7
    d = rng.integers(0, 32, (14, WARPS, 32)).astype(U64)
    expect = np.bincount(d[el].astype(np.int64), minlength=32)
    np.testing.assert_array_equal(bin_totals(digit_hist(el, d)), expect)
    tot = rng.integers(0, 9, 32)
    np.testing.assert_array_equal(suffix_scan(tot), np.cumsum(tot[::-1])[::-1])
    assert ordered(F32(-0.0)) == ordered(F32(0.0)) and ordered(F32(-1)) < ordered(F32(-0.5))
    assert ordered(F32(2)) > ordered(F32(1)) > ordered(F32(0)) > ordered(F32(-np.inf)) > 0


def test_scratch_fits_beside_work_in_the_staged_segment():
    """The routine's scratch (``SampleScratch``) lies after work[V] (rounded
    up to 16 bytes) in the fused kernels' 64 KB staged segment, then the
    mask and allow rows' bytes; the token row wrapper's vocabulary limit is
    the largest V for which all of it fits."""
    listed = WARPS * LEAD
    scratch = (listed * 8 + 3 * WARPS * 4 + WARPS * listed * (8 + 4) + THREADS * 32
               + WARPS * 32 * 4 + (CAP + 8) * (4 + 4) + WIN * (4 + 4) + WARPS * WIN * 4)
    src = (CSRC / "token_row.cuh").read_text()
    assert "sample_scratch_fits(p.V)" in src
    assert tl.SAMPLE_SCRATCH_BYTES == scratch
    assert tl.sample_smem(3406) <= 64 * 1024
    assert tl.sample_smem(tl.MAX_VOCAB) <= 64 * 1024 < tl.sample_smem(tl.MAX_VOCAB + 1)
    assert WARPS * LEAD <= 32  # one lane a lead entry
