"""The whole step's attention phase (``csrc/fused_step.cuh``
``attention_plan`` and ``attention_item``), emulated on the CPU.

The kernel cannot run here, so these tests rebuild what its blocks do from
the source's constants and the wrapper's item rule (``ops/fused_step.py``
``attention_plan``):

- the plan: an event's chunk from its lengths and alive mask alone, items
  slot by slot, every live row in exactly one item, no slot with more items
  than the smallest grid the kernels launch, and every cooperative grid of
  at least that size running each item to its end (no wait for a slot's
  maxima can hang);
- one layer's attention: each item's scores a (row, head) each (int8
  pools one f32 fma chain over the head dims in order, T pools four, the
  dims mod 4, each row's 8-value pieces from piece r on for row r of a
  sub-tile), the slot's maxima exchanged, each weight exp(s - M) against
  the slot-head's maximum over ALL its rows rounded to T (int8: times the v
  scale, to bf16), the exp-sum in the threads' order and P.V row by row,
  the partials merged in item order by the slot's last arrival whatever the
  arrival order, the fresh row's own term, and the append after every read
  of the slot;
- the counters the serving batcher records from the same rule.

The emulated layer is held against ``fused_decode_step_reference``: its
q/k/v rows and its attention output are taken from the plain version's own
products, and its attention is replayed with the plain version's ops.  The
weights agree bit for bit but where the two sides' scores (f32 sums in
another order) round a weight on either side of a rounding midpoint: one
step of T, at a few weights.  Given the same weights the outputs agree
within 1e-5 (f32 sums in another order); the appended rows bit for bit.
"""

from __future__ import annotations

import re
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from midi_model_tpu_torch.models import MIDIModelConfig
from midi_model_tpu_torch.models.llama import apply_rope, rope_cos_sin
from midi_model_tpu_torch.models.midinet import init_model
from midi_model_tpu_torch.ops import event_loop as el
from midi_model_tpu_torch.ops import fused_step as fs
from midi_model_tpu_torch.ops import paged_allheads as pa

from _torch_helpers import one_torch_thread  # noqa: F401 (autouse; also sets full fp32)

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "midi_model_tpu_torch" / "csrc"
F32 = np.float32
SMALLEST_GRID = 128  # the launch floor: kAttnItems blocks (fused_step.cu, event_loop.cu)


def _constants() -> dict:
    src = (CSRC / "fused_step.cuh").read_text()
    found = {}
    for name in ("kAttnItems", "kAttnQuantum", "kAttnChunkMax", "kAttnTileBytes",
                 "kAttnMaxStages", "kAttnGroup"):
        m = re.search(rf"constexpr int {name} = (\d+);", src)
        assert m, f"{name} not found in fused_step.cuh"
        found[name] = int(m.group(1))
    return found


C = _constants()


def test_item_rule_and_launch_floor_follow_the_source():
    assert (fs.ATTN_ITEMS, fs.ATTN_QUANTUM, fs.ATTN_CHUNK_MAX) == (
        C["kAttnItems"], C["kAttnQuantum"], C["kAttnChunkMax"])
    assert SMALLEST_GRID == C["kAttnItems"]
    for name in ("fused_step.cu", "event_loop.cu"):
        src = (CSRC / name).read_text()
        assert re.search(r"launch_cooperative\([^;]*mm::kAttnItems\);", src), name


# ---- the plan -----------------------------------------------------------------

def items_of(lengths, alive=None, chunk=None):
    """The plan's work items in order: (slot, j, first row, rows, slot's
    items); ``chunk`` in place of the plan's, as another batch would give."""
    plan_chunk, n = fs.attention_plan(lengths, alive)
    if chunk is None:
        chunk = plan_chunk
    else:
        live = np.ones(len(lengths), bool) if alive is None else np.asarray(alive, bool)
        n = np.where(live, np.maximum(1, -(-np.asarray(lengths) // chunk)), 0)
    out = []
    for s, n_s in enumerate(n):
        for j in range(n_s):
            r0 = j * chunk
            out.append((s, j, r0, min(chunk, int(lengths[s]) - r0), int(n_s)))
    return chunk, out


def plan_cases():
    rng = np.random.default_rng(0)
    cap = 16 * 64
    edges = np.array([0, 1, 63, 64, 65, 127, 128, cap, 500, 999, 2, 17])
    yield "edges", edges, np.arange(len(edges)) != 6, cap
    yield "one_slot", np.array([cap]), None, cap
    yield "retired_only", np.array([0, 40, 7]), np.zeros(3, bool), cap
    yield "steady", np.exp(rng.uniform(np.log(16), np.log(1536), 32)).astype(int), None, 2048
    live = np.zeros(32, bool)
    live[rng.choice(32, 8, replace=False)] = True
    yield "prompt", np.where(live, rng.integers(1024, 3969, 32), 0), live, 4096
    yield "full_256", np.full(256, 16384), None, 16384
    yield "short_256", rng.integers(0, 40, 256), rng.random(256) < 0.8, 2048


PLAN_CASES = list(plan_cases())


@pytest.mark.parametrize("name,lengths,alive,cap", PLAN_CASES,
                         ids=[c[0] for c in PLAN_CASES])
def test_plan_covers_every_live_row_once(name, lengths, alive, cap):
    """Every live row in exactly one item of at most ``chunk`` rows, slot by
    slot; a live slot of no rows one empty item, a retired slot none; at
    most ATTN_ITEMS items over the slots with rows unless the chunk is at
    its largest; no slot above the smallest grid; the scratch holds them."""
    chunk, items = items_of(lengths, alive)
    live = np.ones(len(lengths), bool) if alive is None else alive
    assert chunk % fs.ATTN_QUANTUM == 0 and fs.ATTN_QUANTUM <= chunk <= fs.ATTN_CHUNK_MAX
    assert [it[0] for it in items] == sorted(it[0] for it in items)
    for s in range(len(lengths)):
        mine = [it for it in items if it[0] == s]
        if not live[s]:
            assert mine == []
            continue
        assert [it[1] for it in mine] == list(range(len(mine)))
        assert 1 <= len(mine) <= SMALLEST_GRID
        if lengths[s] == 0:
            assert [(it[2], it[3]) for it in mine] == [(0, 0)]
            continue
        covered = np.concatenate([np.arange(r0, r0 + n) for _, _, r0, n, _ in mine])
        np.testing.assert_array_equal(covered, np.arange(lengths[s]))
        assert all(1 <= n <= chunk for *_, n, _ in mine)
    with_rows = sum(1 for s, *_ in items if lengths[s] > 0)
    assert with_rows <= fs.ATTN_ITEMS or chunk == fs.ATTN_CHUNK_MAX
    if chunk > fs.ATTN_QUANTUM:  # the smallest chunk that fits: one quantum less does not
        smaller = chunk - fs.ATTN_QUANTUM
        assert np.sum(-(-np.where(live, lengths, 0) // smaller)) > fs.ATTN_ITEMS
    heads, dh = 16, 64
    work = fs.attention_work_floats(len(lengths), heads, dh, cap)
    assert -(-len(lengths) // 32) * 32 + len(items) * 2 * (heads * dh + 2 * heads) <= work


def run_grid(items, grid: int) -> bool:
    """The cooperative grid on the plan: item i on block i % grid, each
    block its items in order; an item of a slot with several items waits,
    after its scores, until every item of the slot has published its
    maxima.  Blocks step in turn; True when every item finished, False when
    no block can move (a hang)."""
    queues = [list(range(b, len(items), grid)) for b in range(grid)]
    published = {}
    state = [0] * grid  # 0: scores to do, 1: waiting for the slot's maxima
    while any(queues):
        moved = False
        for b in range(grid):
            if not queues[b]:
                continue
            s, _, _, _, n_s = items[queues[b][0]]
            if state[b] == 0:
                published[s] = published.get(s, 0) + 1
                state[b], moved = 1, True
            if state[b] == 1 and (n_s == 1 or published[s] == n_s):
                queues[b].pop(0)
                state[b], moved = 0, True
        if not moved:
            return False
    return True


@pytest.mark.parametrize("name,lengths,alive,cap", PLAN_CASES,
                         ids=[c[0] for c in PLAN_CASES])
def test_plan_runs_on_every_grid_without_a_hang(name, lengths, alive, cap):
    """The plan reads no grid size: the same items run to their end on the
    smallest grid the kernels launch and on larger ones; a grid smaller than
    a slot's items would hang, which the launch floor refuses."""
    _, items = items_of(lengths, alive)
    for grid in (SMALLEST_GRID, 132, 133, 264):
        assert run_grid(items, grid)
    most = max([it[4] for it in items], default=0)
    if most > 1:
        assert not run_grid(items, most - 1)


def test_counters_follow_the_ragged_loops_tables():
    """``chunk_attention_counts`` sums the plan over a launch's events with
    the ragged loop's own geometry (``event_loop._ragged_tables``) and its
    capacity retirement (no eos)."""
    rng = np.random.default_rng(3)
    cap, n_ev = 256, 9
    index = np.array([0, 5, 100, 250, 252, 255, 256, 31, 8, 200])
    active = rng.random(len(index)) < 0.8
    active[3] = True
    _, lengths, _ = el._ragged_tables(torch.as_tensor(index), n_ev, cap)
    alive = active.copy()
    items = split = 0
    for e in range(n_ev):
        if e:  # the kernel's retirement after event e-1: its length + 1 reaches capacity
            alive &= lengths[e - 1].numpy() + 1 < cap
        _, n = fs.attention_plan(lengths[e].numpy(), alive)
        items += int(n.sum())
        split += int((n > 1).sum())
    assert fs.chunk_attention_counts(index, active, n_ev, cap) == (items, split)
    assert split > 0


# ---- one layer's attention ------------------------------------------------------

def tile_rows(h: int, dh: int, elem: int, t_elem: int) -> int:
    """``attn_layout``'s rows of a sub-tile: a power of two of about
    kAttnTileBytes, halved until two ring slots fit the phase's shared
    memory (the staged segment, plus the reductions' buffers on tensor
    cores)."""
    w = h * dh
    quant = elem == 1
    budget = 64 * 1024 + (20 * 1024 if t_elem == 2 else 0)
    vec = -(-w * t_elem // 16) * 16
    fixed = (3 * vec + h * (C["kAttnChunkMax"] + 16) * 4 * (2 if quant else 1) + 256 * 4
             + h * C["kAttnChunkMax"] // C["kAttnGroup"] * 4)
    ring = -(-fixed // 128) * 128
    rows = 1
    while rows < 32 and 2 * rows * w * elem <= C["kAttnTileBytes"]:
        rows *= 2
    while True:
        stage = -(-rows * (w * elem + (256 if quant else 0)) // 128) * 128
        if (budget - ring) // stage >= 2 or rows == 1:
            return rows
        rows //= 2


def _fma(a, b, c):
    """fmaf in f32 (the product exact in f64, one rounding of the sum)."""
    return (np.asarray(a, np.float64) * np.asarray(b, np.float64)
            + np.asarray(c, np.float64)).astype(F32)


def _round(x: np.ndarray, dtype) -> np.ndarray:
    return torch.from_numpy(np.ascontiguousarray(x, F32)).to(dtype).float().numpy()


def _exp(x: np.ndarray) -> np.ndarray:
    return torch.exp(torch.from_numpy(np.ascontiguousarray(x, F32))).numpy()


def _grid(x: np.ndarray) -> np.ndarray:
    """``attn_grid``: an f32 group sum on the grid of 2^-32, in f64."""
    return np.rint(np.asarray(x, F32).astype(np.float64) * 2.0 ** 32)


def emulate_layer(qkv, cos, sin, lengths, k, v, ks, vs, *, h, dh, dtype, kv_dtype, scale,
                  order_seed, chunk=None):
    """The attention phase of one layer over numpy pools k, v [B, cap, H, dh]
    (f32 copies of the pool values; int8: scales ks, vs [B, cap, H]), with
    the items' blocks finishing in a random order.  Returns (out [B, W] in
    f32 before its rounding to T, weights [B, H, cap], M [B, H], the
    appended (k, v) rows [B, W] in T, each slot's item count)."""
    b = qkv.shape[0]
    w = h * dh
    quant = kv_dtype == torch.int8
    wdt = torch.bfloat16 if quant else kv_dtype
    q4 = qkv.view(b, 1, 3, h, dh)
    qr = apply_rope(q4[:, :, 0], cos, sin)[:, 0].float().numpy()  # [B, H, dh]
    kr = apply_rope(q4[:, :, 1], cos, sin)[:, 0]
    vn = q4[:, 0, 2].float().numpy()
    qs32 = (qr * F32(scale)).astype(F32)
    qsb = _round(qs32, dtype)
    chunk, items = items_of(lengths, chunk=chunk)
    n_of = np.zeros(len(lengths), int)
    for it in items:
        n_of[it[0]] = it[4]
    cap = k.shape[1]
    step = 256 // h  # the kernel's 256 threads: threads a head
    rows = tile_rows(h, dh, torch.tensor([], dtype=kv_dtype).element_size(),
                     torch.tensor([], dtype=dtype).element_size())
    sc = np.full((b, h, cap), -np.inf, F32)
    local = {}
    for s, j, r0, n, _ in items:  # pass 1: a (row, head) score each
        # int8: one thread a (row, head), one fma chain over the dims in order;
        # T pools: two threads (while 2 rows x heads fit 256 threads), each four
        # chains (the dims mod 4) over half of every 64 dims' 8-value pieces,
        # row r of the item from piece r mod 8 on; their sums added
        kk, qq = k[s, r0:r0 + n], qsb[s]  # [n, H, dh], [H, dh]
        if quant:
            acc = np.zeros((n, h), F32)
            for d in range(dh):
                acc = _fma(qq[None, :, d], kk[:, :, d], acc)
            acc = (acc * ks[s, r0:r0 + n]).astype(F32)
        else:
            split = 2 if rows * h * 2 <= 256 else 1
            rot = np.arange(n) % 8
            halves = []
            for part in range(split):
                chains = np.zeros((4, n, h), F32)
                for c0 in range(0, dh, 64):
                    for i in range(8 // split):
                        piece = c0 + 8 * ((part * (8 // split) + i + rot) % 8)  # [n]
                        for e in range(8):
                            d = piece + e
                            kd = np.take_along_axis(kk, d[:, None, None], axis=2)[..., 0]
                            chains[e % 4] = _fma(qq[:, d].T, kd, chains[e % 4])
                halves.append(((chains[0] + chains[1]).astype(F32)
                               + (chains[2] + chains[3]).astype(F32)).astype(F32))
            acc = halves[0] if split == 1 else (halves[0] + halves[1]).astype(F32)
        sc[s, :, r0:r0 + n] = acc.T
        local[s, j] = acc.max(axis=0) if n else np.full(h, -np.inf, F32)
    big = np.stack([np.max([local[s, j] for j in range(n_s)], axis=0)
                    for s, n_s in enumerate(n_of)])  # [B, H]
    weights = np.zeros((b, h, cap), F32)
    partial = {}
    for s, j, r0, n, _ in items:  # pass 2: weights, exp-sum and P.V, row by row
        pe = _exp(sc[s, :, r0:r0 + n] - big[s, :, None])  # [H, n]
        pw = _round(pe * vs[s, r0:r0 + n].T, wdt) if quant else _round(pe, wdt)
        weights[s, :, r0:r0 + n] = pw
        # each group of 8 rows of the slot in f32, in order; the groups on the grid
        l = np.zeros(h, np.float64)
        acc = np.zeros((h, dh), np.float64)
        for g0 in range(0, n, 8):
            lg = np.zeros(h, F32)
            ag = np.zeros((h, dh), F32)
            for t in range(g0, min(g0 + 8, n)):
                lg = (lg + pe[:, t]).astype(F32)
                ag = _fma(pw[:, t, None], v[s, r0 + t], ag)
            l += _grid(lg)
            acc += _grid(ag)
        partial[s, j] = acc, l
    out = np.zeros((b, w), F32)
    arrived = {}
    rng = np.random.default_rng(order_seed)
    for idx in rng.permutation(len(items)):
        s, _, _, _, n_s = items[idx]
        arrived[s] = arrived.get(s, 0) + 1
        if arrived[s] < n_s:
            continue
        acc, l = partial[s, 0]
        for j in range(1, n_s):  # the last arrival merges in item order
            acc = acc + partial[s, j][0]
            l = l + partial[s, j][1]
        acc = (acc * 2.0 ** -32).astype(F32)
        l = (l * 2.0 ** -32).astype(F32)
        # the fresh row's own score: each thread its W / 256 dims in order,
        # then the threads of a head in order
        per = w // 256
        parts = np.zeros((h, dh // per), F32)
        krs = kr[s].float().numpy()
        for i in range(per):
            parts = _fma(qs32[s, :, i::per], krs[:, i::per], parts)
        s_self = np.zeros(h, F32)
        for t in range(dh // per):
            s_self = (s_self + parts[:, t]).astype(F32)
        m2 = np.maximum(big[s], s_self)
        wc = (l * _exp(big[s] - m2)).astype(F32)
        ws = _exp(s_self - m2)
        o = np.where(l[:, None] > 0, acc / np.where(l > 0, l, 1)[:, None], 0).astype(F32)
        num = (wc[:, None] * o + ws[:, None] * vn[s]).astype(F32)
        out[s] = (num / (wc + ws)[:, None]).astype(F32).reshape(w)
    fresh = (kr.reshape(b, w), q4[:, 0, 2].reshape(b, w))
    return out, weights, big, fresh, n_of


def replay_attention(qkv, cos, sin, lengths, kc, vc, ks, vs, *, h, dh, dtype, quant,
                     weights=None):
    """The plain version's attention of one layer (``fused_decode_step_
    reference``'s ops), optionally with the softmax weights given."""
    b = qkv.shape[0]
    cap = kc.shape[1]
    q4 = qkv.view(b, 1, 3, h, dh)
    qr = apply_rope(q4[:, :, 0], cos, sin)[:, 0]
    kr = apply_rope(q4[:, :, 1], cos, sin)[:, 0]
    v = q4[:, 0, 2]
    qs32 = qr.float() * dh ** -0.5
    qsb = qs32.to(dtype).float()
    valid = torch.arange(cap)[None, None, :] < torch.as_tensor(lengths)[:, None, None]
    scores = torch.einsum("bhd,bthd->bht", qsb, kc.float())
    if quant:
        scores = scores * ks.transpose(1, 2)
    scores = torch.where(valid, scores, -torch.inf)
    m = scores.max(dim=-1).values
    pexp = torch.where(valid, torch.exp(scores - m[..., None]), 0.0)
    l = pexp.sum(dim=-1)
    if weights is None:
        weights = ((pexp * vs.transpose(1, 2)).to(torch.bfloat16) if quant
                   else pexp.to(vc.dtype)).float()
    acc = torch.einsum("bht,bthd->bhd", weights, vc.float())
    o = acc / torch.clamp(l, min=1e-30)[..., None]
    s_self = torch.sum(qs32 * kr.float(), dim=-1)
    m2 = torch.maximum(m, s_self)
    w_cache = l * torch.exp(m - m2)
    w_self = torch.exp(s_self - m2)
    attn = ((w_cache[..., None] * o + w_self[..., None] * v.float())
            / (w_cache + w_self)[..., None])
    return attn.reshape(b, h * dh), weights, m


class _Products:
    """``F`` for the plain version, keeping each product's input and output."""

    def __init__(self):
        self.calls = []

    def linear(self, x, weight):
        y = F.linear(x, weight)
        self.calls.append((x, y))
        return y

    def __getattr__(self, name):
        return getattr(F, name)


PS, PPS = 16, 16
CAP = PS * PPS
LENGTHS = np.array([0, 1, 15, 16, 17, CAP, 100, 33, 255, 40, 2, 64])
ACTIVE = np.arange(len(LENGTHS)) != 9


@pytest.mark.parametrize("dtype,kv", [("f32", "f32"), ("bf16", "bf16"), ("f32", "int8"),
                                      ("bf16", "int8")])
def test_emulated_layer_matches_the_plain_version(dtype, kv, monkeypatch):
    """One layer of the per-event kernel on ragged lengths (0, 1, page
    edges, capacity, an inactive slot: length 0): the emulated weights, its
    output and its appends against the plain version's; the arrival order
    moves no bit; the slots of several items take M over all their rows."""
    wdt = {"f32": torch.float32, "bf16": torch.bfloat16}[dtype]
    kdt = {"f32": torch.float32, "bf16": torch.bfloat16, "int8": torch.int8}[kv]
    cfg = MIDIModelConfig.get_config("v2", True, n_layer=1, n_head=8, n_embd=512, n_inner=64)
    net = cfg.net
    h, dh = net.num_heads, net.head_dim
    w = h * dh
    b = len(LENGTHS)
    fused = fs.prepare_fused(init_model(cfg, seed=4, dtype=wdt, device="cpu").net)
    gen = torch.Generator().manual_seed(5)
    n_pages = b * PPS
    if kdt == torch.int8:
        k0, v0 = (torch.randint(-127, 128, (n_pages, PS, w), generator=gen, dtype=torch.int8)
                  for _ in range(2))
        s0 = (torch.rand((n_pages, PS, pa.LANE), generator=gen) * 0.02 + 1e-3).to(torch.bfloat16)
        pools = pa.PagedPools(k0.clone(), v0.clone(), s0.clone())
    else:
        k0, v0 = (torch.randn((n_pages, PS, w), generator=gen).to(kdt) for _ in range(2))
        s0 = None
        pools = pa.PagedPools(k0.clone(), v0.clone())
    x = torch.randn((b, net.hidden_size), generator=gen) * 0.5
    index = torch.as_tensor(LENGTHS, dtype=torch.int32)
    active = torch.as_tensor(ACTIVE)
    products = _Products()
    monkeypatch.setattr(fs, "F", products)
    fs.fused_decode_step_reference(fused, net, x, pools, index, active, page_size=PS,
                                   pages_per_slot=PPS)
    monkeypatch.undo()
    qkv, attn_t = products.calls[0][1], products.calls[1][0]

    lengths = np.where(ACTIVE, np.minimum(LENGTHS, CAP), 0)  # the per-event kernel's table
    cos, sin = rope_cos_sin(index.long()[:, None], dh, net.rope_theta)
    kc = k0.view(b, CAP, h, dh)
    vc = v0.view(b, CAP, h, dh)
    ks = vs = None
    if s0 is not None:
        srow = s0.view(b, CAP, pa.LANE).float()
        ks, vs = srow[..., :h], srow[..., h:2 * h]
    kw = dict(h=h, dh=dh, dtype=wdt)
    quant = kdt == torch.int8
    ref, w_ref, m_ref = replay_attention(qkv, cos, sin, lengths, kc, vc, ks, vs,
                                         quant=quant, **kw)
    assert torch.equal(ref.to(wdt), attn_t)  # the replay is the plain version's attention

    emu_args = (qkv, cos, sin, lengths, kc.float().numpy(), vc.float().numpy(),
                None if ks is None else ks.numpy(), None if vs is None else vs.numpy())
    out, weights, big, fresh, n_items = emulate_layer(*emu_args, kv_dtype=kdt,
                                                      scale=dh ** -0.5, order_seed=6, **kw)
    out2, *_ = emulate_layer(*emu_args, kv_dtype=kdt, scale=dh ** -0.5, order_seed=7, **kw)
    np.testing.assert_array_equal(out, out2)  # merged in item order, whatever the arrivals
    assert (n_items > 1).sum() >= 3

    # M over all the slot-head's rows: the plain version's maximum
    live = lengths > 0
    np.testing.assert_allclose(big[live], m_ref.numpy()[live], rtol=1e-6, atol=1e-6)
    # the weights: bit for bit, but one step of T at a rounding midpoint
    wr = w_ref.numpy()
    if wdt == torch.float32 and not quant:
        np.testing.assert_allclose(weights, wr, rtol=1e-5, atol=1e-7)
    else:
        flipped = weights != wr
        assert flipped.sum() <= max(2, flipped.size // 1000)
        step = np.abs(wr) * 2.0 ** -7
        assert np.all(np.abs(weights - wr)[flipped] <= step[flipped])
    # given the same weights, the output within f32 sums in another order
    same, _, _ = replay_attention(qkv, cos, sin, lengths, kc, vc, ks, vs, quant=quant,
                                  weights=torch.from_numpy(weights), **kw)
    np.testing.assert_allclose(out, same.numpy(), rtol=1e-5, atol=1e-5)
    # the appends: the plain version's rows (T pools), after every read
    if not quant:
        wpos = np.clip(LENGTHS, 0, CAP - 1)
        for s in range(b):
            page, off = s * PPS + wpos[s] // PS, wpos[s] % PS
            assert torch.equal(pools.k[page, off], fresh[0][s].to(kdt))
            assert torch.equal(pools.v[page, off], fresh[1][s].to(kdt))


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_a_slots_output_does_not_depend_on_its_split(kv):
    """The chunk is the batch's: other slots' lengths move a slot's item
    boundaries.  Its output is the same bits under any chunk (sums by groups
    of 8 rows of the slot, the groups on an exact grid), so a request's rows
    do not depend on what shares the batch."""
    kdt = {"bf16": torch.bfloat16, "int8": torch.int8}[kv]
    rng = np.random.default_rng(9)
    h, dh, b, cap = 8, 64, 3, 640
    lengths = np.array([637, 200, 9])
    gen = torch.Generator().manual_seed(10)
    qkv = (torch.randn((b, 3 * h * dh), generator=gen) * 0.5).to(torch.bfloat16)
    cos, sin = rope_cos_sin(torch.as_tensor(lengths)[:, None], dh, 10000.0)
    if kdt == torch.int8:
        k = rng.integers(-127, 128, (b, cap, h, dh)).astype(F32)
        v = rng.integers(-127, 128, (b, cap, h, dh)).astype(F32)
        ks = _round(rng.uniform(1e-3, 0.02, (b, cap, h)), torch.bfloat16)
        vs = _round(rng.uniform(1e-3, 0.02, (b, cap, h)), torch.bfloat16)
    else:
        k, v = (_round(rng.normal(size=(b, cap, h, dh)), torch.bfloat16) for _ in range(2))
        ks = vs = None
    kw = dict(h=h, dh=dh, dtype=torch.bfloat16, kv_dtype=kdt, scale=dh ** -0.5, order_seed=1)
    outs = [emulate_layer(qkv, cos, sin, lengths, k, v, ks, vs, chunk=c, **kw)[0]
            for c in (8, 24, 96, fs.ATTN_CHUNK_MAX)]
    for out in outs[1:]:
        np.testing.assert_array_equal(out, outs[0])
