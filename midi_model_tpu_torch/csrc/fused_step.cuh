// One event-net decode step over ALL layers as a device function of a
// cooperative grid.  fused_step.cu launches it alone (one event per
// launch); event_loop.cu runs it once per event, after the token row.
//
// What it computes (the plain version is
// midi_model_tpu_torch/ops/fused_step.py, fused_decode_step_reference), for
// each layer of an MHA Llama stack with packed pages (head_stride ==
// head_dim) and one new row per slot b: RMSNorm, the fused q/k/v product,
// RoPE at the slot's position; paged attention of the query over the slot's
// first lengths[b] cached rows (pools [n_pages, page_size, H*dh] in T, the
// layer axis folded into pages, slot b's pages contiguous from
// (layer*B + b) * pages_per_slot) with the fresh row's own term merged in
// f32; the append of the fresh k/v row at wpos[b]; o-proj and the SwiGLU
// MLP with residual adds in T.  Rounding points are the TPU kernel's: the
// query is pre-scaled in f32, the cache scores use it rounded to T (qsb),
// the self term the f32 one (qs32); the softmax weights are rounded to T
// before P.V, the normalizer l and the merge stay f32.  The residual stream
// x [B, D] is updated in place; the final norm stays outside.
//
// int8 pools (KV = signed char, the TPU kernel's `quantized` form): the
// pools are READ ONLY.  A cached row dequantizes inside the attention math
// from the bf16 scale pool [n_pages, page_size, 128] (k scales in lanes
// [0:H], v scales in [H:2H]): score = (k_int8 . qsb) * k_scale, exact
// products summed in f32; the v scale folds into the softmax weight, which
// is rounded to bf16 before P.V (pexp * v_scale), while l sums pexp without
// it.  Each layer's fresh k/v rows (in T) go to the [L, B, W] outputs
// fresh_k / fresh_v instead of the pools: the wrapper quantizes them per
// token and head and scatters them (ops/fused_step.py), as the TPU kernel's
// wrapper does.
//
// Design: five phases per layer separated by a global-memory grid barrier:
// norm + q/k/v; attention; o-proj; norm + gate/up + SiLU; down.  The matrix
// phases are decode.cuh's: bf16 on tensor cores with each phase's weights
// (tensor maps over the stacked [L * rows, K] weights) prefetched by TMA
// before the barrier that precedes it — the o-proj weights land during the
// attention phase —, f32 on CUDA cores.
//
// The attention phase (attention_item) splits each slot's cached rows over
// the whole grid, in the space of the staged activation segment:
// - Work items by lengths alone.  An item is a chunk of one live slot's
//   rows for ALL heads (whole W-wide rows).  The chunk is the smallest
//   multiple of kAttnQuantum rows (at most kAttnChunkMax) that cuts the
//   event's live rows into at most kAttnItems items; items run slot by slot,
//   item i on block i % gridDim.  The plan (attention_plan, once an event)
//   reads the lengths and the alive mask only, never gridDim, so the event
//   loop and the per-event kernel compute the same sums whatever their block
//   counts.  A live slot of no rows is one item of no rows; a retired slot
//   has none.
// - Rows by bulk copies.  A slot's pages are contiguous, so an item's k
//   rows, then its v rows, stream as sub-tiles of `rows` rows through a ring
//   (cp.async.bulk, one copy a sub-tile, completing on an mbarrier; int8:
//   and one of its rows' scale rows): the phase's own slots and, where a
//   sub-tile fits one, the product ring's slots that the o-proj prefetch
//   leaves free, up to 12 sub-tiles (192 KB at tv2o's widths) in flight.
//   Meanwhile all threads stage the fresh row: q and k after RoPE, v, and
//   the fresh row's own score per head.
// - The plain version's rounding point.  Pass 1: row r of each sub-tile and
//   head h (int8 pools: one thread, the score one f32 fma chain over the
//   head dims in order, times the row's k scale; T pools: two threads, each
//   four chains, the dims mod 4, over half the head's 8-value pieces, their
//   sums added), kept in shared memory with its maximum.  Row r reads its
//   head slice from piece r on (rows 2 KB apart share banks), and int8
//   rotates the pieces back in registers to keep the chain's order.  A
//   slot of several items then exchanges the items' maxima through global
//   memory (64-bit words, the layer's flag over the value, which the
//   slot's items poll; items run in slot order and no slot has more items
//   than blocks, so every wait ends; a trap after a few seconds
//   otherwise).  Every weight is exp(s - M) against the maximum M
//   over ALL the slot-head's rows, rounded to T before P.V (int8: times the
//   v scale, rounded to bf16) — an online softmax would move that rounding
//   point.  Pass 2: P.V, each thread W / 256 consecutive dims of every row
//   in order.
// - The same bits whatever shares the batch.  Other slots' lengths move a
//   slot's item boundaries, so nothing a slot computes depends on them: a
//   row's pieces rotate by its index in the slot, and the P.V sums and the
//   exp-sum run in f32 over groups of 8 rows of the slot, whose sums add on
//   an exact grid in f64 (attn_grid) — in any order, so across items too.
// - Merge in item order, then append.  A slot of one item finishes from
//   registers.  Otherwise each item writes its partial (the P.V sums and the
//   exp-sum l, all against the same M) to global scratch and takes a ticket;
//   the last merges the partials in item order (bits independent of arrival
//   order), merges the fresh row's own term in f32, normalises and only
//   then appends the fresh row at wpos: every item of the slot has read its
//   rows, the capacity clip's row included.
// The paged decode routine (paged_decode.cuh) splits rows the same way but
// spreads a row over lanes with an online softmax; here one thread keeps a
// (row, head) score in the fma order the int8 checks emulate.
#pragma once

#include <type_traits>

#include "decode.cuh"
#include "paged_decode.cuh"

namespace mm {

constexpr int kStepMaxHeadDim = 128;
constexpr int kScaleLanes = 128;  // the int8 pools' scale row: k in [0:H], v in [H:2H]

// The attention phase's plan and staging (see the top)
constexpr int kAttnItems = 128;        // work items a layer, at most (<= the smallest grid)
constexpr int kAttnQuantum = 8;        // a chunk is a multiple of this many rows
constexpr int kAttnChunkMax = 256;     // rows of a chunk, at most (its scores in shared memory)
constexpr int kAttnTileBytes = 16384;  // a sub-tile's rows, about
constexpr int kAttnMaxStages = 4;      // ring slots
constexpr int kAttnMaxHeads = 32;      // 2H scale lanes
constexpr int kAttnMaxPer = 8;         // dims a thread in the fresh row and P.V (W <= 2048)
constexpr long long kAttnWaitNs = 4000000000ll;  // a wait for a slot's maxima traps after this

// KV: the pools' element type, T (updated in place) or signed char (int8,
// read only).
template <typename T, typename KV = T>
struct StepParams {
  static constexpr bool kQuant = std::is_same<KV, signed char>::value;
  // bf16: tensor maps over wqkv [L*3W, D], wo [L*D, W], wgu [L*2F, D], wd [L*D, F]
  CUtensorMap tm_qkv, tm_o, tm_gu, tm_d;
  const T *wqkv, *wo, *wgu, *wd, *ln;  // [L,3W,D], [L,D,W], [L,2F,D], [L,D,F], [L,2,D]
  const float *cos, *sin;              // [n_events, B, dh] at each slot's position
  const int *lengths, *wpos;           // [n_events, B]
  KV *k_pool, *v_pool;                 // [n_pages, page_size, W]
  T *x;                                // [B, D] residual stream, in place
  // scratch; fresh_k: int8 pools' [L, B, W] output (unused for T pools)
  T *qkv, *attn, *fresh_k, *gated;
  unsigned int* bar;                   // zeroed {count, generation}
  const __nv_bfloat16* scales;         // int8 pools: [n_pages, page_size, 128]; else null
  T* fresh_v;                          // int8 pools: [L, B, W] output; else null
  // The ragged event loop's per-slot alive mask [B] (null otherwise): a
  // retired slot attends over nothing, appends nothing and keeps its
  // residual frozen.
  const unsigned char* alive;
  unsigned long long* clock;  // the phase clock (PhaseSync) or null
  // the attention phase's global scratch: an arrival counter a slot,
  // then a record an item (attn_counter_floats, attn_record_floats)
  float* work;
  int B, D, H, dh, F, L, page_size, pps;
  float eps, scale;
};

template <typename T, typename KV>
__device__ __forceinline__ bool retired(const StepParams<T, KV>& p, int b) {
  return p.alive != nullptr && !p.alive[b];
}

// ---- the attention phase ------------------------------------------------------

// Bytes of the staged segment's space the attention phase may take: the
// segment and, on tensor cores, the product reduction's buffers after it
// (unused between the q/k/v and o-proj products).
template <typename T>
__host__ __device__ constexpr size_t attn_budget() {
  return kTensorCores<T> ? kTcActBytes + kTcRedBytes + kTcResBytes : kGemvSmem;
}

// The attention phase's global scratch, in floats: an arrival counter a
// slot (ints), then one record an item of 64-bit words: its heads' maxima
// [H] (the layer's flag over the float's bits), exp-sums [H] and P.V sums
// [W] (doubles on the grid of attn_grid).
__host__ __device__ inline int attn_counter_floats(int B) { return (B + 31) / 32 * 32; }
__host__ __device__ inline int attn_record_floats(int H, int dh) { return 2 * (H * dh + 2 * H); }

// A slot's sums (P.V and the exp-sum) do not depend on how its rows are cut
// into items, so a request's rows do not depend on what shares the batch:
// each sum runs in f32 over groups of kAttnGroup rows of the slot, in row
// order, and the groups' sums are added on a grid of 2^-32 in f64, which is
// exact (so in any order) while a slot's sum stays under 2^21.
constexpr int kAttnGroup = 8;
__device__ __forceinline__ double attn_grid(float group_sum) {
  return rint(static_cast<double>(group_sum) * 0x1p32);
}

// A head's row of scores: the chunk's rows, padded so that the rows of two
// heads that threads of one warp read fall in other banks.
constexpr int kAttnScoreStride = kAttnChunkMax + 16;

// Shared memory of the attention phase (byte offsets in attn_budget bytes).
struct AttnLayout {
  int rows;         // rows of a sub-tile: a power of two, about kAttnTileBytes of them
  int stages;       // ring slots that fit (the kernels need two)
  int row_bytes;    // a staged row: W values
  int scale_bytes;  // int8: a row's scale row (kScaleLanes bf16); else 0
  int stage_bytes;  // a ring slot: the rows, then (int8) their scale rows
  int q;            // T [W]: the scaled query rounded to T (qsb)
  int k, v;         // T [W]: the fresh row's k after RoPE, and its v
  int sc;           // f32 [H][kAttnScoreStride]: the item's scores, then its weights
  int vs;           // int8: f32 [H][kAttnScoreStride]: its rows' v scales
  int lp;           // f32 [kDecThreads]: the threads' partial sums
  int lg;           // f64 [kAttnChunkMax / kAttnGroup][H]: the groups' exp-sums, on the grid
  int tot;          // f64 [W]: the P.V sums, on the grid
  int ring;
};

__host__ __device__ inline AttnLayout attn_layout(int H, int dh, int elem, int t_elem, bool quant,
                                                  size_t budget) {
  AttnLayout a;
  const int W = H * dh;
  const int vec = static_cast<int>(paged::round_up(W * t_elem, 16));
  a.row_bytes = W * elem;
  a.scale_bytes = quant ? kScaleLanes * 2 : 0;
  a.q = 0;
  a.k = a.q + vec;
  a.v = a.k + vec;
  a.sc = a.v + vec;
  a.vs = a.sc + H * kAttnScoreStride * 4;
  a.lp = a.vs + (quant ? H * kAttnScoreStride * 4 : 0);
  a.lg = a.lp + kDecThreads * 4;
  a.tot = a.lg + H * (kAttnChunkMax / kAttnGroup) * 8;
  a.ring = static_cast<int>(paged::round_up(a.tot + W * 8, 128));
  a.rows = 1;
  while (a.rows < 32 && 2 * a.rows * W * elem <= kAttnTileBytes) a.rows *= 2;
  for (;;) {  // halve the sub-tile until two ring slots fit
    a.stage_bytes =
        static_cast<int>(paged::round_up(a.rows * (a.row_bytes + a.scale_bytes), 128));
    const long long fit = (static_cast<long long>(budget) - a.ring) / a.stage_bytes;
    a.stages = fit < 0 ? 0 : fit > kAttnMaxStages ? kAttnMaxStages : static_cast<int>(fit);
    if (a.stages >= 2 || a.rows == 1) return a;
    a.rows /= 2;
  }
}

// Ring slots of the attention phase at most: its own, and the product ring's
// (on tensor cores it holds no more than the o-proj prefetch then).
constexpr int kAttnRingMax = kAttnMaxStages + kTcStages;

// The attention phases' shared state for one event (fused_step_body's).
struct AttnShared {
  uint64_t bars[kAttnRingMax];    // the ring's mbarriers
  uint32_t slot[kAttnRingMax];    // the ring: each slot's shared address, this item
  int first[kMaxBatch + 1];       // slot b's first item; first[B]: the number of items
  float m[kAttnMaxHeads];         // the item's, then the slot's maximum, a head
  double l[kAttnMaxHeads];        // the exp-sum a head, on attn_grid's grid
  float self[kAttnMaxHeads];      // the fresh row's own score a head (qs32 . k)
  int chunk, last;
};

// P.V over rows [0, ns) of a staged v sub-tile (row0 its first row's index
// in the item, which starts a group) for N consecutive dims from e0:
// group[k] += w[row] * v[row][e0 + k] row by row, each group's sum added to
// tot[k] (shared memory) on attn_grid's grid as the group ends.
template <int N, typename KV>
__device__ __forceinline__ void pv_rows(const uint8_t* tile, int row_bytes, int e0, int row0,
                                        int ns, const float* w, float* group, double* tot) {
  for (int g0 = 0; g0 < ns; g0 += kAttnGroup) {
    const int g1 = min(ns, g0 + kAttnGroup);
#pragma unroll 4
    for (int rr = g0; rr < g1; ++rr) {
      float v[N];
      paged::load_n<N>(reinterpret_cast<const KV*>(tile + rr * row_bytes) + e0, v);
      const float wr = w[rr];
#pragma unroll
      for (int k = 0; k < N; ++k) group[k] = fmaf(wr, v[k], group[k]);
    }
    if ((row0 + g1) % kAttnGroup == 0) {
#pragma unroll
      for (int k = 0; k < N; ++k) {
        tot[k] += attn_grid(group[k]);
        group[k] = 0.f;
      }
    }
  }
}

// The attention phases' plan for event ev, from its lengths and the alive
// mask alone: the chunk and each slot's first item (as.chunk, as.first); and
// the ring's mbarriers, ready.  Every thread of the block calls it (a slot a
// thread).
template <typename T, typename KV>
__device__ void attention_plan(const StepParams<T, KV>& p, int ev, AttnShared& as) {
  static_assert(kMaxBatch <= kDecThreads, "a slot a thread");
  __shared__ int part[kDecWarps];
  const int b = threadIdx.x, warp = b >> 5, lane = b & 31;
  const bool live = b < p.B && !retired(p, b);
  const int rows = live ? p.lengths[ev * p.B + b] : 0;
  auto block_sum = [&](int v) {
    v = __reduce_add_sync(0xffffffffu, v);
    if (lane == 0) part[warp] = v;
    __syncthreads();
    int total = 0;
    for (int w = 0; w < kDecWarps; ++w) total += part[w];
    __syncthreads();
    return total;
  };
  // the smallest chunk, in quanta, that cuts the rows into at most
  // kAttnItems items (their number falls as the chunk grows); a slot of no
  // rows does not count
  int lo = 1, hi = kAttnChunkMax / kAttnQuantum;
  while (lo < hi) {
    const int mid = (lo + hi) / 2, c = mid * kAttnQuantum;
    if (block_sum((rows + c - 1) / c) <= kAttnItems) hi = mid;
    else lo = mid + 1;
  }
  const int chunk = lo * kAttnQuantum;
  const int mine = live ? max(1, (rows + chunk - 1) / chunk) : 0;
  int incl = mine;  // the slots' items, scanned
  for (int off = 1; off < 32; off <<= 1) {
    const int up = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += up;
  }
  if (lane == 31) part[warp] = incl;
  if (b == 0) {
    for (int i = 0; i < kAttnRingMax; ++i) sm90::mbar_init(sm90::smem_u32(as.bars + i), 1);
    sm90::fence_barrier_init();
  }
  __syncthreads();
  int before = 0, total = 0;
  for (int w = 0; w < kDecWarps; ++w) {
    before += w < warp ? part[w] : 0;
    total += part[w];
  }
  if (b < p.B) as.first[b] = before + incl - mine;
  if (b == 0) {
    as.first[p.B] = total;
    as.chunk = chunk;
  }
  // the maxima words of this block's items start at flag 0 (no layer); the
  // grid barrier after the first q/k/v phase publishes them
  const int rec = attn_record_floats(p.H, p.dh);
  for (int item = blockIdx.x; item < total; item += gridDim.x)
    for (int h = b; h < p.H; h += kDecThreads)
      __stcg(reinterpret_cast<unsigned long long*>(
                 p.work + attn_counter_floats(p.B) + static_cast<size_t>(item) * rec) + h,
             0ull);
  __syncthreads();
}

// One work item's geometry and the copies of its sub-tiles.
template <typename T, typename KV>
struct AttnItem {
  static constexpr bool kQuant = StepParams<T, KV>::kQuant;
  static constexpr int kElem = sizeof(KV);
  AttnLayout lay;
  int s, j, n_items;  // the slot, the item's index in it, the slot's items
  int slot;           // this event's row of the geometry tables
  int r0, n, n_tiles;  // rows [r0, r0 + n) of the slot, in sub-tiles
  int S;              // ring slots: the phase's own, then the product ring's free ones
  size_t base;        // slot s's row 0 of layer li in the pools

  // item of layer li at event ev; thread 0 also lays the ring out in
  // as.slot; smem: the staged segment's space
  __device__ AttnItem(const StepParams<T, KV>& p, int ev, int li, int item, AttnShared& as,
                      const Tc<T>& tc, uint8_t* smem)
      : lay(attn_layout(p.H, p.dh, kElem, sizeof(T), kQuant, attn_budget<T>())) {
    S = lay.stages;
    if constexpr (kTensorCores<T>)
      if (lay.stage_bytes <= static_cast<int>(kTcChunkBytes))
        S += kTcStages - static_cast<int>(tc.head - tc.tail);
    s = 0;  // first[s] <= item < first[s + 1]
    for (int hi = p.B - 1; s < hi;) {
      const int mid = (s + hi + 1) / 2;
      if (as.first[mid] <= item) s = mid;
      else hi = mid - 1;
    }
    j = item - as.first[s];
    n_items = as.first[s + 1] - as.first[s];
    slot = ev * p.B + s;
    r0 = j * as.chunk;
    n = min(as.chunk, p.lengths[slot] - r0);  // 0: a slot of no rows
    n_tiles = (n + lay.rows - 1) / lay.rows;
    base = static_cast<size_t>(li * p.B + s) * p.pps * p.page_size;
    if (threadIdx.x == 0) {
      for (int i = 0; i < lay.stages; ++i)
        as.slot[i] = sm90::smem_u32(smem + lay.ring + i * lay.stage_bytes);
      if constexpr (kTensorCores<T>)
        for (int i = lay.stages; i < S; ++i)
          as.slot[i] = tc.ring + (tc.head + i - lay.stages) % kTcStages * kTcChunkBytes;
    }
    __syncwarp();
  }

  // sub-tile g: the k rows of tile g, then (g >= n_tiles) the v rows of tile
  // g - n_tiles, one copy (int8: and one of their scale rows) into ring slot
  // (seq + g) % S, completing on its mbarrier
  __device__ void issue(const StepParams<T, KV>& p, AttnShared& as, unsigned seq, int g) const {
    const int W = p.H * p.dh, R = lay.rows;
    const int t = g < n_tiles ? g : g - n_tiles;
    const int ns = min(R, n - t * R);
    const uint32_t bar = sm90::smem_u32(as.bars + (seq + g) % S);
    const uint32_t dst = as.slot[(seq + g) % S];
    const size_t row = base + r0 + t * R;
    sm90::mbar_expect_tx(bar, ns * (W * kElem + lay.scale_bytes));
    sm90::bulk_load(dst, (g < n_tiles ? p.k_pool : p.v_pool) + row * W, ns * W * kElem, bar);
    if constexpr (kQuant)
      sm90::bulk_load(dst + R * lay.row_bytes, p.scales + row * kScaleLanes,
                      ns * lay.scale_bytes, bar);
  }
};

// Work item `item` of layer li at event ev (see the top): the item's rows
// for every head and, in the slot's last item, the merge, the fresh row's
// own term, the output and the append.  Every thread of the block calls it.
// seq: the block's sub-tiles so far this event (tile seq + g sits in ring
// slot (seq + g) % S); tc: the staged segment's space and, on tensor cores,
// the product ring, whose free slots extend the phase's ring.
template <typename T, typename KV>
__device__ void attention_item(const StepParams<T, KV>& p, int ev, int li, int item,
                               AttnShared& as, unsigned& seq, const Tc<T>& tc) {
  constexpr bool kQuant = StepParams<T, KV>::kQuant;
  constexpr int CH = kAttnScoreStride;
  // the kernel's dynamic shared memory: pointers from it load with LDS
  extern __shared__ __align__(16) uint8_t attn_dynamic_smem[];
  uint8_t* smem = attn_dynamic_smem + (tc.act - attn_dynamic_smem);
  const AttnItem<T, KV> it(p, ev, li, item, as, tc, smem);
  const AttnLayout& lay = it.lay;
  const int H = p.H, dh = p.dh, W = H * dh, R = lay.rows, S = it.S;
  const int s = it.s, j = it.j, n_items = it.n_items, slot = it.slot, n = it.n;
  const int n_tiles = it.n_tiles;
  const size_t base = it.base;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  T* s_q = reinterpret_cast<T*>(smem + lay.q);
  T* s_k = reinterpret_cast<T*>(smem + lay.k);
  T* s_v = reinterpret_cast<T*>(smem + lay.v);
  float* s_sc = reinterpret_cast<float*>(smem + lay.sc);
  float* s_vs = reinterpret_cast<float*>(smem + lay.vs);
  float* s_lp = reinterpret_cast<float*>(smem + lay.lp);
  double* s_lg = reinterpret_cast<double*>(smem + lay.lg);
  double* s_tot = reinterpret_cast<double*>(smem + lay.tot);

  const uint32_t smem0 = sm90::smem_u32(attn_dynamic_smem);
  auto wait = [&](int g) {
    sm90::mbar_wait(sm90::smem_u32(as.bars + (seq + g) % S), (seq + g) / S & 1u);
    return attn_dynamic_smem + (as.slot[(seq + g) % S] - smem0);
  };
  // tiles [0, next) are issued, by the lanes of warp 0 side by side: two at
  // the start, then up to four after each consumed tile, at most S ahead
  const int n_all = 2 * n_tiles;
  int next = min(2, n_all);
  auto top_up = [&](int consumed) {
    const int to = min(next + 4, min(consumed + S, n_all));
    if (warp == 0 && lane < to - next) it.issue(p, as, seq, next + lane);
    next = max(next, to);
  };

  // the fresh row, per dims of a thread: q and k after RoPE (the plain
  // version's f32 math, rounded to T), qsb, v, and the self score's share
  const T* q = p.qkv + static_cast<size_t>(s) * 3 * W;
  const float* cs = p.cos + static_cast<size_t>(slot) * dh;
  const float* sn = p.sin + static_cast<size_t>(slot) * dh;
  const int per = W / kDecThreads, half = dh / 2;
  const int e0 = tid * per, d0 = e0 % dh;
  const int o0 = d0 < half ? e0 + half : e0 - half;  // the rotate-half partners
  const float sign = d0 < half ? -1.f : 1.f;
  if (warp == 0 && lane < next)  // more would hold the loads below back
    it.issue(p, as, seq, lane);
  // q, its partners, k, its partners, v; cos, sin: every load before the first store
  float x[5][kAttnMaxPer], cosv[kAttnMaxPer], sinv[kAttnMaxPer];
#pragma unroll
  for (int i = 0; i < kAttnMaxPer; i += 2) {
    if (i < per) {
      paged::load_n<2>(q + e0 + i, x[0] + i);
      paged::load_n<2>(q + o0 + i, x[1] + i);
      paged::load_n<2>(q + W + e0 + i, x[2] + i);
      paged::load_n<2>(q + W + o0 + i, x[3] + i);
      paged::load_n<2>(q + 2 * W + e0 + i, x[4] + i);
      paged::load_n<2>(cs + d0 + i, cosv + i);
      paged::load_n<2>(sn + d0 + i, sinv + i);
    }
  }
  float self = 0.f;
#pragma unroll
  for (int i = 0; i < kAttnMaxPer; ++i) {
    if (i < per) {
      const int e = e0 + i;
      const float qr = round_to<T>(
          __fadd_rn(__fmul_rn(x[0][i], cosv[i]), __fmul_rn(sign * x[1][i], sinv[i])));
      const float kr = round_to<T>(
          __fadd_rn(__fmul_rn(x[2][i], cosv[i]), __fmul_rn(sign * x[3][i], sinv[i])));
      const float qs32 = qr * p.scale;
      s_q[e] = from_f32<T>(qs32);
      s_k[e] = from_f32<T>(kr);
      s_v[e] = from_f32<T>(x[4][i]);
      self = fmaf(qs32, kr, self);
    }
  }
  s_lp[tid] = self;
  __syncthreads();
  if (tid < H) {  // the threads of head tid, in order
    float sum = 0.f;
    for (int k = 0; k < dh / per; ++k) sum += s_lp[tid * (dh / per) + k];
    as.self[tid] = sum;
  }

  // pass 1: (row r, head h) of each k sub-tile — int8 pools one thread, one
  // fma chain over the head dims in order; T pools two threads, each four
  // chains (the dims mod 4) over half of the head's pieces, their sums
  // added — kept with the running maximum
  const int split = !kQuant && R * H * 2 <= kDecThreads ? 2 : 1;
  const int pair = tid / split, part = tid % split;
  const int r = pair % R, h = pair / R;
  const bool paired = pair < R * H;
  float mx = -CUDART_INF_F;
  for (int t = 0; t < n_tiles; ++t) {
    const uint8_t* tile = wait(t);
    const bool live = paired && r < min(R, n - t * R);
    const KV* kr = reinterpret_cast<const KV*>(tile + r * lay.row_bytes) + h * dh;
    const T* qh = s_q + h * dh;
    float sc = 0.f;
    if constexpr (kQuant) {
      if (live) {
        for (int c0 = 0; c0 < dh; c0 += 64) {
          // the 64 dims' eight 8-byte pieces, read from piece r on (no two rows
          // of a bank group on one piece), then rotated back: raw[i] is piece i
          uint2 raw[8];
#pragma unroll
          for (int i = 0; i < 8; ++i)
            raw[i] = *reinterpret_cast<const uint2*>(kr + c0 + 8 * ((i + r) & 7));
#pragma unroll
          for (int b = 0; b < 3; ++b) {
            if ((r >> b) & 1) {
              uint2 was[8];
#pragma unroll
              for (int i = 0; i < 8; ++i) was[i] = raw[i];
#pragma unroll
              for (int i = 0; i < 8; ++i) raw[i] = was[(i - (1 << b)) & 7];
            }
          }
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            float qv[8];
            load8(qh + c0 + 8 * i, qv);
#pragma unroll
            for (int e = 0; e < 8; ++e) {
              const uint32_t word = e < 4 ? raw[i].x : raw[i].y;
              const float k8 =
                  static_cast<float>(static_cast<int>(word << (24 - 8 * (e & 3))) >> 24);
              sc = fmaf(qv[e], k8, sc);
            }
          }
        }
        const __nv_bfloat16* srow =
            reinterpret_cast<const __nv_bfloat16*>(tile + R * lay.row_bytes) + r * kScaleLanes;
        sc *= __bfloat162float(srow[h]);
        s_vs[h * CH + t * R + r] = __bfloat162float(srow[H + h]);
      }
    } else {
      if (live) {
        float acc[4] = {0.f, 0.f, 0.f, 0.f};
        const int pieces = 8 / split;  // this thread's pieces of each 64 dims
        for (int c0 = 0; c0 < dh; c0 += 64) {
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            if (i < pieces) {
              // from the row's own piece on (its index in the item, which
              // starts a group): the rows of a bank group read other pieces
              const int pc = c0 + 8 * ((part * pieces + i + t * R + r) & 7);
              float kv[8], qv[8];
              load8(kr + pc, kv);
              load8(qh + pc, qv);
#pragma unroll
              for (int e = 0; e < 8; ++e) acc[e & 3] = fmaf(qv[e], kv[e], acc[e & 3]);
            }
          }
        }
        sc = (acc[0] + acc[1]) + (acc[2] + acc[3]);
      }
      if (split == 2) {  // the pair's lanes add their halves in one order
        const float other = __shfl_xor_sync(0xffffffffu, sc, 1);
        sc = part ? other + sc : sc + other;
      }
    }
    if (live) {
      if (part == 0) s_sc[h * CH + t * R + r] = sc;
      mx = fmaxf(mx, sc);
    }
    __syncthreads();  // every thread is done with the ring slot
    top_up(t + 1);
  }
  for (int off = R * split / 2; off >= 1; off >>= 1)  // the lanes of head h
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
  if (paired && r == 0 && part == 0) as.m[h] = mx;  // -inf for an item of no rows
  __syncthreads();

  // a slot of several items: the maximum over all its items.  Each item
  // publishes its heads' maxima as 64-bit words, layer li + 1 over the
  // float's bits: a word read with this layer's flag holds its maximum
  const int step = kDecThreads / H;  // threads a head, below
  int* arrivals = reinterpret_cast<int*>(p.work);  // [B] tickets for the merge
  const int rec = attn_record_floats(H, dh);
  float* rec0 = p.work + attn_counter_floats(p.B) + static_cast<size_t>(as.first[s]) * rec;
  float* mine = rec0 + static_cast<size_t>(j) * rec;  // maxima [H] (64-bit), exp-sums, P.V
  if (n_items > 1) {
    const unsigned long long flag = static_cast<unsigned long long>(li + 1) << 32;
    if (tid < H)
      __stcg(reinterpret_cast<unsigned long long*>(mine) + tid,
             flag | __float_as_uint(as.m[tid]));
    float big = -CUDART_INF_F;
    const unsigned long long start = global_ns();
    for (int i = tid / H; i < n_items; i += step) {
      const unsigned long long* word =
          reinterpret_cast<const unsigned long long*>(rec0 + static_cast<size_t>(i) * rec) +
          tid % H;
      unsigned long long got = __ldcg(word);
      while ((got >> 32) != static_cast<unsigned long long>(li + 1)) {
        if (global_ns() - start > kAttnWaitNs) __trap();
        __nanosleep(32);
        got = __ldcg(word);
      }
      big = fmaxf(big, __uint_as_float(static_cast<unsigned>(got)));
    }
    s_lp[tid] = big;
    __syncthreads();
    if (tid < H) {
      for (int k = 1; k < step; ++k) big = fmaxf(big, s_lp[k * H + tid]);
      as.m[tid] = big;
    }
    __syncthreads();
  }

  // the weights exp(s - M) against the slot-head's maximum over all its
  // rows, rounded to T (int8: times the v scale, rounded to bf16), in the
  // scores' place; the exp-sum of each group of rows in row order, on the
  // grid: 8 lanes a (head, group), a row each
  const int n_groups = (n + kAttnGroup - 1) / kAttnGroup;
  for (int pg0 = 0; pg0 < H * n_groups; pg0 += kDecThreads / kAttnGroup) {
    const int pg = pg0 + tid / kAttnGroup, rg = tid % kAttnGroup;  // pg: group * H + head
    const int wh = pg % H, row = pg / H * kAttnGroup + rg;
    float pe = 0.f;
    if (pg < H * n_groups && row < n) {
      float* w = s_sc + wh * CH + row;
      pe = expf(*w - as.m[wh]);
      if constexpr (kQuant) *w = round_to<__nv_bfloat16>(pe * s_vs[wh * CH + row]);
      else *w = round_to<T>(pe);
    }
    float lsum = __shfl_sync(0xffffffffu, pe, lane & ~(kAttnGroup - 1));
#pragma unroll
    for (int k = 1; k < kAttnGroup; ++k)
      lsum += __shfl_sync(0xffffffffu, pe, (lane & ~(kAttnGroup - 1)) + k);
    if (rg == 0 && pg < H * n_groups) s_lg[pg] = attn_grid(lsum);
  }
  __syncthreads();
  if (tid < H) {
    double l = 0.0;
    for (int g = 0; g < n_groups; ++g) l += s_lg[g * H + tid];
    as.l[tid] = l;
  }

  // pass 2: P.V, thread tid the dims [e0, e0 + per) of head hh of every v
  // row in order, by groups of rows
  const int hh = e0 / dh;
  float group[kAttnMaxPer];
  double* acc = s_tot + e0;  // this thread's dims, its own
#pragma unroll
  for (int i = 0; i < kAttnMaxPer; ++i) {
    group[i] = 0.f;
    if (i < per) acc[i] = 0.0;
  }
  for (int t = 0; t < n_tiles; ++t) {
    const int g = n_tiles + t;
    const uint8_t* tile = wait(g);
    const int ns = min(R, n - t * R);
    const float* w = s_sc + hh * CH + t * R;
    if (per == 4) pv_rows<4, KV>(tile, lay.row_bytes, e0, t * R, ns, w, group, acc);
    else if (per == 2) pv_rows<2, KV>(tile, lay.row_bytes, e0, t * R, ns, w, group, acc);
    else pv_rows<8, KV>(tile, lay.row_bytes, e0, t * R, ns, w, group, acc);
    __syncthreads();  // every thread is done with the ring slot
    top_up(g + 1);
  }
  if (n % kAttnGroup != 0) {  // the slot's last group, short
#pragma unroll
    for (int i = 0; i < kAttnMaxPer; ++i)
      if (i < per) acc[i] += attn_grid(group[i]);
  }
  seq += 2 * n_tiles;

  // a slot of several items: its partial to scratch and a ticket; the last
  // merges the slot's partials in item order
  if (n_items > 1) {
    double* part_l = reinterpret_cast<double*>(mine) + H;
#pragma unroll
    for (int i = 0; i < kAttnMaxPer; i += 2)
      if (i < per)
        *reinterpret_cast<double2*>(part_l + H + e0 + i) = make_double2(acc[i], acc[i + 1]);
    if (tid < H) part_l[tid] = as.l[tid];
    __threadfence();
    __syncthreads();
    if (tid == 0) as.last = atomicAdd(arrivals + s, 1) == n_items - 1;
    __syncthreads();
    if (!as.last) return;
    __threadfence();  // the other items' partials are visible from here on
    // the items' sums, in item order (exact on the grid)
    const double* first_l = reinterpret_cast<const double*>(rec0) + H;
    const size_t pitch = rec / 2;  // doubles a record
#pragma unroll
    for (int i = 0; i < kAttnMaxPer; i += 2) {
      if (i < per) {
        const double* src = first_l + H + e0 + i;
        double2 sum = make_double2(0.0, 0.0);
        for (int k0 = 0; k0 < n_items; k0 += 4) {  // four loads in flight
          double2 v[4];
#pragma unroll
          for (int k = 0; k < 4; ++k)
            v[k] = k0 + k < n_items
                       ? __ldcg(reinterpret_cast<const double2*>(src + (k0 + k) * pitch))
                       : make_double2(0.0, 0.0);
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            sum.x += v[k].x;
            sum.y += v[k].y;
          }
        }
        acc[i] = sum.x;
        acc[i + 1] = sum.y;
      }
    }
    if (tid < H) {
      double l = 0.0;
      for (int k = 0; k < n_items; ++k) l += __ldcg(first_l + k * pitch + tid);
      as.l[tid] = l;
    }
  }
  __syncthreads();

  // the fresh row's own term merged in f32; the output; the append of the
  // fresh row — T pools: at wpos, after every read of the slot's rows (the
  // capacity clip); int8 pools (read only): layer li's rows of the outputs
  T* out = p.attn + static_cast<size_t>(s) * W;
  const size_t fresh = kQuant ? (static_cast<size_t>(li) * p.B + s) * W
                              : (base + p.wpos[slot]) * W;
  // -inf and 0 for a slot of no rows
  const float big = as.m[hh], total = static_cast<float>(as.l[hh] * 0x1p-32);
  const float m2 = fmaxf(big, as.self[hh]);
  const float wc = total * expf(big - m2);
  const float ws = expf(as.self[hh] - m2);
#pragma unroll
  for (int i = 0; i < kAttnMaxPer; ++i) {
    if (i < per) {
      const int e = e0 + i;
      const float o = total > 0.f ? static_cast<float>(acc[i] * 0x1p-32) / total : 0.f;
      out[e] = from_f32<T>((wc * o + ws * to_f32(s_v[e])) / (wc + ws));
      if constexpr (kQuant) {
        p.fresh_k[fresh + e] = s_k[e];
        p.fresh_v[fresh + e] = s_v[e];
      } else {
        p.k_pool[fresh + e] = s_k[e];
        p.v_pool[fresh + e] = s_v[e];
      }
    }
  }
  // later phases read the appended rows through the async proxy
  if constexpr (!kQuant) asm volatile("fence.proxy.async;\n" ::: "memory");
  __syncthreads();  // the block's next item stages over s_k and s_v
}

// The matrix phases of layer li.
template <typename T, typename KV>
__device__ Plan<T> step_qkv_plan(const StepParams<T, KV>& p, int li) {
  const int W = p.H * p.dh;
  return plan_of<T>(p.D, 3 * W, 1, p.ln + static_cast<size_t>(li) * 2 * p.D, p.eps,
                    Src<T>{p.wqkv + static_cast<size_t>(li) * 3 * W * p.D, &p.tm_qkv, li * 3 * W});
}

template <typename T, typename KV>
__device__ Plan<T> step_o_plan(const StepParams<T, KV>& p, int li) {
  const int W = p.H * p.dh;
  return plan_of<T>(W, p.D, 1, nullptr, 0.f,
                    Src<T>{p.wo + static_cast<size_t>(li) * p.D * W, &p.tm_o, li * p.D});
}

template <typename T, typename KV>
__device__ Plan<T> step_gu_plan(const StepParams<T, KV>& p, int li) {
  const size_t gate = static_cast<size_t>(li) * 2 * p.F;
  return plan_of<T>(p.D, p.F, 2, p.ln + (static_cast<size_t>(li) * 2 + 1) * p.D, p.eps,
                    Src<T>{p.wgu + gate * p.D, &p.tm_gu, li * 2 * p.F},
                    Src<T>{p.wgu + (gate + p.F) * p.D, &p.tm_gu, li * 2 * p.F + p.F});
}

template <typename T, typename KV>
__device__ Plan<T> step_down_plan(const StepParams<T, KV>& p, int li) {
  return plan_of<T>(p.F, p.D, 1, nullptr, 0.f,
                    Src<T>{p.wd + static_cast<size_t>(li) * p.D * p.F, &p.tm_d, li * p.D});
}

// All L layers of event ev (its row of the cos/sin/lengths/wpos tables).
// Every thread of every block calls it; it ends after the last layer's
// down phase, without a grid barrier, with `after` (the caller's next
// phase, or null) queued on the ring.
template <typename T, typename KV>
__device__ void fused_step_body(const StepParams<T, KV>& p, int ev, Tc<T>& tc, PhaseSync& sync,
                                float* rs, const Plan<T>* after) {
  const int B = p.B, D = p.D, W = p.H * p.dh, F = p.F;
  auto residual = [&](int col, int b, const float* v) {
    if (retired(p, b)) return;  // the residual stays frozen
    T* o = p.x + static_cast<size_t>(b) * D + col;
    *o = from_f32<T>(to_f32(*o) + round_to<T>(v[0]));
  };
  if (!tc.primed) tc_begin(tc, step_qkv_plan(p, 0), B);
  // the attention phases' items and ring
  __shared__ AttnShared attn;
  attention_plan(p, ev, attn);
  const int n_items = attn.first[B];
  unsigned seq = 0;  // the block's sub-tiles this event
  for (int li = 0; li < p.L; ++li) {
    // norm + q/k/v
    matmul<1>(
        tc, step_qkv_plan(p, li), B, p.x, rs,
        [&](int col, int b, const float* v) {
          p.qkv[static_cast<size_t>(b) * 3 * W + col] = from_f32<T>(v[0]);
        });
    tc_begin(tc, step_o_plan(p, li), B);
    if (blockIdx.x == 0)  // the attention phase's merge tickets start at zero
      for (int i = threadIdx.x; i < B; i += kDecThreads) reinterpret_cast<int*>(p.work)[i] = 0;
    sync.barrier();
    // items in order, item i on block i % gridDim: a slot's items run on
    // distinct blocks, each block's earlier items belong to earlier slots
    for (int item = blockIdx.x; item < n_items; item += gridDim.x)
      attention_item<T, KV>(p, ev, li, item, attn, seq, tc);
    sync.barrier();
    // o-proj + residual
    matmul<1>(tc, step_o_plan(p, li), B, p.attn, rs, residual);
    tc_begin(tc, step_gu_plan(p, li), B);
    sync.barrier();
    // norm + gate/up + SiLU
    matmul<2>(
        tc, step_gu_plan(p, li), B, p.x, rs,
        [&](int u, int b, const float* v) {
          const float g = round_to<T>(silu_f32(round_to<T>(v[0])));
          p.gated[static_cast<size_t>(b) * F + u] = from_f32<T>(g * round_to<T>(v[1]));
        });
    tc_begin(tc, step_down_plan(p, li), B);
    sync.barrier();
    // down + residual
    matmul<1>(tc, step_down_plan(p, li), B, p.gated, rs, residual);
    if (li + 1 < p.L) {
      tc_begin(tc, step_qkv_plan(p, li + 1), B);
      sync.barrier();
    } else if (after != nullptr) {
      tc_begin(tc, *after, B);
    }
  }
}

// Fill p from the packed host arrays and advance the cursors.  ptrs: the
// pointers of StepParams in declaration order up to `fresh_v` (alive is
// left null; scales and fresh_v are null for T pools), then the phase clock
// (or null), then the attention phase's scratch (attn_counter_floats(B) +
// items * attn_record_floats(H, dh) floats, items at most the larger of
// kAttnItems + B and B * ceil(capacity / kAttnChunkMax)); bf16: encodes the
// four tensor maps.  ints: B, D, H, dh,
// F, L, page_size, pages_per_slot; floats: eps, scale.  Returns false for
// shapes the kernel does not take.
template <typename T, typename KV>
bool fill_step_params(StepParams<T, KV>& p, const void* const*& ptrs, const int*& ints,
                      const float*& floats) {
  auto next = [&]() { return const_cast<void*>(*ptrs++); };
  for (const T** w : {&p.wqkv, &p.wo, &p.wgu, &p.wd, &p.ln}) *w = static_cast<const T*>(next());
  p.cos = static_cast<const float*>(next());
  p.sin = static_cast<const float*>(next());
  p.lengths = static_cast<const int*>(next());
  p.wpos = static_cast<const int*>(next());
  p.k_pool = static_cast<KV*>(next());
  p.v_pool = static_cast<KV*>(next());
  for (T** s : {&p.x, &p.qkv, &p.attn, &p.fresh_k, &p.gated}) *s = static_cast<T*>(next());
  p.bar = static_cast<unsigned int*>(next());
  p.scales = static_cast<const __nv_bfloat16*>(next());
  p.fresh_v = static_cast<T*>(next());
  p.clock = static_cast<unsigned long long*>(next());
  p.work = static_cast<float*>(next());
  p.alive = nullptr;
  for (int* f : {&p.B, &p.D, &p.H, &p.dh, &p.F, &p.L, &p.page_size, &p.pps}) *f = *ints++;
  p.eps = *floats++;
  p.scale = *floats++;
  constexpr bool kQuant = StepParams<T, KV>::kQuant;
  const bool quant_args = p.scales != nullptr && p.fresh_v != nullptr && 2 * p.H <= kScaleLanes;
  const int W = p.H * p.dh;
  const bool ok = p.dh <= kStepMaxHeadDim && p.dh % 64 == 0 && p.B <= kMaxBatch &&
                  (W == 512 || W == 1024 || W == 2048) && p.H <= kAttnMaxHeads &&
                  attn_layout(p.H, p.dh, sizeof(KV), sizeof(T), kQuant, attn_budget<T>())
                          .stages >= 2 &&
                  static_cast<long long>(p.page_size) * p.pps <=
                      static_cast<long long>(kAttnItems) * kAttnChunkMax &&
                  p.work != nullptr &&
                  (kQuant ? quant_args : p.scales == nullptr && p.fresh_v == nullptr);
  if (!ok) return false;
  if constexpr (kTensorCores<T>) {
    const long long L = p.L;
    return make_rows_map(&p.tm_qkv, p.wqkv, L * 3 * W, p.D) &&
           make_rows_map(&p.tm_o, p.wo, L * p.D, W) &&
           make_rows_map(&p.tm_gu, p.wgu, L * 2 * p.F, p.D) &&
           make_rows_map(&p.tm_d, p.wd, L * p.D, p.F);
  }
  return true;
}

}  // namespace mm
