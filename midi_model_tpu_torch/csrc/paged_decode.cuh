// The paged flash-decode routine that both paged kernels are built from:
// one block computes one work item — rows [r0, r0 + n) of one slot — for
// ALL query heads of the slot, and the slot's last block to finish merges
// the slot's items and appends its fresh row, in the same launch.
//
// What it computes (the plain version: midi_model_tpu_torch/ops/
// paged_allheads.py, decode_reference + kv_append): for each slot b and query
// head h, attention of the pre-scaled f32 query q[b, h, :] over the slot's
// first lengths[b] cached rows.  Pools are [n_pages, page_size, Hkv*stride]
// (bf16, f32 or int8), the layer axis folded into pages; row t of slot b is
// flat row base_pages[b] * page_size + t, kv head g = h / (H / Hkv) in lanes
// [g*stride, g*stride + D).  int8 pools carry a bf16 scale pool
// [n_pages, page_size, 128]: k scales in lanes [0:Hkv], v scales in
// [Hkv:2Hkv]; a cached value dequantizes as float(int8) * float(scale), an
// exact product (the plain version's value), before it enters the score or
// the P.V sum.  Outputs: o [B, H, D] f32 normalised and the flash stats
// m, l [B, H]; a slot of length 0 returns o = 0, m = -inf, l = 0.  With
// `append`, each slot's fresh packed row (and scale row) is written at
// (write_pages[b], write_offs[b]), IN PLACE.
//
// What bounds it on an H100: bytes.  Every live row is read once (2 * W *
// sizeof(T) bytes, plus the int8 scales) for ~2 flops per byte; the card
// needs tens of KB in flight on each of its 132 SMs to reach its 3.35 TB/s,
// and few enough instructions per byte that the SM keeps up with them.
//
// Design:
// - Rows in flight.  A slot's rows are contiguous in the pools, so a work
//   item's k rows and v rows are two contiguous spans.  They come into
//   shared memory as sub-tiles of Tile<T>::rows rows (~32 KB of k and v at
//   tv2o's widths) by bulk async copies (cp.async.bulk) completing on an
//   mbarrier, in a ring of kStages; warp 0 refills a ring slot as soon as
//   every warp is done with it.  int8 pools also bring each row's 2 * Hkv
//   scales (one 16-byte-rounded bulk copy per row, one lane each).  Two
//   blocks of 16 warps share an SM (kBlocksPerSm caps the registers at 64,
//   at the price of a few spilled bytes: measured faster on every shape the
//   router sends than 8 warps of two heads at three blocks an SM).
// - All heads per block.  Warp w takes query head w (and w + kWarps, ...); under
//   GQA every query head of a kv head reads the same staged rows, so k and v
//   leave device memory once.  The head dim is a template argument (16, 32,
//   64 or 128), so every loop over a sub-tile unrolls.  For each staged
//   sub-tile and head, with no shared-memory round trip and no warp
//   barrier: the scores in one pass (Lanes: each row on 32 / rows lanes,
//   each lane its 16-byte pieces of the row's head slice against q, a few
//   shuffles join a row's lanes); an online softmax in f32, row r's score
//   shuffled to lane r, whose running max moves only when a score passes it
//   (one vote per sub-tile; the exp-sum summed over the warp once, at the
//   end); then P.V, each lane D/32 consecutive dims of every row, loaded
//   with no branch so the loads overlap, the weights shuffled from the rows'
//   lanes.  Measured (PERF.md), a sub-tile's arithmetic and its copy take
//   comparable time at long lengths; at short ones the per-item latency
//   (prologue, first copy, merge) dominates.
// - Rows split over every SM.  The work item is a chunk of one slot's rows
//   (the cell kernel: a (slot, chunk) grid sized from the longest length;
//   the streaming kernel: a flat list over the live lengths, found in the
//   kernel).  A slot of length 0 is one item of no rows.
// - Merge and append in the launch.  A slot with one item finishes from
//   registers.  Otherwise each item writes its partial (unnormalised o, m, l)
//   to scratch and takes a ticket on the slot's arrival counter; the last
//   block merges the slot's partials IN ITEM ORDER (bit-reproducible from
//   run to run, unlike arrival order), normalises, resets the counter to 0
//   and only then appends: every other item of the slot has finished reading,
//   so the capacity clip (the append at capacity - 1 while lengths =
//   capacity) cannot overwrite a row still to be read.  The counters live in
//   one per-device buffer the wrapper allocates once and the kernels leave
//   at zero: calls must not run on two streams at once, which is how the
//   port calls them.
// - CUDA cores: one query row per head makes every product a GEMV.
#pragma once

#include <cstdint>

#include "common.cuh"
#include "hopper.cuh"

namespace mm {
namespace paged {

constexpr int kWarps = 16;
constexpr int kThreads = 32 * kWarps;
constexpr int kBlocksPerSm = 2;  // registers capped (64) so that two blocks fit an SM
constexpr int kStages = 2;
constexpr int kMaxHeadsPerWarp = 1;  // H <= kWarps
constexpr int kLane = 128;           // scale row width (bf16 lanes)
constexpr int kMergeBatch = 4;       // items whose partials the merge loads at once

// Rows of a staged sub-tile: ~32 KB of k and v at tv2o's 1,024-wide rows.
template <typename T> struct Tile { static constexpr int rows = 8; };
template <> struct Tile<float> { static constexpr int rows = 4; };

// How a warp's lanes cover a sub-tile, for head dim D: in the scores, kLpr
// lanes a row (so one pass covers the sub-tile), each kPpl 16-byte pieces
// of the row's head slice; in P.V, kDpl consecutive dims a lane.
template <typename T, int D>
struct Lanes {
  static constexpr int kRows = Tile<T>::rows;
  static constexpr int kEpc = 16 / sizeof(T);  // elements in a 16-byte piece
  static constexpr int kCpr = D / kEpc;        // pieces in a row's head slice
  static constexpr int kLpr = 32 / kRows;
  static constexpr int kPpl = kCpr > kLpr ? kCpr / kLpr : 1;
  static constexpr int kDpl = D >= 32 ? D / 32 : 1;
  static_assert(kCpr >= 1 && D % kEpc == 0 && kRows * kLpr == 32, "head dim");
};

template <typename T>
struct Args {
  const float* q;
  T *k_pool, *v_pool;
  __nv_bfloat16* scales;  // null unless int8
  const int *lengths, *base_pages;
  float *o, *m, *l;
  const T *new_k, *new_v;
  const __nv_bfloat16* new_scales;
  const int *write_pages, *write_offs;
  float* part;    // [items, H * (D + 2)]: unnormalised o [H, D], then m [H], l [H]
  int* arrivals;  // [B] tickets per slot, zero between calls
  int B, H, Hkv, groups, D, stride, W, page_size;
  int item_rows, append;
};

__host__ __device__ inline size_t round_up(size_t x, size_t to) { return (x + to - 1) / to * to; }

// bytes of one row's scales that a stage brings: k and v scales of every kv head
__host__ __device__ inline int scale_row_bytes(int Hkv) {
  return static_cast<int>(round_up(2 * Hkv * sizeof(__nv_bfloat16), 16));
}

// Shared memory of one block: the ring, then q [H, D] f32, the ring's
// mbarriers and the last-block flag.
struct Layout {
  size_t k, v, s, stage, q, bars, flag, total;
};

template <typename T>
__host__ __device__ inline Layout layout(int H, int D, int W, int Hkv, bool quantized) {
  Layout L;
  const int rows = Tile<T>::rows;
  const size_t tile = round_up(static_cast<size_t>(rows) * W * sizeof(T), 128);
  L.k = 0;
  L.v = tile;
  L.s = 2 * tile;
  L.stage = 2 * tile + (quantized ? round_up(rows * scale_row_bytes(Hkv), 128) : 0);
  L.q = kStages * L.stage;
  L.bars = L.q + round_up(static_cast<size_t>(H) * D * sizeof(float), 16);
  L.flag = L.bars + kStages * sizeof(uint64_t);
  L.total = L.flag + 16;
  return L;
}

// 16 bytes of T from shared memory as floats (16 / sizeof(T) of them)
__device__ __forceinline__ void load16(const float* p, float* out) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  out[0] = v.x, out[1] = v.y, out[2] = v.z, out[3] = v.w;
}

__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* out) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x, out[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void load16(const int8_t* p, float* out) {
  const int4 raw = *reinterpret_cast<const int4*>(p);
  const int8_t* b = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
  for (int i = 0; i < 16; ++i) out[i] = static_cast<float>(b[i]);
}

// N consecutive values of T (N * sizeof(T) bytes, aligned so) as floats
template <int N, typename T>
__device__ __forceinline__ void load_n(const T* p, float* out) {
  if constexpr (N * sizeof(T) >= 4 && N * sizeof(T) <= 16 && (N * sizeof(T)) % 4 == 0) {
    uint32_t w[N * sizeof(T) / 4];
    if constexpr (N * sizeof(T) == 16) {
      const uint4 r = *reinterpret_cast<const uint4*>(p);
      w[0] = r.x, w[1] = r.y, w[2] = r.z, w[3] = r.w;
    } else if constexpr (N * sizeof(T) == 8) {
      const uint2 r = *reinterpret_cast<const uint2*>(p);
      w[0] = r.x, w[1] = r.y;
    } else {
      w[0] = *reinterpret_cast<const uint32_t*>(p);
    }
    const T* v = reinterpret_cast<const T*>(w);
#pragma unroll
    for (int i = 0; i < N; ++i) out[i] = to_f32(v[i]);
  } else if constexpr (N * sizeof(T) == 2 && N == 2) {
    const uint16_t w = *reinterpret_cast<const uint16_t*>(p);
    const T* v = reinterpret_cast<const T*>(&w);
    out[0] = to_f32(v[0]), out[1] = to_f32(v[1]);
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) out[i] = to_f32(p[i]);
  }
}

// Warp 0: bring sub-tile `tile` of the item (rows first_row + tile *
// rows, ...) into ring slot `stage`, completing on `bar`.
template <typename T>
__device__ void issue_tile(const Args<T>& a, const Layout& L, char* smem, size_t first_row,
                           int n, int tile, int stage, uint32_t bar) {
  constexpr int kRows = Tile<T>::rows;
  const int lane = threadIdx.x & 31;
  const int r = tile * kRows;
  const int ns = min(kRows, n - r);
  const uint32_t bytes = static_cast<uint32_t>(ns) * a.W * sizeof(T);
  const int sb = scale_row_bytes(a.Hkv);
  char* base = smem + stage * L.stage;
  if (lane == 0) sm90::mbar_expect_tx(bar, 2 * bytes + (a.scales ? ns * sb : 0));
  __syncwarp();
  const size_t row = first_row + r;
  if (lane == 0) {
    sm90::bulk_load(sm90::smem_u32(base + L.k), a.k_pool + row * a.W, bytes, bar);
    sm90::bulk_load(sm90::smem_u32(base + L.v), a.v_pool + row * a.W, bytes, bar);
  }
  if (a.scales && lane < ns)
    sm90::bulk_load(sm90::smem_u32(base + L.s + lane * sb), a.scales + (row + lane) * kLane, sb,
                    bar);
}

// The fresh row of slot s (and its scale row) at (write_pages[s], write_offs[s]).
template <typename T>
__device__ void append_row(const Args<T>& a, int s) {
  const size_t dst = static_cast<size_t>(a.write_pages[s]) * a.page_size + a.write_offs[s];
  for (int i = threadIdx.x; i < a.W; i += kThreads) {
    a.k_pool[dst * a.W + i] = a.new_k[static_cast<size_t>(s) * a.W + i];
    a.v_pool[dst * a.W + i] = a.new_v[static_cast<size_t>(s) * a.W + i];
  }
  if (a.scales)
    for (int i = threadIdx.x; i < kLane; i += kThreads)
      a.scales[dst * kLane + i] = a.new_scales[static_cast<size_t>(s) * kLane + i];
}

// Work item j of slot s, rows [r0, r0 + n) (n_items items; `item` its
// scratch row, item j - i scratch row item - i): the partial flash state of
// every head over the item's rows, then, in the slot's last block, the
// merge and the append.
template <typename T, int D>
__device__ void decode_item(const Args<T>& a, int s, int r0, int n, int j, int n_items,
                            int item) {
  extern __shared__ __align__(128) char smem[];
  using LN = Lanes<T, D>;
  constexpr int kRows = LN::kRows, kEpc = LN::kEpc, kCpr = LN::kCpr, kLpr = LN::kLpr;
  constexpr int kPpl = LN::kPpl, kDpl = LN::kDpl;
  constexpr bool kInt8 = sizeof(T) == 1;
  constexpr float kLog2e = 1.4426950408889634f;
  const Layout L = layout<T>(a.H, D, a.W, a.Hkv, a.scales != nullptr);
  float* sq = reinterpret_cast<float*>(smem + L.q);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const uint32_t bars = sm90::smem_u32(smem + L.bars);
  int* flag = reinterpret_cast<int*>(smem + L.flag);

  const size_t first_row = static_cast<size_t>(a.base_pages[s]) * a.page_size + r0;
  const int n_tiles = (n + kRows - 1) / kRows;
  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) sm90::mbar_init(bars + 8 * i, 1);
    sm90::fence_barrier_init();
  }
  __syncthreads();
  if (warp == 0)
    for (int t = 0; t < min(kStages, n_tiles); ++t)
      issue_tile(a, L, smem, first_row, n, t, t, bars + 8 * t);
  for (int i = threadIdx.x; i < a.H * D; i += kThreads)
    sq[i] = a.q[static_cast<size_t>(s) * a.H * D + i];
  __syncthreads();

  const int row = lane / kLpr;                // this lane's row in the scores
  const int piece0 = (lane % kLpr) * kPpl;    // its first piece of the row
  const int d0 = lane * kDpl;                 // its first dim in P.V
  const int sb = scale_row_bytes(a.Hkv) / 2;  // bf16 lanes per staged scale row

  // per head of the warp: the running max m (uniform over the warp), this
  // lane's share of the exp-sum l (its rows' weights) and its dims of P.V
  float acc[kMaxHeadsPerWarp][kDpl];
  float m[kMaxHeadsPerWarp], l[kMaxHeadsPerWarp];
#pragma unroll
  for (int jh = 0; jh < kMaxHeadsPerWarp; ++jh) {
    m[jh] = -CUDART_INF_F;
    l[jh] = 0.f;
#pragma unroll
    for (int i = 0; i < kDpl; ++i) acc[jh][i] = 0.f;
  }

  for (int t = 0; t < n_tiles; ++t) {
    const int stage = t % kStages;
    sm90::mbar_wait(bars + 8 * stage, (t / kStages) & 1);
    const int ns = min(kRows, n - t * kRows);
    const T* ks = reinterpret_cast<const T*>(smem + stage * L.stage + L.k);
    const T* vs = reinterpret_cast<const T*>(smem + stage * L.stage + L.v);
    const __nv_bfloat16* ss =
        reinterpret_cast<const __nv_bfloat16*>(smem + stage * L.stage + L.s);
#pragma unroll
    for (int jh = 0; jh < kMaxHeadsPerWarp; ++jh) {
      const int h = warp + kWarps * jh;
      if (h >= a.H) continue;  // uniform over the warp
      const int kv = h / a.groups;
      // scores: one pass, lane (row, piece0) takes pieces piece0 .. + kPpl of
      // its row; the row's kLpr lanes join their sums by shuffles
      float dot = 0.f;
      if (row < ns) {
        const float scale = kInt8 ? to_f32(ss[row * sb + kv]) : 1.f;
#pragma unroll
        for (int pp = 0; pp < kPpl; ++pp) {
          const int c = piece0 + pp;
          if (c < kCpr) {
            float x[kEpc];
            load16(ks + row * a.W + kv * a.stride + c * kEpc, x);
            float part = 0.f;
#pragma unroll
            for (int e = 0; e < kEpc; e += 4) {
              const float4 q4 = *reinterpret_cast<const float4*>(sq + h * D + c * kEpc + e);
              const float qe[4] = {q4.x, q4.y, q4.z, q4.w};
#pragma unroll
              for (int k = 0; k < 4; ++k)
                part = fmaf(qe[k], kInt8 ? x[e + k] * scale : x[e + k], part);
            }
            dot += part;
          }
        }
      }
#pragma unroll
      for (int off = kLpr / 2; off > 0; off >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, off);
      // online softmax in f32, row r's score in lane r; the max moves (and
      // the state is rescaled) only when a score passes it: one vote
      const float score = __shfl_sync(0xffffffffu, dot, (lane * kLpr) & 31);
      const float sc = lane < ns ? score : -CUDART_INF_F;
      if (__any_sync(0xffffffffu, sc > m[jh])) {
        float big = sc;
#pragma unroll
        for (int off = kRows / 2; off > 0; off >>= 1)
          big = fmaxf(big, __shfl_xor_sync(0xffffffffu, big, off));
        const float m_new = fmaxf(m[jh], __shfl_sync(0xffffffffu, big, 0));
        const float corr = exp2f((m[jh] - m_new) * kLog2e);  // the first: exp(-inf) = 0
        l[jh] *= corr;
#pragma unroll
        for (int i = 0; i < kDpl; ++i) acc[jh][i] *= corr;
        m[jh] = m_new;
      }
      const float p = lane < ns ? exp2f((sc - m[jh]) * kLog2e) : 0.f;
      l[jh] += p;  // this lane's share, summed over the warp after the last sub-tile
      // P.V: lane owns dims d0 .. d0 + kDpl.  Every row of the sub-tile is
      // loaded with no branch, so the loads overlap; a row past ns (stale
      // shared memory, perhaps not even a number) is kept out by a select
      float pr[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) pr[r] = __shfl_sync(0xffffffffu, p, r);
      if (d0 < D) {
        float x[kRows][kDpl];
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          load_n<kDpl>(vs + r * a.W + kv * a.stride + d0, x[r]);
          if (kInt8) {
            const float scale = to_f32(ss[r * sb + a.Hkv + kv]);
#pragma unroll
            for (int i = 0; i < kDpl; ++i) x[r][i] *= scale;
          }
        }
#pragma unroll
        for (int r = 0; r < kRows; ++r)
#pragma unroll
          for (int i = 0; i < kDpl; ++i)
            acc[jh][i] = r < ns ? fmaf(pr[r], x[r][i], acc[jh][i]) : acc[jh][i];
      }
    }
    __syncthreads();  // every warp is done with this ring slot
    if (warp == 0 && t + kStages < n_tiles)
      issue_tile(a, L, smem, first_row, n, t + kStages, stage, bars + 8 * stage);
  }
#pragma unroll
  for (int jh = 0; jh < kMaxHeadsPerWarp; ++jh) l[jh] = warp_sum(l[jh]);

  const int HD = a.H * D;
  if (n_items == 1) {  // the slot's only item: normalise from registers
#pragma unroll
    for (int jh = 0; jh < kMaxHeadsPerWarp; ++jh) {
      const int h = warp + kWarps * jh;
      if (h >= a.H) continue;
      float* out = a.o + static_cast<size_t>(s) * HD + h * D;
#pragma unroll
      for (int i = 0; i < kDpl; ++i)
        if (d0 + i < D) out[d0 + i] = l[jh] > 0.f ? acc[jh][i] / l[jh] : 0.f;
      if (lane == 0) {
        a.m[static_cast<size_t>(s) * a.H + h] = m[jh];
        a.l[static_cast<size_t>(s) * a.H + h] = l[jh];
      }
    }
    if (a.append) append_row(a, s);
    return;
  }

  // several items: the partial to scratch, then a ticket on the slot's counter
  const size_t pitch = static_cast<size_t>(a.H) * (D + 2);
  float* mine = a.part + item * pitch;
#pragma unroll
  for (int jh = 0; jh < kMaxHeadsPerWarp; ++jh) {
    const int h = warp + kWarps * jh;
    if (h >= a.H) continue;
#pragma unroll
    for (int i = 0; i < kDpl; ++i)
      if (d0 + i < D) mine[h * D + d0 + i] = acc[jh][i];
    if (lane == 0) {
      mine[HD + h] = m[jh];
      mine[HD + a.H + h] = l[jh];
    }
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    const int ticket = atomicAdd(a.arrivals + s, 1);
    *flag = ticket == n_items - 1;
    if (*flag) a.arrivals[s] = 0;  // ready for the next call
  }
  __syncthreads();
  if (!*flag) return;
  __threadfence();  // the other items' partials are visible from here on

  // the last block: merge the slot's items in item order (every item of a
  // slot with several holds >= 1 row, so each m is finite).  Warp w takes
  // its heads; lane i weighs items i, i + 32, ...; each lane sums its dims
  // over the items in order, loading kMergeBatch items' partials at once
  const float* first = a.part + (item - j) * pitch;
#pragma unroll
  for (int jh = 0; jh < kMaxHeadsPerWarp; ++jh) {
    const int h = warp + kWarps * jh;
    if (h >= a.H) continue;  // uniform over the warp
    float big = -CUDART_INF_F;
    for (int i = lane; i < n_items; i += 32) big = fmaxf(big, __ldcg(first + i * pitch + HD + h));
    big = warp_max(big);
    float total = 0.f, sum[kDpl] = {};
    for (int c0 = 0; c0 < n_items; c0 += 32) {
      float w = 0.f;
      if (c0 + lane < n_items) {
        const float* pi = first + (c0 + lane) * pitch;
        w = expf(__ldcg(pi + HD + h) - big);
        total = fmaf(__ldcg(pi + HD + a.H + h), w, total);
      }
      for (int k0 = 0; k0 < min(32, n_items - c0); k0 += kMergeBatch) {
        float ov[kMergeBatch][kDpl];
#pragma unroll
        for (int k = 0; k < kMergeBatch; ++k) {
          const float* o_k = first + (c0 + k0 + k) * pitch + h * D + d0;
#pragma unroll
          for (int i = 0; i < kDpl; ++i)
            ov[k][i] = c0 + k0 + k < n_items && d0 + i < D ? __ldcg(o_k + i) : 0.f;
        }
#pragma unroll
        for (int k = 0; k < kMergeBatch; ++k) {
          const float wk = __shfl_sync(0xffffffffu, w, (k0 + k) & 31);
#pragma unroll
          for (int i = 0; i < kDpl; ++i) sum[i] = fmaf(ov[k][i], wk, sum[i]);
        }
      }
    }
    total = warp_sum(total);
    float* out = a.o + static_cast<size_t>(s) * HD + h * D;
#pragma unroll
    for (int i = 0; i < kDpl; ++i)
      if (d0 + i < D) out[d0 + i] = total > 0.f ? sum[i] / total : 0.f;
    if (lane == 0) {
      a.m[static_cast<size_t>(s) * a.H + h] = big;
      a.l[static_cast<size_t>(s) * a.H + h] = total;
    }
  }
  if (a.append) append_row(a, s);
}

// Check a call's geometry against what the routine takes; 0 if it fits.
template <typename T>
inline int check_args(const Args<T>& a) {
  const bool fits = a.H <= kWarps * kMaxHeadsPerWarp && a.Hkv >= 1 && a.H % a.Hkv == 0 &&
                    (a.stride * sizeof(T)) % 16 == 0 && a.item_rows >= 1 &&
                    (a.scales == nullptr || 2 * a.Hkv <= kLane);
  return fits ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// Launch `kernel` on `grid` blocks with the routine's shared memory.
template <typename T, typename Kernel>
int launch(Kernel kernel, const Args<T>& a, dim3 grid, void* stream) {
  if (int err = check_args(a)) return err;
  const size_t smem = layout<T>(a.H, a.D, a.W, a.Hkv, a.scales != nullptr).total;
  const cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  if (grid.x > 0 && grid.y > 0)
    kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return last_error();
}

// Launch kernel<T, D> for the call's head dim D (16, 32, 64 or 128).
#define MM_PAGED_DISPATCH(KERNEL, T, A, GRID, STREAM)                       \
  switch ((A).D) {                                                          \
    case 16: return mm::paged::launch(KERNEL<T, 16>, A, GRID, STREAM);      \
    case 32: return mm::paged::launch(KERNEL<T, 32>, A, GRID, STREAM);      \
    case 64: return mm::paged::launch(KERNEL<T, 64>, A, GRID, STREAM);      \
    case 128: return mm::paged::launch(KERNEL<T, 128>, A, GRID, STREAM);    \
    default: return static_cast<int>(cudaErrorInvalidValue);                \
  }

}  // namespace paged
}  // namespace mm
