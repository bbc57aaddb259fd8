// Building blocks of the whole-step decode kernels (token_loop.cu,
// fused_step.cu and event_loop.cu, through token_row.cuh and
// fused_step.cuh): phases of one cooperative grid, separated by
// mm::grid_barrier (PhaseSync, with the optional phase clock).
//
// A matrix phase computes out[b, n] = sum_k act[b, k] * W[n, k] for a
// handful of activation rows (the batch) against weights in torch's
// [out, in] layout.  Decode has few rows and large weights, so bytes bound
// it; what a phase has to hide is latency.  Two forms:
//
// * bf16 (tc_phase): tensor cores.  The weight is mma.sync's M side
//   (m16n8k16: 16 weight rows x 16 k), the batch rows its N side (padded
//   to 8, 32 rows a pass), f32 accumulators.  A phase's output columns are
//   cut into items of 16 columns (two 16-row m-tiles for gate/up, whose
//   epilogue needs both) over the whole of K; item i belongs to block
//   i % gridDim.  An item streams as chunks of 16 rows x 512 k (16 KB: 8
//   TMA boxes of 16 x 64, 128-byte swizzled, from a 2-d tensor map over
//   each weight) through an 8-slot ring in shared memory; warp w takes box
//   w of every chunk, so it sums k = 64w .. 64w+63 of each 512 in order.
//   The eight warps' partial sums then reduce in shared memory in warp
//   order: every output's bits depend on the shapes only, never on
//   gridDim (the event loop and the per-event kernels get different block
//   counts and must agree bit for bit).  No weight depends on the previous
//   phase, so each block issues its first chunks of the NEXT phase
//   (tc_begin) before it arrives at the grid barrier: HBM streams while the
//   grid synchronises.  The activation segment (32 rows x 1024 k, normed
//   where the phase starts with an RMSNorm) is staged once per cluster of
//   kDecCluster blocks per pass: each block loads and norms 32 / kDecCluster
//   of the rows and writes them into every block's segment (distributed
//   shared memory), with a 16-byte XOR swizzle so ldmatrix reads are
//   conflict-free.  Every staged value is the same whatever the cluster.
// * f32 (gemv2): CUDA cores, unchanged from the first version (tensor cores
//   would mean TF32 and break the f32 checks).  Every warp of the grid takes
//   a unit of two output columns, streams their two weight rows once
//   (16-byte loads), and multiplies them against all rows of the
//   activation tile staged in shared memory, keeping 2 x kRowTile f32 sums
//   in registers.
//
// Both: f32 accumulation, one rounding of the sum by the caller's epilogue
// (the plain versions' "matmul output in the weight dtype" rule).
#pragma once

#include <type_traits>

#include "common.cuh"
#include "hopper.cuh"

namespace mm {

constexpr int kDecThreads = 256;
constexpr int kDecWarps = kDecThreads / 32;
constexpr int kRowTile = 32;   // activation rows per register tile
constexpr int kMaxBatch = 256; // rows the per-block norm scales can hold
constexpr size_t kGemvSmem = 64 * 1024;  // the staged activation tile

// Vec<T>::n: elements in one 16-byte load; chunk: K elements staged at once
// (activations are staged in T: every staged value is a T value).
template <typename T> struct Vec;
template <> struct Vec<float> {
  static constexpr int n = 4;
  static constexpr int chunk = 512;
};

// Weight vectors (read-only for the whole kernel: the read-only path).
__device__ __forceinline__ void load_vec(const float* p, float* out) {
  const float4 v = __ldg(reinterpret_cast<const float4*>(p));
  out[0] = v.x;
  out[1] = v.y;
  out[2] = v.z;
  out[3] = v.w;
}

// Round through T and back: the value a T tensor would hold.
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

// Eight consecutive elements of T (16-byte aligned for bf16, 32 for f32) as
// floats.  A plain load: activations are written by this kernel, so they
// must not go through the read-only (non-coherent) path.
__device__ __forceinline__ void load8(const float* p, float* out) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  out[0] = a.x, out[1] = a.y, out[2] = a.z, out[3] = a.w;
  out[4] = b.x, out[5] = b.y, out[6] = b.z, out[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* out) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

// Eight int8 pool values (8-byte aligned) as floats, each exact.
__device__ __forceinline__ void load8(const signed char* p, float* out) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const signed char* c = reinterpret_cast<const signed char*>(&raw);
#pragma unroll
  for (int i = 0; i < 8; ++i) out[i] = static_cast<float>(c[i]);
}

// The staged tile: 8 values of T at p, from or to floats.
__device__ __forceinline__ void store8(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  *reinterpret_cast<float4*>(p + 4) = make_float4(v[4], v[5], v[6], v[7]);
}

__device__ __forceinline__ void store8(__nv_bfloat16* p, const float* v) {
  uint4 raw;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = raw;
}

// Vec<T>::n staged values at p as floats (one 16-byte shared-memory load).
__device__ __forceinline__ void load_staged(const float* p, float* out) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  out[0] = x.x, out[1] = x.y, out[2] = x.z, out[3] = x.w;
}

// For every unit u < n_units (spread over all warps of the grid) and row
// b < rows: acc_c = sum_k act(b, k) * row(u, c)[k] for c = 0, 1, then
// epi(u, b, acc0, acc1), row b on lane b of the unit's warp.  row(u, c) ==
// nullptr is a column that does not exist (its sum is 0).  load(b, k, out)
// writes act(b, k .. k+7), values of T.  K % 8 == 0 and 16-byte aligned
// rows (the wrappers check).  Every thread of every block calls it (it
// holds block barriers); smem is kGemvSmem of shared memory.
//
// Latency, not bandwidth, is what a decode-sized product has to hide: the
// staging issues its 16-byte loads four at a time before storing any, and
// each lane reads 16 contiguous bytes of the staged tile (no bank
// conflicts).  The loops over groups and k stay loops: the kernels hold one
// copy of this body per phase, and unrolled copies overflow the instruction
// cache.
template <typename T, class RowFn, class LoadFn, class EpiFn>
__device__ void gemv2(int rows, int K, int n_units, RowFn row, LoadFn load, EpiFn epi,
                      void* smem) {
  constexpr int V = Vec<T>::n;
  constexpr int kChunk = Vec<T>::chunk;
  constexpr int kStage = kRowTile * kChunk / 8 / kDecThreads;  // 8-vectors per thread
  static_assert(kStage % 4 == 0, "staging runs in groups of four loads");
  static_assert(sizeof(T) * kRowTile * kChunk <= kGemvSmem, "staged tile too large");
  T* xs = static_cast<T*>(smem);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int grid_warps = gridDim.x * kDecWarps;
  const int block_first = blockIdx.x * kDecWarps;
  for (int r0 = 0; r0 < rows; r0 += kRowTile) {
    const int rt = min(kRowTile, rows - r0);
    for (int u0 = 0; u0 + block_first < n_units; u0 += grid_warps) {  // block-uniform
      const int u = u0 + block_first + warp;
      const bool live = u < n_units;
      const T* w0 = live ? row(u, 0) : nullptr;
      const T* w1 = live ? row(u, 1) : nullptr;
      float acc0[kRowTile], acc1[kRowTile];
#pragma unroll
      for (int b = 0; b < kRowTile; ++b) acc0[b] = acc1[b] = 0.f;
      for (int k0 = 0; k0 < K; k0 += kChunk) {
        const int kv = min(kChunk, K - k0) / 8;  // 8-vectors per row in this chunk
        __syncthreads();  // the previous chunk is consumed
#pragma unroll 1
        for (int g = 0; g < kStage; g += 4) {
          float v[4][8];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int e = (g + i) * kDecThreads + threadIdx.x;
            if (e < rt * kv) load(r0 + e / kv, k0 + (e % kv) * 8, v[i]);
          }
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int e = (g + i) * kDecThreads + threadIdx.x;
            if (e < rt * kv) store8(xs + (e / kv) * kChunk + (e % kv) * 8, v[i]);
          }
        }
        __syncthreads();
        if (!live) continue;
        const int kc = kv * 8;
        // a loop, not unrolled: the body (all rows of the tile) is already
        // long, and the instruction cache has to hold every phase's copy
#pragma unroll 1
        for (int k = lane * V; k < kc; k += 32 * V) {
          float a[V] = {}, c[V] = {};
          if (w0) load_vec(w0 + k0 + k, a);
          if (w1) load_vec(w1 + k0 + k, c);
#pragma unroll
          for (int b = 0; b < kRowTile; ++b) {
            if (b < rt) {
              float x[V];
              load_staged(xs + b * kChunk + k, x);
#pragma unroll
              for (int i = 0; i < V; ++i) {
                acc0[b] += x[i] * a[i];
                acc1[b] += x[i] * c[i];
              }
            }
          }
        }
      }
      if (live) {
        // lane b keeps row b's sums, so the epilogues run side by side
        float mine0 = 0.f, mine1 = 0.f;
#pragma unroll
        for (int b = 0; b < kRowTile; ++b) {
          const float s0 = warp_sum(acc0[b]);
          const float s1 = warp_sum(acc1[b]);
          if (lane == b) {
            mine0 = s0;
            mine1 = s1;
          }
        }
        if (lane < rt) epi(u, r0 + lane, mine0, mine1);
      }
    }
  }
}

// rs[b] = rsqrt(mean(x[b]^2) + eps) for the rows of x [rows, D] (one warp per
// row, 16-byte loads); the caller's next block barrier publishes it.  With
// ranks > 1, only the rows block `rank` of a cluster stages (stage_segment):
// rows rank * 32 / ranks .. of each pass of 32.
template <typename T>
__device__ void row_scales(const T* __restrict__ x, int rows, int D, float eps, float* rs,
                           int rank = 0, int ranks = 1) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int per = kRowTile / ranks;
  for (int i = warp;; i += kDecWarps) {
    const int b = i / per * kRowTile + rank * per + i % per;
    if (b >= rows) break;
    const T* xr = x + static_cast<size_t>(b) * D;
    float s = 0.f;
#pragma unroll 4
    for (int k = lane * 8; k < D; k += 256) {
      float v[8];
      load8(xr + k, v);
#pragma unroll
      for (int i = 0; i < 8; ++i) s += v[i] * v[i];
    }
    s = warp_sum(s);
    if (lane == 0) rs[b] = rsqrtf(s / static_cast<float>(D) + eps);
  }
}

// RMSNorm of act(b, k .. k+7) with the plain version's rounding points:
// T(x * rs), then the weight multiply in T.
template <typename T>
__device__ __forceinline__ void norm8(const T* x, const T* w, const float* rs, int D, int b,
                                      int k, float* out) {
  float xv[8], wv[8];
  load8(x + static_cast<size_t>(b) * D + k, xv);
  load8(w + k, wv);
#pragma unroll
  for (int i = 0; i < 8; ++i) out[i] = round_to<T>(wv[i] * round_to<T>(xv[i] * rs[b]));
}

__device__ __forceinline__ float silu_f32(float g) { return g / (1.f + expf(-g)); }

// ---- the phase clock ----------------------------------------------------------

// Grid barriers of one launch, counted.  With a clock buffer ([2 n + 2]
// u64, zeroed), entry 2i is when phase i started (block 0 leaves the
// barrier before it, or enters the kernel for i = 0) and entry 2i + 1 the
// last block's arrival at the barrier that ends it (or at the end of the
// body, for the last phase): the phase's work is the difference, the
// barrier's wait the gap to entry 2i + 2.  %globaltimer, in ns.
struct PhaseSync {
  unsigned int* bar;
  unsigned long long* clock;
  int tick;

  __device__ void start() {
    tick = 0;
    if (clock != nullptr && blockIdx.x == 0 && threadIdx.x == 0) clock[0] = global_ns();
  }
  __device__ void barrier() {
    grid_barrier(bar, clock != nullptr ? clock + 2 * tick + 1 : nullptr);
    ++tick;
    if (clock != nullptr && blockIdx.x == 0 && threadIdx.x == 0) clock[2 * tick] = global_ns();
  }
  // the end of the last phase (no barrier follows)
  __device__ void end() {
    if (clock == nullptr) return;
    __syncthreads();
    if (threadIdx.x == 0) atomicMax(clock + 2 * tick + 1, global_ns());
  }
};

// ---- matrix phases -------------------------------------------------------------

template <typename T>
constexpr bool kTensorCores = std::is_same<T, __nv_bfloat16>::value;

constexpr int kTcRows = 32;                      // activation rows a pass (N)
static_assert(kTcRows == kRowTile, "row_scales splits passes of kRowTile rows");
constexpr int kTcNTiles = kTcRows / 8;           // mma n-tiles a pass
constexpr int kTcBoxK = 64;                      // k of a TMA box: one 128-byte swizzle row
constexpr int kTcBoxRows = 16;                   // weight rows of a box: one m-tile
constexpr int kTcChunkK = kTcBoxK * kDecWarps;   // k of a chunk: one box a warp
constexpr uint32_t kTcBoxBytes = kTcBoxRows * kTcBoxK * 2;
constexpr uint32_t kTcChunkBytes = kTcBoxBytes * kDecWarps;  // one ring slot
constexpr int kTcStages = 8;                     // ring slots
constexpr int kTcSegK = 1024;                    // k of a staged activation segment
constexpr int kTcMaxMT = 2;                      // m-tiles an item (gate and up)
// Blocks a cluster of the bf16 decode launches, which stage each activation
// segment together (stage_segment): at most 4, so every warp of a block
// norms whole rows.  Where the card cannot hold a cooperative grid of such
// clusters (or refuses the launch) they run in clusters of 1.
constexpr int kDecCluster = 2;
constexpr int kTcMaxCluster = 4;
static_assert(kDecCluster >= 1 && kDecCluster <= kTcMaxCluster && kTcRows % kDecCluster == 0,
              "a cluster's blocks stage whole rows");
constexpr size_t kTcRingBytes = static_cast<size_t>(kTcChunkBytes) * kTcStages;
constexpr size_t kTcActBytes = static_cast<size_t>(kTcRows) * kTcSegK * 2;
constexpr size_t kTcRedBytes = static_cast<size_t>(kDecWarps) * kTcBoxRows * kTcRows * 4;
constexpr size_t kTcResBytes = static_cast<size_t>(kTcMaxMT) * kTcBoxRows * kTcRows * 4;
constexpr size_t kTcNormBytes = static_cast<size_t>(kTcSegK) * 2;  // a norm weight
// + 1024: the swizzle wants 1024-byte aligned slots; the ring's mbarriers and the norm's
constexpr size_t kTcSmem = 1024 + kTcRingBytes + kTcActBytes + kTcRedBytes + kTcResBytes +
                           kTcNormBytes + 8 * (kTcStages + 1);
static_assert(kTcActBytes >= kGemvSmem, "the staged segment doubles as the phases' scratch");
static_assert(kTcSegK % kTcChunkK == 0, "a chunk lies in one staged segment");
static_assert(kTcRedBytes >= kTcActBytes / 16 * 4, "a staged 8-vector's sum of squares fits");
static_assert(kTcRows % kDecWarps == 0 && kTcRows / kDecWarps <= 32, "rows a warp norms");

// Dynamic shared memory of a decode kernel over weights of type T.
template <typename T>
constexpr size_t decode_smem() {
  return kTensorCores<T> ? kTcSmem : kGemvSmem;
}

// Blocks a cluster of a decode kernel over weights of type T (the f32
// forms stage nothing to share).
template <typename T>
constexpr int decode_cluster() {
  return kTensorCores<T> ? kDecCluster : 1;
}

// Rows [row0, row0 + n) of a weight [rows, K]: a pointer at row0 (CUDA
// cores) and a tensor map over the whole weight (tensor cores).
template <typename T>
struct Src {
  const T* ptr;
  const CUtensorMap* map;
  int row0;
};

// One matrix phase's weights.  MT == 1: the output columns are the rows
// of up to three segments of seg_rows rows each (q | k | v), concatenated.
// MT == 2: column u pairs row u of seg[0] with row u of pair (gate, up).
// With norm, the phase starts with an RMSNorm of its activations x [B, K]:
// T(norm * T(x * rs)), rs = rsqrt(mean(x^2) + eps).
template <typename T>
struct Plan {
  Src<T> seg[3];
  Src<T> pair;
  const T* norm;
  float eps;
  int seg_rows, n_cols, K, mt;
};

template <typename T>
__device__ __forceinline__ Plan<T> plan_of(int K, int n_cols, int mt, const T* norm, float eps,
                                           Src<T> a, Src<T> b = {}, Src<T> c = {},
                                           int seg_rows = 0) {
  Plan<T> p;
  p.norm = norm;
  p.eps = eps;
  p.seg[0] = a;
  p.seg[1] = mt == 1 ? b : Src<T>{};
  p.seg[2] = c;
  p.pair = mt == 2 ? b : Src<T>{};
  p.seg_rows = seg_rows > 0 ? seg_rows : n_cols;
  p.n_cols = n_cols;
  p.K = K;
  p.mt = mt;
  return p;
}

// Block `block`'s items of a phase with n_items items (item i: block i %
// grid).
__device__ __forceinline__ int block_items(int n_items, int block = blockIdx.x) {
  return n_items > block ? (n_items - 1 - block) / static_cast<int>(gridDim.x) + 1 : 0;
}

__device__ __forceinline__ int tc_items(int n_cols) {
  return (n_cols + kTcBoxRows - 1) / kTcBoxRows;
}
__device__ __forceinline__ int tc_kchunks(int K) { return (K + kTcChunkK - 1) / kTcChunkK; }
__device__ __forceinline__ int tc_passes(int B) { return (B + kTcRows - 1) / kTcRows; }

// The block's weight ring and the phase whose chunks it holds.  Chunks are
// numbered over the whole launch (head: issued, tail: consumed); chunk q
// sits in slot q % kTcStages, whose mbarrier completes its (q / kTcStages)-th
// phase when the chunk lands.  Every thread keeps the same counters; thread
// 0 alone issues the copies.  A phase's chunks run pass by pass, item by
// item, k-chunk by k-chunk, m-tile by m-tile.
template <typename T>
struct Tc {
  uint32_t ring, bars;
  uint32_t norm_bar;  // the norm weight's copy into `norm`
  unsigned norm_uses;
  uint8_t *act, *norm;
  float *red, *res;
  unsigned head, tail, base, n;
  bool primed;  // the ring holds (the first chunks of) the next phase
  Plan<T> plan;
  int rows;
  int rank, ranks;  // the block's rank in its cluster, the cluster's blocks

  __device__ void init(uint8_t* smem) {
    head = tail = base = n = norm_uses = 0;
    primed = false;
    rank = 0;
    ranks = 1;
    if constexpr (kTensorCores<T>) {
      const uint32_t raw = sm90::smem_u32(smem);
      const uint32_t pad = ((raw + 1023u) & ~1023u) - raw;
      uint8_t* b = smem + pad;
      ring = raw + pad;
      act = b + kTcRingBytes;
      red = reinterpret_cast<float*>(act + kTcActBytes);
      res = reinterpret_cast<float*>(reinterpret_cast<uint8_t*>(red) + kTcRedBytes);
      norm = reinterpret_cast<uint8_t*>(res) + kTcResBytes;
      bars = sm90::smem_u32(norm + kTcNormBytes);
      norm_bar = bars + 8u * kTcStages;
      rank = static_cast<int>(sm90::cluster_rank());
      ranks = static_cast<int>(sm90::cluster_blocks());
      if (threadIdx.x == 0) {
        for (int s = 0; s <= kTcStages; ++s) sm90::mbar_init(bars + 8u * s, 1);
        sm90::fence_barrier_init();
      }
      // every block of the cluster runs before any writes into its segment
      if (ranks > 1) sm90::cluster_sync();
      else __syncthreads();
    } else {
      act = smem;
    }
  }

  // the scratch of the phases that are not products (the attention rows,
  // the sampler's work[V]): the staged segment's space
  __device__ float* scratch() const { return reinterpret_cast<float*>(act); }

  __device__ void issue() {
    const int my = block_items(tc_items(plan.n_cols));
    const int nkc = tc_kchunks(plan.K);
    const int per_item = nkc * plan.mt;
    const int c = static_cast<int>(head - base) % (my * per_item);  // the pass does not matter
    const int il = c / per_item;
    const int kc = (c % per_item) / plan.mt;
    const int mt = c % plan.mt;
    const int col = kTcBoxRows * (static_cast<int>(blockIdx.x) + il * static_cast<int>(gridDim.x));
    const int s = mt ? 0 : col / plan.seg_rows;
    const Src<T>& src = mt ? plan.pair : plan.seg[s];
    const int row = src.row0 + col - s * plan.seg_rows;
    if (threadIdx.x == 0) {  // one copy: 8 boxes of 16 rows x 64 k (past K: zeros)
      const unsigned slot = head % kTcStages;
      const uint32_t bar = bars + 8u * slot;
      sm90::mbar_expect_tx(bar, kTcChunkBytes);
      sm90::tma_load_3d(ring + slot * kTcChunkBytes, src.map, bar, 0, row, kc * kDecWarps);
    }
    ++head;
  }
};

// Queue the phase `plan` over `rows` activation rows on the block's ring and
// issue its norm weight's copy (when it has one that the staged segment
// spans) and as many of its chunks as there are free slots.  Called right
// after the previous phase's products, before its grid barrier: the norm
// weight goes first, ahead of the weights' traffic.
template <typename T>
__device__ void tc_begin(Tc<T>& tc, const Plan<T>& plan, int rows) {
  if constexpr (kTensorCores<T>) {
    if (plan.norm != nullptr && plan.K <= kTcSegK) {
      if (threadIdx.x == 0) {
        sm90::mbar_expect_tx(tc.norm_bar, plan.K * 2);
        sm90::bulk_load(sm90::smem_u32(tc.norm), plan.norm, plan.K * 2, tc.norm_bar);
      }
      ++tc.norm_uses;
    }
    tc.plan = plan;
    tc.rows = rows;
    tc.base = tc.head;
    tc.n = static_cast<unsigned>(tc_passes(rows) * block_items(tc_items(plan.n_cols)) *
                                 tc_kchunks(plan.K) * plan.mt);
    while (tc.head - tc.base < tc.n && tc.head - tc.tail < kTcStages) tc.issue();
    tc.primed = true;
  }
}

// Byte offset of the 16-byte unit u (k = 8u .. 8u+7 of the segment) of row
// n in the staged segment: units XOR-swizzled by n % 8, so the 8 rows an
// ldmatrix 8x8 matrix reads sit in 8 distinct bank groups.
__device__ __forceinline__ int act_offset(int n, int u) {
  return n * kTcSegK * 2 + ((u ^ (n & 7)) << 4);
}

// Stage rows r0 .. r0+31, k = k0 .. of the segment of x [B, K] (rows past
// B and k past K are zeros), as bf16 in the swizzled layout, with the other
// blocks of the cluster: this block takes rows rank * 32 / ranks .. of the
// pass (every row in a cluster of 1), in rounds of the whole rows whose
// 16-byte units fit kIn a thread; a round's units e = tid, tid +
// kDecThreads, .. are all in flight at once and kept in registers.  With
// the plan's norm: when the segment holds whole rows (K <= kTcSegK), the
// rows' sums of squares are taken from the loaded values — per 8-vector
// partial sums (in tc.red) added per row in a fixed order: lane l of the
// row's warp adds units l, l + 32, .., then the butterfly — and the norm
// weight is the copy tc_begin started (tc.norm); else rs[] comes from
// row_scales (this rank's rows) and the weight from global memory.  The
// units are normed in registers, then each is written once into every
// block's segment at the same offset (its own included; in a cluster of 1
// a plain store).  Every block ends with the same bits whatever the
// cluster.  Not inlined: one copy a kernel (an inlined copy in every phase
// made the phases slower: the kernels' code overflows the instruction
// cache); kIn stays at 8, as more registers here spill in the callers.
static __device__ __noinline__ void stage_segment(Tc<__nv_bfloat16>& tc,
                                                  const __nv_bfloat16* x, int B, int r0, int k0,
                                                  float* rs) {
  using bf16 = __nv_bfloat16;
  constexpr int kIn = 8;
  const Plan<bf16>& pl = tc.plan;
  const int K = pl.K;
  const int kn = min(kTcSegK, (K + kTcBoxK - 1) / kTcBoxK * kTcBoxK - k0);
  const int units = kn / 8;  // 8-vectors a row
  const bool norm = pl.norm != nullptr;
  const bool whole = norm && K <= kTcSegK;
  const int per = kTcRows / tc.ranks, n_end = (tc.rank + 1) * per;
  const int round_rows = min(per, kIn * kDecThreads / units);
  const uint32_t act = sm90::smem_u32(tc.act);
  float* red = tc.red;
#pragma unroll 1
  for (int n0 = tc.rank * per; n0 < n_end; n0 += round_rows) {
    const int rows = min(round_rows, n_end - n0), owned = rows * units;
    uint4 v[kIn];
#pragma unroll
    for (int i = 0; i < kIn; ++i) {
      const int e = static_cast<int>(threadIdx.x) + kDecThreads * i;
      const int n = n0 + e / units, u = e % units;
      v[i] = e < owned && r0 + n < B && k0 + 8 * u < K
                 ? *reinterpret_cast<const uint4*>(x + static_cast<size_t>(r0 + n) * K + k0 +
                                                   8 * u)
                 : make_uint4(0, 0, 0, 0);
    }
    if (norm) {
      if (whole) {
#pragma unroll
        for (int i = 0; i < kIn; ++i) {
          const int e = static_cast<int>(threadIdx.x) + kDecThreads * i;
          if (e < owned) {
            float f[8];
            sm90::unpack8(v[i], f);
            float ss = 0.f;
#pragma unroll
            for (int j = 0; j < 8; ++j) ss += f[j] * f[j];
            red[(n0 + e / units) * units + e % units] = ss;
          }
        }
        __syncthreads();
        const int lane = threadIdx.x & 31;
        for (int n = n0 + (threadIdx.x >> 5); n < n0 + rows; n += kDecWarps) {
          float ss = 0.f;
          for (int k = lane; k < units; k += 32) ss += red[n * units + k];
          ss = warp_sum(ss);
          if (lane == 0) rs[r0 + n] = rsqrtf(ss / static_cast<float>(K) + pl.eps);
        }
        sm90::mbar_wait(tc.norm_bar, (tc.norm_uses - 1) & 1u);
      }
      __syncthreads();  // rs[]; every read of red above
      const bf16* w = whole ? reinterpret_cast<const bf16*>(tc.norm) : pl.norm + k0;
#pragma unroll
      for (int i = 0; i < kIn; ++i) {
        const int e = static_cast<int>(threadIdx.x) + kDecThreads * i;
        const int n = n0 + e / units, u = e % units;
        if (e < owned && r0 + n < B && k0 + 8 * u < K) {
          const uint4 wr = *reinterpret_cast<const uint4*>(w + 8 * u);
          __nv_bfloat162* xh = reinterpret_cast<__nv_bfloat162*>(&v[i]);
          const __nv_bfloat162* wh = reinterpret_cast<const __nv_bfloat162*>(&wr);
          const float r = rs[r0 + n];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            // T(x * rs), then the weight multiply in T: the bf16 product of
            // two bf16 values is their exact product rounded once, as in f32
            const float2 f = __bfloat1622float2(xh[j]);
            xh[j] = __hmul2(wh[j], __floats2bfloat162_rn(f.x * r, f.y * r));
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kIn; ++i) {
      const int e = static_cast<int>(threadIdx.x) + kDecThreads * i;
      if (e < owned) {
        const uint32_t at = act + act_offset(n0 + e / units, e % units);
#pragma unroll 1
        for (int p = 0; p < tc.ranks; ++p) sm90::st_cluster(sm90::map_shared(at, p), v[i]);
      }
    }
  }
}

// The queued phase (tc_begin) on tensor cores.  stage(r0, k0, act) stages
// the segment of pass r0 that starts at k0 (its share of it, into every
// block of the cluster); epi(col, b, v) gets output column col of row b,
// v[m] from the item's m-tile m.  Every thread of every block calls it (it
// holds block and cluster barriers).  The blocks of a cluster stage
// together: each runs as many items as the cluster's first block (the
// most), staging in every one, and multiplies in its own.
template <int MT, class StageFn, class EpiFn>
__device__ void tc_phase(Tc<__nv_bfloat16>& tc, StageFn stage, EpiFn epi) {
  using namespace sm90;
  const Plan<__nv_bfloat16>& pl = tc.plan;
  const int B = tc.rows, K = pl.K;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int my = block_items(tc_items(pl.n_cols));
  const int cluster_my =  // the cluster's first block's: the most
      block_items(tc_items(pl.n_cols), static_cast<int>(blockIdx.x) - tc.rank);
  const int nkc = tc_kchunks(K);
  const uint32_t act = smem_u32(tc.act);
  // ldmatrix lane roles: matrix i = lane / 8, its row lane % 8
  const int mi = lane >> 3, mr = lane & 7;
  const bool clustered = tc.ranks > 1;
  int staged = -1;
  for (int pass = 0; pass < tc_passes(B); ++pass) {
    const int r0 = pass * kTcRows;
    const int nt = min(kTcNTiles, (B - r0 + 7) / 8);
    for (int il = 0; il < cluster_my; ++il) {
      const bool mine = il < my;  // else: staging for the cluster only
      float acc[MT][kTcNTiles][4];
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int j = 0; j < kTcNTiles; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[m][j][i] = 0.f;
#pragma unroll 1
      for (int kc = 0; kc < nkc; ++kc) {
        const int seg = kc * kTcChunkK / kTcSegK;
        if (pass * 4096 + seg != staged) {
          // Every warp (of the cluster) is done with the previous segment
          // before any block writes the next, and every write has landed
          // before a block reads.  A cluster's first staging in a phase
          // follows the caller's grid barrier (or Tc::init's cluster
          // barrier), which orders it after every peer's last use.
          if (!clustered) __syncthreads();
          else if (staged >= 0) cluster_sync();
          stage(r0, seg * kTcSegK, tc.act);
          if (clustered) cluster_sync();
          else __syncthreads();
          staged = pass * 4096 + seg;
        }
        if (!mine) continue;
        const int k0 = kc * kTcChunkK + warp * kTcBoxK;  // this warp's box
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          const unsigned slot = tc.tail % kTcStages;
          if (k0 < K) {
            mbar_wait(tc.bars + 8u * slot, (tc.tail / kTcStages) & 1u);
            const uint32_t box = tc.ring + slot * kTcChunkBytes + warp * kTcBoxBytes;
            const int ku = (k0 - seg * kTcSegK) / 8;  // the box's first unit in the segment
#pragma unroll
            for (int kk = 0; kk < kTcBoxK / 16; ++kk) {
              // A: weight rows (mi & 1) * 8 + mr, k units 2kk + mi / 2 of the swizzled box
              const int ar = (mi & 1) * 8 + mr;
              uint32_t a[4];
              ldmatrix_x4(a, box + ar * 128 + (((2 * kk + (mi >> 1)) ^ (ar & 7)) << 4));
#pragma unroll
              for (int j = 0; j < kTcNTiles; j += 2) {
                if (j < nt) {
                  // B: rows 8(j + mi / 2) + mr, k units ku + 2kk + (mi & 1)
                  const int bn = 8 * (j + (mi >> 1)) + mr;
                  uint32_t b[4];
                  ldmatrix_x4(b, act + act_offset(bn, ku + 2 * kk + (mi & 1)));
                  mma_16816(acc[m][j], a, b[0], b[1]);
                  if (j + 1 < nt) mma_16816(acc[m][j + 1], a, b[2], b[3]);
                }
              }
            }
          }
          ++tc.tail;
          if (tc.head - tc.base < tc.n) {  // refill the slot once every warp is done with it
            __syncthreads();
            tc.issue();
          }
        }
      }
      if (!mine) continue;
      // the warps' partial sums, in warp order; then the epilogue
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        float* red = tc.red + warp * kTcBoxRows * kTcRows;
#pragma unroll
        for (int j = 0; j < kTcNTiles; ++j) {
          const int row = lane >> 2, col = 8 * j + 2 * (lane & 3);
          red[row * kTcRows + col] = acc[m][j][0];
          red[row * kTcRows + col + 1] = acc[m][j][1];
          red[(row + 8) * kTcRows + col] = acc[m][j][2];
          red[(row + 8) * kTcRows + col + 1] = acc[m][j][3];
        }
        __syncthreads();
        for (int e = threadIdx.x; e < kTcBoxRows * kTcRows; e += kDecThreads) {
          float sum = tc.red[e];
#pragma unroll
          for (int w = 1; w < kDecWarps; ++w) sum += tc.red[w * kTcBoxRows * kTcRows + e];
          tc.res[m * kTcBoxRows * kTcRows + e] = sum;
        }
        __syncthreads();
      }
      const int col0 =
          kTcBoxRows * (static_cast<int>(blockIdx.x) + il * static_cast<int>(gridDim.x));
      for (int e = threadIdx.x; e < kTcBoxRows * kTcRows; e += kDecThreads) {
        const int m = e % kTcBoxRows, n = e / kTcBoxRows;
        if (col0 + m < pl.n_cols && r0 + n < B) {
          float v[MT];
#pragma unroll
          for (int t = 0; t < MT; ++t) v[t] = tc.res[(t * kTcBoxRows + m) * kTcRows + n];
          epi(col0 + m, r0 + n, v);
        }
      }
    }
  }
  tc.primed = false;
}

// One matrix phase over `rows` rows of the activations x [rows, K]: bf16
// on tensor cores (the plan queued by tc_begin), f32 on CUDA cores
// (row_scales into rs, then gemv2 over column pairs; MT == 2 pairs row u of
// the plan's seg[0] and pair).  epi(col, b, v) as in tc_phase.
template <int MT, typename T, class EpiFn>
__device__ void matmul(Tc<T>& tc, const Plan<T>& pl, int rows, const T* x, float* rs, EpiFn epi) {
  const int K = pl.K;
  if (pl.norm != nullptr && (!kTensorCores<T> || K > kTcSegK))
    row_scales<T>(x, rows, K, pl.eps, rs, tc.rank, tc.ranks);
  if constexpr (kTensorCores<T>) {
    tc_phase<MT>(
        tc, [&](int r0, int k0, uint8_t*) { stage_segment(tc, x, rows, r0, k0, rs); }, epi);
  } else {
    auto load = [&](int b, int k, float* out) {
      if (pl.norm != nullptr) norm8<T>(x, pl.norm, rs, K, b, k, out);
      else load8(x + static_cast<size_t>(b) * K + k, out);
    };
    if constexpr (MT == 1) {
      gemv2<T>(
          rows, K, (pl.n_cols + 1) / 2,
          [&](int u, int c) -> const T* {
            const int n = 2 * u + c;
            if (n >= pl.n_cols) return nullptr;
            const int s = n / pl.seg_rows;
            return pl.seg[s].ptr + static_cast<size_t>(n - s * pl.seg_rows) * K;
          },
          load,
          [&](int u, int b, float a0, float a1) {
            epi(2 * u, b, &a0);
            if (2 * u + 1 < pl.n_cols) epi(2 * u + 1, b, &a1);
          },
          tc.act);
    } else {
      gemv2<T>(
          rows, K, pl.n_cols,
          [&](int u, int c) {
            return (c ? pl.pair.ptr : pl.seg[0].ptr) + static_cast<size_t>(u) * K;
          },
          load,
          [&](int u, int b, float a0, float a1) {
            const float v[2] = {a0, a1};
            epi(u, b, v);
          },
          tc.act);
    }
  }
}

// Host: a tensor map over a bf16 weight [rows, K] (K % 64 == 0) as 3-d
// (64 k, rows, K / 64 blocks of k), so that one copy of a box of 64 x 16 x 8
// brings a chunk (16 rows x 512 k) as 8 blocks of 16 rows x 64 k, each
// 128-byte swizzled; reads past the last row or the last block are zeros.
// False when K does not divide or the encoder refuses the map.
inline bool make_rows_map(CUtensorMap* map, const void* base, long long rows, int K) {
  const sm90::EncodeTiled encode = sm90::encode_tiled();
  if (encode == nullptr || base == nullptr || K % kTcBoxK != 0) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(kTcBoxK), static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(K / kTcBoxK)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(K) * 2, kTcBoxK * 2};
  const cuuint32_t box[3] = {kTcBoxK, kTcBoxRows, kDecWarps};
  const cuuint32_t unit[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims, strides,
                box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

}  // namespace mm
