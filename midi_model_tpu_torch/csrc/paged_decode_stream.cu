// All-heads paged flash decode with the fresh-row append, streamed over a
// flat (slot, block) work list: the continuous batcher's ragged lengths.
//
// Replaces: midi_model_tpu/ops/paged_allheads.py, _decode_kernel_stream
// (Pallas TPU, one grid cell streaming a slot-major (slot, block) list), for
// bf16, f32 and int8 pools.
//
// What it computes: the function of paged_decode.cu (the plain version is
// midi_model_tpu_torch/ops/paged_allheads.py, decode_reference + kv_append):
// for each slot b and query head h, attention of the pre-scaled f32 query
// q[b, h, :] over the slot's first lengths[b] cached rows (flat row
// base_pages[b] * page_size + t; kv head g = h / (H / Hkv) in lanes
// [g*stride, g*stride + D); on int8 pools the score is (q . k_int8) *
// k_scale and the P.V sum takes p * (float(v_int8) * v_scale), with the
// bf16 scales of the row's kv head in lanes [0:Hkv] (k) and [Hkv:2Hkv] (v)
// of the scale pool).
// Outputs o [B, H, D] f32 normalized, m, l [B, H]; a slot of length 0 (an
// empty or inactive slot) returns o = 0, m = -inf, l = 0.  Optionally
// appends each slot's fresh row (and scale row) at (write_pages[b],
// write_offs[b]), IN PLACE.
//
// What bounds it on an H100: bytes — every live cached row of every slot is
// read once (2 * W * sizeof(T) bytes, plus 2 * Hkv scale values for int8)
// for ~2 flops per byte.  At the batcher's ragged, mostly short lengths a
// grid of one block per slot leaves most of the 132 SMs idle while a few
// long slots finish.
//
// Design: split-K, two launches on one stream.  The work list is implicit:
// item i is block j — up to ppb pages — of slot s in the flat slot-major
// order over the live lengths, and each block finds its own (s, j) with a
// warp scan over the slots' block counts; items past the list's end exit at
// once.  The host issues one call and no work-list ops.
// (1) one block per (item, head) computes the head's partial flash state
// over the item's rows: one row per thread for the scores (16-byte loads of
// the row's head slice) into shared memory, the block's maximum and
// exp-sum, then the unnormalized P.V, each thread one dim over every
// (kThreads/D)-th row (coalesced row reads).  (2) one block per slot merges
// its items' partials with the flash rescale and normalizes.  The append
// runs in the merge, after every read of the slot's rows: at capacity the
// clipped write position (capacity-1) lies inside the read range, so no
// partial block may write it.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kLane = 128;  // scale row width

template <typename T>
struct StreamArgs {
  const float* q;
  T *k_pool, *v_pool;
  __nv_bfloat16* scales;  // null unless int8
  const int *lengths, *base_pages;
  float *o, *m, *l;
  const T *new_k, *new_v;
  const __nv_bfloat16* new_scales;
  const int *write_pages, *write_offs;
  float *part_o, *part_ml;  // [n_items, H, D], [n_items, 2, H] (m, then l)
  int B, H, Hkv, groups, D, stride, W, page_size, ppb, append;
};

// Blocks of up to bk rows that a slot of `length` rows needs.
__device__ __forceinline__ int blocks_of(int length, int bk) { return (length + bk - 1) / bk; }

// Warp-wide (all 32 lanes): the slot and block of work item `item` in the
// flat slot-major list over the lengths, or slot -1 past the list's end.
__device__ int2 find_item(const int* lengths, int B, int bk, int item) {
  const int lane = threadIdx.x & 31;
  int before = 0;  // items of the slots already passed
  for (int s0 = 0; s0 < B; s0 += 32) {
    const int nb = s0 + lane < B ? blocks_of(lengths[s0 + lane], bk) : 0;
    int cum = nb;  // inclusive scan over the warp's 32 slots
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, cum, off);
      if (lane >= off) cum += y;
    }
    const unsigned hit = __ballot_sync(0xffffffffu, before + cum > item);
    if (hit) {
      const int src = __ffs(hit) - 1;
      const int end = before + __shfl_sync(0xffffffffu, cum, src);
      const int n = __shfl_sync(0xffffffffu, nb, src);
      return make_int2(s0 + src, item - (end - n));
    }
    before += __shfl_sync(0xffffffffu, cum, 31);
  }
  return make_int2(-1, 0);
}

// Warp-wide: the items of slots [0, s), i.e. the index of slot s's first item.
__device__ int items_before(const int* lengths, int s, int bk) {
  const int lane = threadIdx.x & 31;
  int sum = 0;
  for (int t = lane; t < s; t += 32) sum += blocks_of(lengths[t], bk);
  for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
  return sum;
}

// 16 bytes of T from p as floats (Vec16<T>::n of them); p 16-byte aligned.
template <typename T> struct Vec16 { static constexpr int n = 16 / sizeof(T); };

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

// Block (item, head h): head h's partial flash state over the item's rows.
// One cached row per thread for the scores (the row's D values of kv head
// h / groups in 16-byte loads), kept in shared memory; the block's maximum
// and exp-sum; then the unnormalized P.V with thread (g, d) summing dim d
// over rows t = g (mod kThreads / D), reduced across g in shared memory.
template <typename T>
__global__ void __launch_bounds__(kThreads) stream_partial_kernel(StreamArgs<T> a) {
  const int item = blockIdx.x;
  constexpr int V = Vec16<T>::n;
  extern __shared__ float sc[];  // [rows]: scores, then exp weights
  __shared__ float s_q[128];
  __shared__ float s_red[kWarps];
  __shared__ float s_acc[kThreads];
  __shared__ int2 s_item;
  const int bk = a.ppb * a.page_size;
  if (threadIdx.x < 32) {
    const int2 found = find_item(a.lengths, a.B, bk, item);
    if (threadIdx.x == 0) s_item = found;
  }
  __syncthreads();
  const int s = s_item.x;
  if (s < 0) return;  // past the list's end
  const int h = blockIdx.y;
  const int H = a.H, D = a.D;
  const int kv = h / a.groups;
  const int r0 = s_item.y * bk;
  const int n = min(bk, a.lengths[s] - r0);  // >= 1 for a live item
  const size_t first_row = static_cast<size_t>(a.base_pages[s]) * a.page_size + r0;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int d = threadIdx.x; d < D; d += kThreads)
    s_q[d] = a.q[(static_cast<size_t>(s) * H + h) * D + d];
  __syncthreads();

  float m = -CUDART_INF_F;
  for (int t = threadIdx.x; t < n; t += kThreads) {
    const size_t r = first_row + t;
    const T* kr = a.k_pool + r * a.W + kv * a.stride;
    float dot = 0.f;
    for (int d = 0; d < D; d += V) {
      float x[V];
      load16(kr + d, x);
#pragma unroll
      for (int i = 0; i < V; ++i) dot += s_q[d + i] * x[i];
    }
    // one k scale per (row, kv head): the plain version's per-value
    // float(int8) * scale, factored out (equal up to f32 rounding)
    if (a.scales) dot *= mm::to_f32(a.scales[r * kLane + kv]);
    sc[t] = dot;
    m = fmaxf(m, dot);
  }
  m = mm::warp_max(m);
  if (lane == 0) s_red[warp] = m;
  __syncthreads();
  float big = s_red[0];
  for (int w = 1; w < kWarps; ++w) big = fmaxf(big, s_red[w]);
  __syncthreads();  // s_red is reused for the sum
  float l = 0.f;
  for (int t = threadIdx.x; t < n; t += kThreads) {
    const float e = expf(sc[t] - big);
    sc[t] = e;
    l += e;
  }
  l = mm::warp_sum(l);
  if (lane == 0) s_red[warp] = l;
  __syncthreads();  // the weights in sc and the warp sums are complete

  const int groups = kThreads / D;  // row groups of the P.V sum (D divides kThreads)
  const int d = threadIdx.x % D;
  const T* vcol = a.v_pool + first_row * a.W + kv * a.stride + d;
  const __nv_bfloat16* vsc = a.scales ? a.scales + first_row * kLane + a.Hkv + kv : nullptr;
  float acc = 0.f;
  for (int t = threadIdx.x / D; t < n; t += groups) {
    const float vs = vsc ? mm::to_f32(vsc[static_cast<size_t>(t) * kLane]) : 1.f;
    acc += sc[t] * (mm::to_f32(vcol[static_cast<size_t>(t) * a.W]) * vs);
  }
  s_acc[threadIdx.x] = acc;
  __syncthreads();
  if (threadIdx.x < D) {
    float sum = 0.f;
    for (int j = 0; j < groups; ++j) sum += s_acc[j * D + threadIdx.x];
    a.part_o[(static_cast<size_t>(item) * H + h) * D + threadIdx.x] = sum;
  }
  if (threadIdx.x == 0) {
    float total = 0.f;
    for (int w = 0; w < kWarps; ++w) total += s_red[w];
    float* ml = a.part_ml + static_cast<size_t>(item) * 2 * H;
    ml[h] = big;
    ml[H + h] = total;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) stream_merge_kernel(StreamArgs<T> a) {
  const int s = blockIdx.x;
  const int H = a.H, D = a.D;
  const int bk = a.ppb * a.page_size;
  const int n = blocks_of(a.lengths[s], bk);
  __shared__ int s_first;
  if (threadIdx.x < 32) {
    const int first = items_before(a.lengths, s, bk);
    if (threadIdx.x == 0) s_first = first;
  }
  __syncthreads();
  const int f = s_first;
  for (int j = threadIdx.x; j < H * D; j += kThreads) {
    const int h = j / D;
    float big = -CUDART_INF_F;
    for (int i = 0; i < n; ++i) big = fmaxf(big, a.part_ml[static_cast<size_t>(f + i) * 2 * H + h]);
    float total = 0.f, acc = 0.f;
    for (int i = 0; i < n; ++i) {
      const float* ml = a.part_ml + static_cast<size_t>(f + i) * 2 * H;
      const float w = expf(ml[h] - big);  // every item holds >= 1 row: ml[h] is finite
      total += ml[H + h] * w;
      acc += a.part_o[(static_cast<size_t>(f + i) * H + h) * D + (j - h * D)] * w;
    }
    a.o[static_cast<size_t>(s) * H * D + j] = total > 0.f ? acc / total : 0.f;
    if (j - h * D == 0) {
      a.m[static_cast<size_t>(s) * H + h] = big;
      a.l[static_cast<size_t>(s) * H + h] = total;
    }
  }
  if (!a.append) return;
  // the partial launch, which holds every read of this slot's rows, is done
  const size_t dst_row = static_cast<size_t>(a.write_pages[s]) * a.page_size + a.write_offs[s];
  for (int i = threadIdx.x; i < a.W; i += kThreads) {
    a.k_pool[dst_row * a.W + i] = a.new_k[static_cast<size_t>(s) * a.W + i];
    a.v_pool[dst_row * a.W + i] = a.new_v[static_cast<size_t>(s) * a.W + i];
  }
  if (a.scales)
    for (int i = threadIdx.x; i < kLane; i += kThreads)
      a.scales[dst_row * kLane + i] = a.new_scales[static_cast<size_t>(s) * kLane + i];
}

template <typename T>
int launch(const float* q, void* k_pool, void* v_pool, void* scales, const int* lengths,
           const int* base_pages, float* o, float* m, float* l, const void* new_k,
           const void* new_v, const void* new_scales, const int* write_pages,
           const int* write_offs, float* part_o, float* part_ml, int B, int H,
           int Hkv, int D, int W, int page_size, int ppb, int n_items, int append,
           void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  StreamArgs<T> a{q, static_cast<T*>(k_pool), static_cast<T*>(v_pool),
                  static_cast<__nv_bfloat16*>(scales), lengths, base_pages, o, m, l,
                  static_cast<const T*>(new_k), static_cast<const T*>(new_v),
                  static_cast<const __nv_bfloat16*>(new_scales), write_pages, write_offs,
                  part_o, part_ml, B, H, Hkv, H / Hkv, D, W / Hkv, W, page_size, ppb, append};
  if (D > 128 || kThreads % D || (W / Hkv * sizeof(T)) % 16 || D % Vec16<T>::n)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(ppb) * page_size * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(stream_partial_kernel<T>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  if (n_items > 0) stream_partial_kernel<T><<<dim3(n_items, H), kThreads, smem, st>>>(a);
  int err = mm::last_error();
  if (err != 0) return err;
  stream_merge_kernel<T><<<B, kThreads, 0, st>>>(a);
  return mm::last_error();
}

}  // namespace

#define MM_PAGED_DECODE_STREAM(NAME, T)                                                     \
  extern "C" int NAME(const float* q, void* k_pool, void* v_pool, void* scales,             \
                      const int* lengths, const int* base_pages, float* o, float* m,        \
                      float* l, const void* new_k, const void* new_v,                       \
                      const void* new_scales, const int* write_pages,                       \
                      const int* write_offs, float* part_o, float* part_ml, int B, int H,   \
                      int Hkv, int D, int W, int page_size, int ppb, int n_items,           \
                      int append, void* stream) {                                           \
    return launch<T>(q, k_pool, v_pool, scales, lengths, base_pages, o, m, l, new_k, new_v, \
                     new_scales, write_pages, write_offs, part_o, part_ml, B, H, Hkv, D, W, \
                     page_size, ppb, n_items, append, stream);                              \
  }

MM_PAGED_DECODE_STREAM(mm_paged_decode_stream_f32, float)
MM_PAGED_DECODE_STREAM(mm_paged_decode_stream_bf16, __nv_bfloat16)
MM_PAGED_DECODE_STREAM(mm_paged_decode_stream_int8, int8_t)
