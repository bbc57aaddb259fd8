// All-heads paged flash decode with the fresh-row append: one block per
// (slot, head).
//
// Replaces: midi_model_tpu/ops/paged_allheads.py, _decode_kernel_cell (Pallas
// TPU, per-slot grid), for bf16, f32 and int8 pools.  paged_decode_stream.cu
// computes the same function over a flat (slot, block) work list.
//
// What it computes: for each slot b and query head h, attention of the one
// pre-scaled f32 query row q[b, h, :] over the slot's first lengths[b] cached
// rows.  Pools are [n_pages, page_size, Hkv*stride] (bf16, f32 or int8) with
// the layer axis folded into pages; row t of slot b is flat row
// base_pages[b] * page_size + t, lanes [g*stride, g*stride + D) with
// g = h / (H / Hkv) (GQA).  int8 pools carry a bf16 scale pool
// [n_pages, page_size, 128]: k scales in lanes [0:Hkv], v scales in
// [Hkv:2Hkv]; a cached value dequantizes as float(int8) * float(scale) — an
// exact product, the plain version's (decode_reference) value — before it
// enters the score or the P.V sum.  Outputs: the normalized context
// o [B, H, D] f32 and the flash stats m, l [B, H] (max score and sum of
// exp(score - m)), which the caller uses to merge the fresh token's own
// term.  A slot of length 0 returns m = -inf, l = 0, o = 0, never NaN.
// Optionally appends each slot's fresh packed k/v row (and its scale row)
// at (write_pages[b], write_offs[b]); the pools are updated IN PLACE.
//
// What bounds it on an H100: bytes.  Each cached row is read once per kv
// head (2 * D * sizeof(T) bytes per head per row) and gets ~2 flops per
// byte, far below the ~295 flops/byte the card needs before compute bounds.
//
// Design (simple first version): one block of 4 warps per (slot, head).
// Each warp walks every 4th row: its 32 lanes hold D/32 query values in
// registers, load the row's k lanes, reduce the dot product with shuffles,
// and keep an online softmax in f32 (m, l and the context accumulator).  The
// four warps' states merge through shared memory at the end.  Nothing
// crosses blocks.
//
// The append comes after the reads.  At capacity the caller clips the write
// position to capacity-1 while lengths = capacity, so the row being written
// can be one this call reads.  With MHA (H == Hkv) only block (b, h) reads
// head h's lanes of slot b, so that block writes exactly those lanes (and
// head h's two scale lanes; head 0's block also the scale row's unused
// lanes) after a barrier that follows its last read.  With GQA several
// blocks read the same kv lanes, so the append runs as a second launch on
// the same stream.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxChunks = 4;  // D <= 128: each lane holds up to 4 dims
constexpr int kLane = 128;     // scale row width

struct Geometry {
  int H, Hkv, groups, D, stride, W, page_size;
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const float* __restrict__ q, T* k_pool, T* v_pool, __nv_bfloat16* scales,
                    const int* __restrict__ lengths, const int* __restrict__ base_pages,
                    float* __restrict__ o, float* __restrict__ m_out, float* __restrict__ l_out,
                    const T* __restrict__ new_k, const T* __restrict__ new_v,
                    const __nv_bfloat16* __restrict__ new_scales,
                    const int* __restrict__ write_pages, const int* __restrict__ write_offs,
                    Geometry g, int append_here) {
  __shared__ float s_m[kWarps];
  __shared__ float s_l[kWarps];
  __shared__ float s_acc[kWarps][32 * kMaxChunks];

  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int kv = h / g.groups;
  const int lane_off = kv * g.stride;
  const int len = lengths[b];
  const size_t first_row = static_cast<size_t>(base_pages[b]) * g.page_size;

  const float* qh = q + (static_cast<size_t>(b) * g.H + h) * g.D;
  float qr[kMaxChunks];
  float acc[kMaxChunks];
#pragma unroll
  for (int c = 0; c < kMaxChunks; ++c) {
    const int d = lane + 32 * c;
    qr[c] = d < g.D ? qh[d] : 0.f;
    acc[c] = 0.f;
  }

  float m = -CUDART_INF_F;
  float l = 0.f;
  for (int t = warp; t < len; t += kWarps) {
    const size_t r = first_row + t;
    const size_t row = r * g.W + lane_off;
    float ks = 1.f, vs = 1.f;  // exact: x * 1.f == x for bf16 / f32 pools
    if (scales) {
      ks = mm::to_f32(scales[r * kLane + kv]);
      vs = mm::to_f32(scales[r * kLane + g.Hkv + kv]);
    }
    float s = 0.f;
#pragma unroll
    for (int c = 0; c < kMaxChunks; ++c) {
      const int d = lane + 32 * c;
      if (d < g.D) s += qr[c] * (mm::to_f32(k_pool[row + d]) * ks);
    }
    s = mm::warp_sum(s);
    const float m_new = fmaxf(m, s);
    const float corr = expf(m - m_new);  // first row: exp(-inf) = 0
    const float p = expf(s - m_new);
    l = l * corr + p;
#pragma unroll
    for (int c = 0; c < kMaxChunks; ++c) {
      const int d = lane + 32 * c;
      if (d < g.D) acc[c] = acc[c] * corr + p * (mm::to_f32(v_pool[row + d]) * vs);
    }
    m = m_new;
  }

  if (lane == 0) {
    s_m[warp] = m;
    s_l[warp] = l;
  }
#pragma unroll
  for (int c = 0; c < kMaxChunks; ++c) {
    const int d = lane + 32 * c;
    if (d < g.D) s_acc[warp][d] = acc[c];
  }
  __syncthreads();  // every read of this slot's rows is done

  if (append_here) {
    const size_t dst_row = static_cast<size_t>(write_pages[b]) * g.page_size + write_offs[b];
    const size_t dst = dst_row * g.W + lane_off;
    const size_t src = static_cast<size_t>(b) * g.W + lane_off;
    for (int i = threadIdx.x; i < g.stride; i += kThreads) {
      k_pool[dst + i] = new_k[src + i];
      v_pool[dst + i] = new_v[src + i];
    }
    if (scales) {
      const __nv_bfloat16* ns = new_scales + static_cast<size_t>(b) * kLane;
      __nv_bfloat16* ds = scales + dst_row * kLane;
      if (threadIdx.x == 0) ds[kv] = ns[kv];
      if (threadIdx.x == 1) ds[g.Hkv + kv] = ns[g.Hkv + kv];
      if (h == 0)
        for (int i = 2 * g.Hkv + threadIdx.x; i < kLane; i += kThreads) ds[i] = ns[i];
    }
  }

  if (warp == 0) {
    float big = -CUDART_INF_F;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) big = fmaxf(big, s_m[w]);
    float scale[kWarps];
    float total = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      // a warp that saw no row has m = -inf: weight 0, not exp(-inf + inf)
      scale[w] = s_m[w] == -CUDART_INF_F ? 0.f : expf(s_m[w] - big);
      total += s_l[w] * scale[w];
    }
    const size_t out_row = (static_cast<size_t>(b) * g.H + h) * g.D;
#pragma unroll
    for (int c = 0; c < kMaxChunks; ++c) {
      const int d = lane + 32 * c;
      if (d < g.D) {
        float sum = 0.f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) sum += s_acc[w][d] * scale[w];
        o[out_row + d] = total > 0.f ? sum / total : 0.f;
      }
    }
    if (lane == 0) {
      m_out[static_cast<size_t>(b) * g.H + h] = big;
      l_out[static_cast<size_t>(b) * g.H + h] = total;
    }
  }
}

// GQA append: one block per slot copies the whole packed row (and the
// whole scale row), ordered after the decode kernel by the stream.
template <typename T>
__global__ void append_kernel(T* k_pool, T* v_pool, __nv_bfloat16* scales,
                              const T* __restrict__ new_k, const T* __restrict__ new_v,
                              const __nv_bfloat16* __restrict__ new_scales,
                              const int* __restrict__ write_pages,
                              const int* __restrict__ write_offs, int W, int page_size) {
  const int b = blockIdx.x;
  const size_t dst_row = static_cast<size_t>(write_pages[b]) * page_size + write_offs[b];
  const size_t src = static_cast<size_t>(b) * W;
  for (int i = threadIdx.x; i < W; i += blockDim.x) {
    k_pool[dst_row * W + i] = new_k[src + i];
    v_pool[dst_row * W + i] = new_v[src + i];
  }
  if (scales)
    for (int i = threadIdx.x; i < kLane; i += blockDim.x)
      scales[dst_row * kLane + i] = new_scales[static_cast<size_t>(b) * kLane + i];
}

template <typename T>
int launch(const float* q, void* k_pool, void* v_pool, void* scales, const int* lengths,
           const int* base_pages, float* o, float* m, float* l, const void* new_k,
           const void* new_v, const void* new_scales, const int* write_pages,
           const int* write_offs, int B, int H, int Hkv, int D, int W, int page_size,
           int append, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Geometry g{H, Hkv, H / Hkv, D, W / Hkv, W, page_size};
  const int append_here = append && g.groups == 1;
  auto* sc = static_cast<__nv_bfloat16*>(scales);
  auto* nsc = static_cast<const __nv_bfloat16*>(new_scales);
  paged_decode_kernel<T><<<dim3(B, H), kThreads, 0, s>>>(
      q, static_cast<T*>(k_pool), static_cast<T*>(v_pool), sc, lengths, base_pages, o, m, l,
      static_cast<const T*>(new_k), static_cast<const T*>(new_v), nsc, write_pages, write_offs,
      g, append_here);
  int err = mm::last_error();
  if (err != 0 || !append || append_here) return err;
  append_kernel<T><<<B, 256, 0, s>>>(static_cast<T*>(k_pool), static_cast<T*>(v_pool), sc,
                                     static_cast<const T*>(new_k), static_cast<const T*>(new_v),
                                     nsc, write_pages, write_offs, W, page_size);
  return mm::last_error();
}

}  // namespace

#define MM_PAGED_DECODE(NAME, T)                                                            \
  extern "C" int NAME(const float* q, void* k_pool, void* v_pool, void* scales,             \
                      const int* lengths, const int* base_pages, float* o, float* m,        \
                      float* l, const void* new_k, const void* new_v,                       \
                      const void* new_scales, const int* write_pages,                       \
                      const int* write_offs, int B, int H, int Hkv, int D, int W,           \
                      int page_size, int append, void* stream) {                            \
    return launch<T>(q, k_pool, v_pool, scales, lengths, base_pages, o, m, l, new_k, new_v, \
                     new_scales, write_pages, write_offs, B, H, Hkv, D, W, page_size,       \
                     append, stream);                                                       \
  }

MM_PAGED_DECODE(mm_paged_decode_f32, float)
MM_PAGED_DECODE(mm_paged_decode_bf16, __nv_bfloat16)
MM_PAGED_DECODE(mm_paged_decode_int8, int8_t)
