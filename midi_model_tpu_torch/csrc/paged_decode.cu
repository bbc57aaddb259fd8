// All-heads paged flash decode with the fresh-row append.
//
// Replaces: midi_model_tpu/ops/paged_allheads.py, _decode_kernel_cell (Pallas
// TPU, per-slot grid); it computes the same function as _decode_kernel_stream.
//
// What it computes: for each slot b and query head h, attention of the one
// pre-scaled f32 query row q[b, h, :] over the slot's first lengths[b] cached
// rows.  Pools are [n_pages, page_size, Hkv*stride] (bf16 or f32) with the
// layer axis folded into pages; row t of slot b lives at page
// base_pages[b] + t / page_size, row t % page_size, lanes
// [hkv*stride, hkv*stride + D) with hkv = h / (H / Hkv) (GQA).  Outputs:
// the normalized context o [B, H, D] f32 and the flash stats m, l [B, H]
// (max score and sum of exp(score - m)), which the caller uses to merge the
// fresh token's own term.  A slot of length 0 returns m = -inf, l = 0,
// o = 0, never NaN.  Optionally appends each slot's fresh packed k/v row at
// (write_pages[b], write_offs[b]); the pools are updated IN PLACE.
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
// head h's lanes of slot b, so that block writes exactly those lanes after a
// barrier that follows its last read.  With GQA several blocks read the same
// kv lanes, so the append runs as a second launch on the same stream.
#include "common.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxChunks = 4;  // D <= 128: each lane holds up to 4 dims

template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const float* __restrict__ q, T* k_pool, T* v_pool,
                    const int* __restrict__ lengths, const int* __restrict__ base_pages,
                    float* __restrict__ o, float* __restrict__ m_out, float* __restrict__ l_out,
                    const T* __restrict__ new_k, const T* __restrict__ new_v,
                    const int* __restrict__ write_pages, const int* __restrict__ write_offs,
                    int H, int groups, int D, int stride, int W, int page_size,
                    int append_here) {
  __shared__ float s_m[kWarps];
  __shared__ float s_l[kWarps];
  __shared__ float s_acc[kWarps][32 * kMaxChunks];

  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int lane_off = (h / groups) * stride;
  const int len = lengths[b];
  const int base = base_pages[b];

  const float* qh = q + (static_cast<size_t>(b) * H + h) * D;
  float qr[kMaxChunks];
  float acc[kMaxChunks];
#pragma unroll
  for (int c = 0; c < kMaxChunks; ++c) {
    const int d = lane + 32 * c;
    qr[c] = d < D ? qh[d] : 0.f;
    acc[c] = 0.f;
  }

  float m = -CUDART_INF_F;
  float l = 0.f;
  for (int t = warp; t < len; t += kWarps) {
    const size_t row =
        (static_cast<size_t>(base + t / page_size) * page_size + t % page_size) * W + lane_off;
    float s = 0.f;
#pragma unroll
    for (int c = 0; c < kMaxChunks; ++c) {
      const int d = lane + 32 * c;
      if (d < D) s += qr[c] * mm::to_f32(k_pool[row + d]);
    }
    s = mm::warp_sum(s);
    const float m_new = fmaxf(m, s);
    const float corr = expf(m - m_new);  // first row: exp(-inf) = 0
    const float p = expf(s - m_new);
    l = l * corr + p;
#pragma unroll
    for (int c = 0; c < kMaxChunks; ++c) {
      const int d = lane + 32 * c;
      if (d < D) acc[c] = acc[c] * corr + p * mm::to_f32(v_pool[row + d]);
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
    if (d < D) s_acc[warp][d] = acc[c];
  }
  __syncthreads();  // every read of this slot's rows is done

  if (append_here) {
    const size_t dst =
        (static_cast<size_t>(write_pages[b]) * page_size + write_offs[b]) * W + lane_off;
    const size_t src = static_cast<size_t>(b) * W + lane_off;
    for (int i = threadIdx.x; i < stride; i += kThreads) {
      k_pool[dst + i] = new_k[src + i];
      v_pool[dst + i] = new_v[src + i];
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
    const size_t out_row = (static_cast<size_t>(b) * H + h) * D;
#pragma unroll
    for (int c = 0; c < kMaxChunks; ++c) {
      const int d = lane + 32 * c;
      if (d < D) {
        float sum = 0.f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) sum += s_acc[w][d] * scale[w];
        o[out_row + d] = total > 0.f ? sum / total : 0.f;
      }
    }
    if (lane == 0) {
      m_out[static_cast<size_t>(b) * H + h] = big;
      l_out[static_cast<size_t>(b) * H + h] = total;
    }
  }
}

// GQA append: one block per slot copies the whole packed row, ordered after
// the decode kernel by the stream.
template <typename T>
__global__ void append_kernel(T* k_pool, T* v_pool, const T* __restrict__ new_k,
                              const T* __restrict__ new_v, const int* __restrict__ write_pages,
                              const int* __restrict__ write_offs, int W, int page_size) {
  const int b = blockIdx.x;
  const size_t dst = (static_cast<size_t>(write_pages[b]) * page_size + write_offs[b]) * W;
  const size_t src = static_cast<size_t>(b) * W;
  for (int i = threadIdx.x; i < W; i += blockDim.x) {
    k_pool[dst + i] = new_k[src + i];
    v_pool[dst + i] = new_v[src + i];
  }
}

template <typename T>
int launch(const float* q, void* k_pool, void* v_pool, const int* lengths,
           const int* base_pages, float* o, float* m, float* l, const void* new_k,
           const void* new_v, const int* write_pages, const int* write_offs, int B, int H,
           int Hkv, int D, int W, int page_size, int append, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int groups = H / Hkv;
  const int stride = W / Hkv;
  const int append_here = append && groups == 1;
  paged_decode_kernel<T><<<dim3(B, H), kThreads, 0, s>>>(
      q, static_cast<T*>(k_pool), static_cast<T*>(v_pool), lengths, base_pages, o, m, l,
      static_cast<const T*>(new_k), static_cast<const T*>(new_v), write_pages, write_offs, H,
      groups, D, stride, W, page_size, append_here);
  int err = mm::last_error();
  if (err != 0 || !append || append_here) return err;
  append_kernel<T><<<B, 256, 0, s>>>(static_cast<T*>(k_pool), static_cast<T*>(v_pool),
                                     static_cast<const T*>(new_k),
                                     static_cast<const T*>(new_v), write_pages, write_offs, W,
                                     page_size);
  return mm::last_error();
}

}  // namespace

extern "C" int mm_paged_decode_f32(const float* q, void* k_pool, void* v_pool,
                                   const int* lengths, const int* base_pages, float* o,
                                   float* m, float* l, const void* new_k, const void* new_v,
                                   const int* write_pages, const int* write_offs, int B, int H,
                                   int Hkv, int D, int W, int page_size, int append,
                                   void* stream) {
  return launch<float>(q, k_pool, v_pool, lengths, base_pages, o, m, l, new_k, new_v,
                       write_pages, write_offs, B, H, Hkv, D, W, page_size, append, stream);
}

extern "C" int mm_paged_decode_bf16(const float* q, void* k_pool, void* v_pool,
                                    const int* lengths, const int* base_pages, float* o,
                                    float* m, float* l, const void* new_k, const void* new_v,
                                    const int* write_pages, const int* write_offs, int B,
                                    int H, int Hkv, int D, int W, int page_size, int append,
                                    void* stream) {
  return launch<__nv_bfloat16>(q, k_pool, v_pool, lengths, base_pages, o, m, l, new_k, new_v,
                               write_pages, write_offs, B, H, Hkv, D, W, page_size, append,
                               stream);
}
