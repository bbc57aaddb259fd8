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
// norm + q/k/v (decode.cuh's gemv2), attention (one block per (slot, head),
// one cached row per thread, the scores kept in shared memory — up to 16384
// rows per slot), o-proj + the append, norm + gate/up + SiLU, down.  The
// append runs only after the barrier that ends the layer's attention
// phase: at capacity the clipped write position is a row that phase reads.
#pragma once

#include <type_traits>

#include "decode.cuh"

namespace mm {

constexpr int kStepMaxChunks = 4;  // head_dim <= 128
constexpr int kStepMaxHeadDim = 32 * kStepMaxChunks;
constexpr int kScaleLanes = 128;  // the int8 pools' scale row: k in [0:H], v in [H:2H]

// KV: the pools' element type, T (updated in place) or signed char (int8,
// read only).
template <typename T, typename KV = T>
struct StepParams {
  static constexpr bool kQuant = std::is_same<KV, signed char>::value;
  const T *wqkv, *wo, *wgu, *wd, *ln;  // [L,3W,D], [L,D,W], [L,2F,D], [L,D,F], [L,2,D]
  const float *cos, *sin;              // [n_events, B, dh] at each slot's position
  const int *lengths, *wpos;           // [n_events, B]
  KV *k_pool, *v_pool;                 // [n_pages, page_size, W]
  T *x;                                // [B, D] residual stream, in place
  // scratch; fresh_k is [B, W] for T pools, the [L, B, W] output for int8 ones
  T *qkv, *attn, *fresh_k, *gated;
  unsigned int* bar;                   // zeroed {count, generation}
  const __nv_bfloat16* scales;         // int8 pools: [n_pages, page_size, 128]; else null
  T* fresh_v;                          // int8 pools: [L, B, W] output; else null
  // The ragged event loop's per-slot alive mask [B] (null otherwise): a
  // retired slot attends over nothing, appends nothing and keeps its
  // residual frozen.
  const unsigned char* alive;
  int B, D, H, dh, F, L, page_size, pps;
  float eps, scale;
};

template <typename T, typename KV>
__device__ __forceinline__ bool retired(const StepParams<T, KV>& p, int b) {
  return p.alive != nullptr && !p.alive[b];
}

// Sum v[0..63] over the warp's lanes: a halving butterfly (62 shuffles)
// that leaves lane L with the sums of dims 2L and 2L+1 in v[0], v[1].
__device__ __forceinline__ void warp_sum64(float* v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int off = 16, n = 32; off >= 1; off >>= 1, n >>= 1) {
    const bool upper = lane & off;
#pragma unroll
    for (int i = 0; i < n; ++i) {
      const float send = upper ? v[i] : v[i + n];
      const float keep = upper ? v[i + n] : v[i];
      v[i] = keep + __shfl_xor_sync(0xffffffffu, send, off);
    }
  }
}

// Attention of slot b, head h over its cached rows plus its own fresh row,
// at event ev's geometry.  One cached row per thread (the block's 256
// threads walk the rows in turn, each row's head slice read with 16-byte
// loads), in two passes: the scores go to shared memory (sc, one float per
// row) with their maximum, then each softmax weight is taken against that
// maximum and rounded to T before P.V — the plain version's rounding point,
// which an online softmax (weights against a running maximum) would move.
// The per-thread P.V sums (64 dims at a time) reduce across lanes, then
// across warps.  int8 pools: each row's k scale multiplies its score, its v
// scale the softmax weight, which is then rounded to bf16 (the TPU kernel's
// quantized form); the fresh rows go to the [L, B, W] outputs.
template <typename T, typename KV>
__device__ void slot_head_attention(const StepParams<T, KV>& p, int ev, int li, int b, int h,
                                    float* sc) {
  constexpr bool kQuant = StepParams<T, KV>::kQuant;
  __shared__ float s_q[kStepMaxHeadDim];
  __shared__ float s_o[kStepMaxHeadDim];
  __shared__ float s_red[kDecWarps];
  __shared__ float s_acc[kDecWarps][64];
  const int W = p.H * p.dh;
  const int C = p.dh / 32;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int slot = ev * p.B + b;  // this event's row of the geometry tables
  const T* q = p.qkv + static_cast<size_t>(b) * 3 * W + h * p.dh;
  const float* cs = p.cos + static_cast<size_t>(slot) * p.dh;
  const float* sn = p.sin + static_cast<size_t>(slot) * p.dh;
  float qs32[kStepMaxChunks];
  if (warp == 0) {
    float qr[kStepMaxChunks];
    rope_head<T, kStepMaxChunks>(q, cs, sn, C, qr);
#pragma unroll
    for (int c = 0; c < kStepMaxChunks; ++c) {
      qs32[c] = qr[c] * p.scale;
      if (c < C) s_q[lane + 32 * c] = round_to<T>(qs32[c]);  // qsb
    }
  }
  __syncthreads();

  const int len = retired(p, b) ? 0 : p.lengths[slot];
  const int base = (li * p.B + b) * p.pps;
  auto page_row = [&](int t) {
    return static_cast<size_t>(base + t / p.page_size) * p.page_size + t % p.page_size;
  };
  auto row_at = [&](int t) { return page_row(t) * W + h * p.dh; };
  float m = -CUDART_INF_F;
  for (int t = threadIdx.x; t < len; t += kDecThreads) {
    const KV* kr = p.k_pool + row_at(t);
    float s = 0.f;
    for (int d = 0; d < p.dh; d += 8) {
      float kv[8];
      load8(kr + d, kv);
#pragma unroll
      for (int i = 0; i < 8; ++i) s += s_q[d + i] * kv[i];
    }
    if constexpr (kQuant) s *= __bfloat162float(p.scales[page_row(t) * kScaleLanes + h]);
    sc[t] = s;
    m = fmaxf(m, s);
  }
  m = warp_max(m);
  if (lane == 0) s_red[warp] = m;
  __syncthreads();
  float big = -CUDART_INF_F;  // -inf for an empty slot
  for (int w = 0; w < kDecWarps; ++w) big = fmaxf(big, s_red[w]);
  __syncthreads();  // s_red is reused for l

  float l = 0.f;
  for (int d0 = 0; d0 < p.dh; d0 += 64) {
    float acc[64];
#pragma unroll
    for (int d = 0; d < 64; ++d) acc[d] = 0.f;
    for (int t = threadIdx.x; t < len; t += kDecThreads) {
      const float pe = expf(sc[t] - big);
      float pv;  // P.V in the pool dtype; int8: the v scale folded in, in bf16
      if constexpr (kQuant)
        pv = round_to<__nv_bfloat16>(
            pe * __bfloat162float(p.scales[page_row(t) * kScaleLanes + p.H + h]));
      else
        pv = round_to<T>(pe);
      if (d0 == 0) l += pe;
      const KV* vr = p.v_pool + row_at(t) + d0;
#pragma unroll
      for (int d = 0; d < 64; d += 8) {
        float vv[8];
        load8(vr + d, vv);
#pragma unroll
        for (int i = 0; i < 8; ++i) acc[d + i] += pv * vv[i];
      }
    }
    warp_sum64(acc);
    s_acc[warp][2 * lane] = acc[0];
    s_acc[warp][2 * lane + 1] = acc[1];
    __syncthreads();
    if (warp == 0) {
      for (int d = lane; d < 64; d += 32) {
        float sum = 0.f;
        for (int w = 0; w < kDecWarps; ++w) sum += s_acc[w][d];
        s_o[d0 + d] = sum;
      }
    }
    __syncthreads();
  }
  l = warp_sum(l);
  if (lane == 0) s_red[warp] = l;
  __syncthreads();

  if (warp == 0) {
    float total = 0.f;
    for (int w = 0; w < kDecWarps; ++w) total += s_red[w];
    float kr[kStepMaxChunks];
    rope_head<T, kStepMaxChunks>(q + W, cs, sn, C, kr);
    float s_self = 0.f;
#pragma unroll
    for (int c = 0; c < kStepMaxChunks; ++c)
      if (c < C) s_self += qs32[c] * kr[c];
    s_self = warp_sum(s_self);
    const float m2 = fmaxf(big, s_self);
    const float wc = total * expf(big - m2);
    const float ws = expf(s_self - m2);
    T* out = p.attn + static_cast<size_t>(b) * W + h * p.dh;
    // T pools: this layer's [B, W] scratch; int8: layer li's rows of the output
    const size_t fresh = (kQuant ? (static_cast<size_t>(li) * p.B + b) : b) * W + h * p.dh;
#pragma unroll
    for (int c = 0; c < kStepMaxChunks; ++c) {
      if (c < C) {
        const int d = lane + 32 * c;
        const float o = total > 0.f ? s_o[d] / total : 0.f;
        const float v = to_f32(q[2 * W + d]);
        out[d] = from_f32<T>((wc * o + ws * v) / (wc + ws));
        p.fresh_k[fresh + d] = from_f32<T>(kr[c]);
        if constexpr (kQuant) p.fresh_v[fresh + d] = q[2 * W + d];
      }
    }
  }
  __syncthreads();  // the shared buffers are reused by the block's next item
}

// All L layers of event ev (its row of the cos/sin/lengths/wpos tables).
// Every thread of every block calls it; it ends after the last layer's
// down phase, without a grid barrier.
template <typename T, typename KV>
__device__ void fused_step_body(const StepParams<T, KV>& p, int ev, float* xs, float* rs) {
  const int B = p.B, D = p.D, W = p.H * p.dh, F = p.F;
  for (int li = 0; li < p.L; ++li) {
    const T* wqkv = p.wqkv + static_cast<size_t>(li) * 3 * W * D;
    const T* wo = p.wo + static_cast<size_t>(li) * D * W;
    const T* wgu = p.wgu + static_cast<size_t>(li) * 2 * F * D;
    const T* wd = p.wd + static_cast<size_t>(li) * D * F;
    const T* ln_attn = p.ln + static_cast<size_t>(li) * 2 * D;
    const T* ln_mlp = ln_attn + D;

    // norm + q/k/v: unit u = columns 2u, 2u+1
    row_scales<T>(p.x, B, D, p.eps, rs);
    gemv2<T>(
        B, D, 3 * W / 2,
        [&](int u, int c) { return wqkv + static_cast<size_t>(2 * u + c) * D; },
        [&](int b, int k, float* out) { norm8<T>(p.x, ln_attn, rs, D, b, k, out); },
        [&](int u, int b, float a0, float a1) {
          T* o = p.qkv + static_cast<size_t>(b) * 3 * W + 2 * u;
          o[0] = from_f32<T>(a0);
          o[1] = from_f32<T>(a1);
        },
        xs);
    grid_barrier(p.bar);
    for (int item = blockIdx.x; item < B * p.H; item += gridDim.x)
      slot_head_attention<T, KV>(p, ev, li, item / p.H, item % p.H, xs);
    grid_barrier(p.bar);
    // append the fresh rows (every read of this layer's pages is done);
    // int8 pools are read only: their rows left through fresh_k / fresh_v
    if constexpr (!StepParams<T, KV>::kQuant) {
      for (int i = blockIdx.x * kDecThreads + threadIdx.x; i < B * W;
           i += gridDim.x * kDecThreads) {
        const int b = i / W;
        const int w = i - b * W;
        if (retired(p, b)) continue;
        const int pos = p.wpos[ev * B + b];
        const size_t dst =
            (static_cast<size_t>((li * B + b) * p.pps + pos / p.page_size) * p.page_size +
             pos % p.page_size) * W + w;
        p.k_pool[dst] = p.fresh_k[i];
        p.v_pool[dst] = p.qkv[static_cast<size_t>(b) * 3 * W + 2 * W + w];
      }
    }
    // o-proj + residual
    gemv2<T>(
        B, W, D / 2,
        [&](int u, int c) { return wo + static_cast<size_t>(2 * u + c) * W; },
        [&](int b, int k, float* out) { load8(p.attn + static_cast<size_t>(b) * W + k, out); },
        [&](int u, int b, float a0, float a1) {
          if (retired(p, b)) return;  // the residual stays frozen
          T* o = p.x + static_cast<size_t>(b) * D + 2 * u;
          o[0] = from_f32<T>(to_f32(o[0]) + round_to<T>(a0));
          o[1] = from_f32<T>(to_f32(o[1]) + round_to<T>(a1));
        },
        xs);
    grid_barrier(p.bar);
    // norm + gate/up + SiLU: unit u = (gate row u, up row F + u)
    row_scales<T>(p.x, B, D, p.eps, rs);
    gemv2<T>(
        B, D, F,
        [&](int u, int c) { return wgu + static_cast<size_t>(c * F + u) * D; },
        [&](int b, int k, float* out) { norm8<T>(p.x, ln_mlp, rs, D, b, k, out); },
        [&](int u, int b, float a0, float a1) {
          const float g = round_to<T>(silu_f32(round_to<T>(a0)));
          p.gated[static_cast<size_t>(b) * F + u] = from_f32<T>(g * round_to<T>(a1));
        },
        xs);
    grid_barrier(p.bar);
    // down + residual
    gemv2<T>(
        B, F, D / 2,
        [&](int u, int c) { return wd + static_cast<size_t>(2 * u + c) * F; },
        [&](int b, int k, float* out) { load8(p.gated + static_cast<size_t>(b) * F + k, out); },
        [&](int u, int b, float a0, float a1) {
          if (retired(p, b)) return;  // the residual stays frozen
          T* o = p.x + static_cast<size_t>(b) * D + 2 * u;
          o[0] = from_f32<T>(to_f32(o[0]) + round_to<T>(a0));
          o[1] = from_f32<T>(to_f32(o[1]) + round_to<T>(a1));
        },
        xs);
    if (li + 1 < p.L) grid_barrier(p.bar);
  }
}

// Fill p from the packed host arrays and advance the cursors.  ptrs: the
// pointers of StepParams in declaration order up to `fresh_v` (alive is
// left null; scales and fresh_v are null for T pools); ints: B, D, H, dh,
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
  p.alive = nullptr;
  for (int* f : {&p.B, &p.D, &p.H, &p.dh, &p.F, &p.L, &p.page_size, &p.pps}) *f = *ints++;
  p.eps = *floats++;
  p.scale = *floats++;
  constexpr bool kQuant = StepParams<T, KV>::kQuant;
  const bool quant_args = p.scales != nullptr && p.fresh_v != nullptr && 2 * p.H <= kScaleLanes;
  return p.dh <= kStepMaxHeadDim && p.dh % 64 == 0 && p.B <= kMaxBatch &&
         static_cast<size_t>(p.page_size) * p.pps * sizeof(float) <= kGemvSmem &&
         (kQuant ? quant_args : p.scales == nullptr && p.fresh_v == nullptr);
}

}  // namespace mm
