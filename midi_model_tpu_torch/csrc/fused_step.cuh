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
// norm + q/k/v; attention (one block per (slot, head), the longest slots
// first, one cached row per thread, the scores kept in shared memory — up
// to 16384 rows per slot, in the space of the staged activation segment),
// then the item's append of its fresh row's head slice (only the item
// reads that slice, so at capacity, where the clipped write position is a
// row the item reads, the write follows the item's last read); o-proj;
// norm + gate/up + SiLU; down.  The matrix phases are decode.cuh's: bf16 on
// tensor cores with each phase's weights (tensor maps over the stacked
// [L * rows, K] weights) prefetched by TMA before the barrier that
// precedes it — the o-proj weights land during the attention phase —, f32
// on CUDA cores.
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
// at event ev's geometry, then the append of the fresh row's head slice.
// One cached row per thread (the block's 256 threads walk the rows in turn,
// each row's head slice read with 16-byte loads), in two passes: the scores
// go to shared memory (sc, one float per row) with their maximum, then each
// softmax weight is taken against that maximum and rounded to T before P.V
// — the plain version's rounding point, which an online softmax (weights
// against a running maximum) would move.  The per-thread P.V sums (64 dims
// at a time) reduce across lanes, then across warps.  int8 pools: each
// row's k scale multiplies its score, its v scale the softmax weight, which
// is then rounded to bf16 (the TPU kernel's quantized form); the fresh rows
// go to the [L, B, W] outputs.
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
    for (int d0 = 0; d0 < p.dh; d0 += 64) {
      // 64 dims of the row's head slice are loaded before the first product
      float kv[64];
#pragma unroll
      for (int d = 0; d < 64; d += 8) load8(kr + d0 + d, kv + d);
#pragma unroll
      for (int d = 0; d < 64; ++d) s += s_q[d0 + d] * kv[d];
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
    // T pools: the append of the fresh row's head slice at wpos — only this
    // item reads the slice, and every read of it is behind the block
    // barrier above; int8 pools (read only): layer li's rows of the outputs
    size_t fresh = (static_cast<size_t>(li) * p.B + b) * W + h * p.dh;
    if constexpr (!kQuant) {
      const int pos = p.wpos[slot];
      fresh = (static_cast<size_t>(base + pos / p.page_size) * p.page_size + pos % p.page_size) *
                  W + h * p.dh;
    }
    const bool append = kQuant || !retired(p, b);
#pragma unroll
    for (int c = 0; c < kStepMaxChunks; ++c) {
      if (c < C) {
        const int d = lane + 32 * c;
        const float o = total > 0.f ? s_o[d] / total : 0.f;
        const float v = to_f32(q[2 * W + d]);
        out[d] = from_f32<T>((wc * o + ws * v) / (wc + ws));
        if (append) {
          if constexpr (kQuant) {
            p.fresh_k[fresh + d] = from_f32<T>(kr[c]);
            p.fresh_v[fresh + d] = q[2 * W + d];
          } else {
            p.k_pool[fresh + d] = from_f32<T>(kr[c]);
            p.v_pool[fresh + d] = q[2 * W + d];
          }
        }
      }
    }
  }
  __syncthreads();  // the shared buffers are reused by the block's next item
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
  // the slots by decreasing length (ties: by slot), for the attention phases
  __shared__ int by_length[kMaxBatch];
  for (int b = threadIdx.x; b < B; b += kDecThreads) {
    const int len = p.lengths[ev * B + b];
    int rank = 0;
    for (int o = 0; o < B; ++o) {
      const int lo = p.lengths[ev * B + o];
      rank += lo > len || (lo == len && o < b);
    }
    by_length[rank] = b;
  }
  __syncthreads();
  for (int li = 0; li < p.L; ++li) {
    // norm + q/k/v
    matmul<1>(
        tc, step_qkv_plan(p, li), B, p.x, rs,
        [&](int col, int b, const float* v) {
          p.qkv[static_cast<size_t>(b) * 3 * W + col] = from_f32<T>(v[0]);
        });
    tc_begin(tc, step_o_plan(p, li), B);
    sync.barrier();
    // (slot, head) items, the longest slots first: consecutive items go to
    // consecutive blocks, so no block takes two of the longest
    for (int item = blockIdx.x; item < B * p.H; item += gridDim.x)
      slot_head_attention<T, KV>(p, ev, li, by_length[item / p.H], item % p.H, tc.scratch());
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
// (or null); bf16: encodes the four tensor maps.  ints: B, D, H, dh,
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
  p.alive = nullptr;
  for (int* f : {&p.B, &p.D, &p.H, &p.dh, &p.F, &p.L, &p.page_size, &p.pps}) *f = *ints++;
  p.eps = *floats++;
  p.scale = *floats++;
  constexpr bool kQuant = StepParams<T, KV>::kQuant;
  const bool quant_args = p.scales != nullptr && p.fresh_v != nullptr && 2 * p.H <= kScaleLanes;
  const bool ok = p.dh <= kStepMaxHeadDim && p.dh % 64 == 0 && p.B <= kMaxBatch &&
                  static_cast<size_t>(p.page_size) * p.pps * sizeof(float) <= kGemvSmem &&
                  (kQuant ? quant_args : p.scales == nullptr && p.fresh_v == nullptr);
  if (!ok) return false;
  if constexpr (kTensorCores<T>) {
    const int W = p.H * p.dh;
    const long long L = p.L;
    return make_rows_map(&p.tm_qkv, p.wqkv, L * 3 * W, p.D) &&
           make_rows_map(&p.tm_o, p.wo, L * p.D, W) &&
           make_rows_map(&p.tm_gu, p.wgu, L * 2 * p.F, p.D) &&
           make_rows_map(&p.tm_d, p.wd, L * p.D, p.F);
  }
  return true;
}

}  // namespace mm
