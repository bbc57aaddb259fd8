// The token row of one event as a device function of a cooperative grid:
// every step of the token net, the shared lm_head, the grammar masks and
// the sampler.  token_loop.cu launches it alone (one event per launch);
// event_loop.cu runs it once per event, between the event-net steps.
//
// What it computes, for each batch row b (the plain version is
// midi_model_tpu_torch/ops/token_loop.py, decode_token_row_reference):
// step j = 0..T-1 runs the L-layer token net (RMSNorm, q/k/v, rotate-half
// RoPE at position j, softmax attention over positions 0..j of this row's
// live K/V, o-proj, SwiGLU MLP; residual adds in T) on one input row —
// the event-net hidden at step 0, the token net's own embedding of the
// previous token after — then the final norm and lm_head (logits rounded
// to T, then f32), softmax(logits / temp[b]), the grammar mask (first[] at
// step 0, steps[e_off, j] after; pad_only[] once the row ended with eos at
// step 0, and at every step of a forced_pad row), the optional allow plane,
// and a draw: the first maximum (greedy) or the top-p / top-k Gumbel draw
// of sampler.cuh with noise gumbel[j*B + b] (step-major, as the JAX kernel).
//
// Design: each step is a sequence of phases separated by a global-memory
// grid barrier (5 per layer + 2 per step): norm + q/k/v, RoPE + attention
// (one warp per (row, head)), o-proj + residual, norm + gate/up + SiLU,
// down + residual, final norm + lm_head, then sampling + the next input's
// embedding (one block per row).  The matrix phases are decode.cuh's gemv2
// on CUDA cores.  The live K/V (at most T rows per row and head) and the
// activations sit in global scratch, which stays in L2.  The rounding
// points are the plain version's: matmul outputs, RoPE, the attention
// probabilities (before P.V), the attention output, SiLU and the residual
// adds round to T.
#pragma once

#include "decode.cuh"
#include "sampler.cuh"

namespace mm {

constexpr int kTokMaxLayers = 8;
constexpr int kTokMaxSteps = 8;   // tokens per row (max_token_seq)
constexpr int kTokMaxChunks = 8;  // head_dim <= 256

template <typename T>
struct TokenLayer {
  const T *wq, *wk, *wv, *wo, *wg, *wu, *wd, *ln_attn, *ln_mlp;
};

template <typename T>
struct TokenParams {
  TokenLayer<T> layer[kTokMaxLayers];
  const T *fnorm, *lm, *emb;         // [D], [V, D], [V, D]
  const float *cos, *sin;            // [T, dh]
  const unsigned char *first, *steps, *pad_only;  // [V], [E, T, V], [V]
  const unsigned char *allow;        // [B, V] or null
  const unsigned char *forced;       // [B] or null
  const float *temp, *top_p;         // [B]
  const int* top_k;                  // [B]
  const float* gumbel;               // [n_events, T*B, k_cap]; null when greedy
  T *x, *qkv, *attn, *gated, *kc, *vc;  // scratch; x holds the step-0 input
  float* logits;                     // [B, V] scratch
  int* e_off;                        // [B] scratch
  unsigned int* bar;                 // zeroed {count, generation}
  int* row;                          // [n_events, B, T] out
  unsigned char* ended;              // [B] out
  // The event embedding, for the whole-event loop (null otherwise): the
  // block that samples row b sums emb_net[id] over the row's steps in f32
  // (ev_acc [B, D]) and writes the sum rounded to T to ev_out [B, D].
  const T* emb_net;
  float* ev_acc;
  T* ev_out;
  // The ragged event loop's per-slot alive mask [B] (null otherwise): a
  // retired slot samples pad at every step, like a forced_pad row, and its
  // event embedding is not written (its residual stays frozen).
  const unsigned char* alive;
  int B, D, H, dh, F, V, L, n_steps, E, k_cap, eos_id, first_event_id, greedy;
  float eps, scale;
};

// RoPE + attention of the step's query over positions 0..j: one warp per
// (row, head); lane owns dims lane + 32c, so it reads back only what it
// wrote itself into the live K/V.
template <typename T>
__device__ void token_attention(const TokenParams<T>& p, int li, int j) {
  const int W = p.H * p.dh;
  const int C = p.dh / 32;
  const int lane = threadIdx.x & 31;
  const int gw = blockIdx.x * kDecWarps + (threadIdx.x >> 5);
  const float* cs = p.cos + static_cast<size_t>(j) * p.dh;
  const float* sn = p.sin + static_cast<size_t>(j) * p.dh;
  for (int item = gw; item < p.B * p.H; item += gridDim.x * kDecWarps) {
    const int b = item / p.H;
    const int h = item % p.H;
    const T* q = p.qkv + static_cast<size_t>(b) * 3 * W + h * p.dh;
    float qr[kTokMaxChunks], kr[kTokMaxChunks];
    rope_head<T, kTokMaxChunks>(q, cs, sn, C, qr);
    rope_head<T, kTokMaxChunks>(q + W, cs, sn, C, kr);
    // live K/V: [L, T, B, W]
    const size_t here = ((static_cast<size_t>(li) * p.n_steps + j) * p.B + b) * W + h * p.dh;
    const size_t step_stride = static_cast<size_t>(p.B) * W;
    const size_t first = here - static_cast<size_t>(j) * step_stride;
#pragma unroll
    for (int c = 0; c < kTokMaxChunks; ++c) {
      if (c < C) {
        const int d = lane + 32 * c;
        p.kc[here + d] = from_f32<T>(kr[c]);
        p.vc[here + d] = q[2 * W + d];
      }
    }
    float s[kTokMaxSteps];
    float m = -CUDART_INF_F;
#pragma unroll
    for (int t = 0; t < kTokMaxSteps; ++t) {
      if (t <= j) {
        const T* kt = p.kc + first + t * step_stride;
        float acc = 0.f;
#pragma unroll
        for (int c = 0; c < kTokMaxChunks; ++c)
          if (c < C) acc += qr[c] * to_f32(kt[lane + 32 * c]);
        s[t] = warp_sum(acc) * p.scale;
        m = fmaxf(m, s[t]);
      }
    }
    float sum = 0.f;
#pragma unroll
    for (int t = 0; t < kTokMaxSteps; ++t) {
      if (t <= j) {
        s[t] = expf(s[t] - m);
        sum += s[t];
      }
    }
    float o[kTokMaxChunks] = {};
#pragma unroll
    for (int t = 0; t < kTokMaxSteps; ++t) {
      if (t <= j) {
        const float pt = round_to<T>(s[t] / sum);
        const T* vt = p.vc + first + t * step_stride;
#pragma unroll
        for (int c = 0; c < kTokMaxChunks; ++c)
          if (c < C) o[c] += pt * to_f32(vt[lane + 32 * c]);
      }
    }
    T* out = p.attn + static_cast<size_t>(b) * W + h * p.dh;
#pragma unroll
    for (int c = 0; c < kTokMaxChunks; ++c)
      if (c < C) out[lane + 32 * c] = from_f32<T>(o[c]);
  }
}

__device__ inline float block_reduce(float v, bool is_max, float* red) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int off = 16; off > 0; off >>= 1) {
    const float o = __shfl_xor_sync(0xffffffffu, v, off);
    v = is_max ? fmaxf(v, o) : v + o;
  }
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float r = red[0];
  for (int w = 1; w < kDecWarps; ++w) r = is_max ? fmaxf(r, red[w]) : r + red[w];
  __syncthreads();
  return r;
}

// Softmax, mask, allow plane and the draw for row b at step j of event ev
// (one block), then the next step's input row: the token net's embedding
// of the token; with emb_net, the event embedding's running sum.
template <typename T>
__device__ void sample_row(const TokenParams<T>& p, int ev, int j, int b, float* work,
                           ArgmaxScratch<kDecThreads>& am, float* red) {
  const int V = p.V;
  const float temp = p.temp[b];
  const float* lg = p.logits + static_cast<size_t>(b) * V;
#pragma unroll 4
  for (int v = threadIdx.x; v < V; v += kDecThreads) work[v] = lg[v] / temp;
  __syncthreads();
  float m = -CUDART_INF_F;
  for (int v = threadIdx.x; v < V; v += kDecThreads) m = fmaxf(m, work[v]);
  m = block_reduce(m, true, red);
  float sum = 0.f;
  for (int v = threadIdx.x; v < V; v += kDecThreads) sum += expf(work[v] - m);
  sum = block_reduce(sum, false, red);
  const bool forced = (p.forced != nullptr && p.forced[b]) || (p.alive != nullptr && !p.alive[b]);
  const bool pad = forced || (j > 0 && p.ended[b]);
  const unsigned char* mask =
      pad ? p.pad_only
          : (j == 0 ? p.first
                    : p.steps + (static_cast<size_t>(p.e_off[b]) * p.n_steps + j) * V);
  const unsigned char* allow = p.allow ? p.allow + static_cast<size_t>(b) * V : nullptr;
#pragma unroll 4
  for (int v = threadIdx.x; v < V; v += kDecThreads) {
    float pr = expf(work[v] - m) / sum;
    pr *= mask[v] ? 1.f : 0.f;
    if (allow) pr *= allow[v] ? 1.f : 0.f;
    work[v] = pr;
  }
  __syncthreads();
  int id;
  if (p.greedy) {
    id = block_first_max<kDecThreads>(work, V, am).i;
  } else {
    const int n_iter = min(p.top_k[b], p.k_cap);
    const float* g =
        p.gumbel + ((static_cast<size_t>(ev) * p.n_steps + j) * p.B + b) * p.k_cap;
    id = sample_top_p_k_block<kDecThreads>(work, V, p.top_p[b], n_iter, g, am);
  }
  if (threadIdx.x == 0) {
    p.row[(static_cast<size_t>(ev) * p.B + b) * p.n_steps + j] = id;
    if (j == 0) {
      p.ended[b] = id == p.eos_id;
      p.e_off[b] = min(max(id - p.first_event_id, 0), p.E - 1);
    }
  }
  if (j + 1 < p.n_steps) {
    const T* e = p.emb + static_cast<size_t>(id) * p.D;
    T* x = p.x + static_cast<size_t>(b) * p.D;
    for (int i = threadIdx.x; i < p.D; i += kDecThreads) x[i] = e[i];
  }
  if (p.emb_net && !(p.alive && !p.alive[b])) {  // f32 sum in step order, one rounding
    const T* e = p.emb_net + static_cast<size_t>(id) * p.D;
    float* acc = p.ev_acc + static_cast<size_t>(b) * p.D;
    T* out = p.ev_out + static_cast<size_t>(b) * p.D;
    for (int i = threadIdx.x; i < p.D; i += kDecThreads) {
      const float s = (j == 0 ? 0.f : acc[i]) + to_f32(e[i]);
      if (j + 1 < p.n_steps) acc[i] = s;
      else out[i] = from_f32<T>(s);
    }
  }
  __syncthreads();  // work and the scratch are reused by the next row
}

// The whole token row of event ev (its noise and its rows in the [E, ...]
// planes); p.x holds the step-0 input.  Every thread of every block calls
// it; it ends after the last sampling phase, without a grid barrier.
template <typename T>
__device__ void token_row_body(const TokenParams<T>& p, int ev, float* xs, float* rs, float* red,
                               ArgmaxScratch<kDecThreads>& am) {
  const int B = p.B, D = p.D, W = p.H * p.dh, F = p.F;
  for (int j = 0; j < p.n_steps; ++j) {
    for (int li = 0; li < p.L; ++li) {
      const TokenLayer<T> ly = p.layer[li];
      // norm + q/k/v: unit u = columns 2u, 2u+1 of [q | k | v]
      row_scales<T>(p.x, B, D, p.eps, rs);
      gemv2<T>(
          B, D, 3 * W / 2,
          [&](int u, int c) {
            const int n = 2 * u + c;
            const T* w = n < W ? ly.wq : (n < 2 * W ? ly.wk : ly.wv);
            return w + static_cast<size_t>(n % W) * D;
          },
          [&](int b, int k, float* out) { norm8<T>(p.x, ly.ln_attn, rs, D, b, k, out); },
          [&](int u, int b, float a0, float a1) {
            T* o = p.qkv + static_cast<size_t>(b) * 3 * W + 2 * u;
            o[0] = from_f32<T>(a0);
            o[1] = from_f32<T>(a1);
          },
          xs);
      grid_barrier(p.bar);
      token_attention<T>(p, li, j);
      grid_barrier(p.bar);
      // o-proj + residual
      gemv2<T>(
          B, W, D / 2,
          [&](int u, int c) { return ly.wo + static_cast<size_t>(2 * u + c) * W; },
          [&](int b, int k, float* out) { load8(p.attn + static_cast<size_t>(b) * W + k, out); },
          [&](int u, int b, float a0, float a1) {
            T* o = p.x + static_cast<size_t>(b) * D + 2 * u;
            o[0] = from_f32<T>(to_f32(o[0]) + round_to<T>(a0));
            o[1] = from_f32<T>(to_f32(o[1]) + round_to<T>(a1));
          },
          xs);
      grid_barrier(p.bar);
      // norm + gate/up + SiLU: unit u = (gate row u, up row u)
      row_scales<T>(p.x, B, D, p.eps, rs);
      gemv2<T>(
          B, D, F,
          [&](int u, int c) { return (c ? ly.wu : ly.wg) + static_cast<size_t>(u) * D; },
          [&](int b, int k, float* out) { norm8<T>(p.x, ly.ln_mlp, rs, D, b, k, out); },
          [&](int u, int b, float a0, float a1) {
            const float g = round_to<T>(silu_f32(round_to<T>(a0)));
            p.gated[static_cast<size_t>(b) * F + u] = from_f32<T>(g * round_to<T>(a1));
          },
          xs);
      grid_barrier(p.bar);
      // down + residual
      gemv2<T>(
          B, F, D / 2,
          [&](int u, int c) { return ly.wd + static_cast<size_t>(2 * u + c) * F; },
          [&](int b, int k, float* out) { load8(p.gated + static_cast<size_t>(b) * F + k, out); },
          [&](int u, int b, float a0, float a1) {
            T* o = p.x + static_cast<size_t>(b) * D + 2 * u;
            o[0] = from_f32<T>(to_f32(o[0]) + round_to<T>(a0));
            o[1] = from_f32<T>(to_f32(o[1]) + round_to<T>(a1));
          },
          xs);
      grid_barrier(p.bar);
    }
    // final norm + lm_head: logits in T, kept as f32
    row_scales<T>(p.x, B, D, p.eps, rs);
    gemv2<T>(
        B, D, (p.V + 1) / 2,
        [&](int u, int c) -> const T* {
          const int n = 2 * u + c;
          return n < p.V ? p.lm + static_cast<size_t>(n) * D : nullptr;
        },
        [&](int b, int k, float* out) { norm8<T>(p.x, p.fnorm, rs, D, b, k, out); },
        [&](int u, int b, float a0, float a1) {
          float* o = p.logits + static_cast<size_t>(b) * p.V + 2 * u;
          o[0] = round_to<T>(a0);
          if (2 * u + 1 < p.V) o[1] = round_to<T>(a1);
        },
        xs);
    grid_barrier(p.bar);
    for (int b = blockIdx.x; b < B; b += gridDim.x) sample_row<T>(p, ev, j, b, xs, am, red);
    if (j + 1 < p.n_steps) grid_barrier(p.bar);
  }
}

// Fill p from the packed host arrays and advance the cursors.  ptrs: the
// pointers of TokenParams in declaration order up to `ended`, 9 per layer
// for kTokMaxLayers layers first (emb_net, ev_acc, ev_out and alive are
// left null); ints: B, D, H, dh, F, V, L, n_steps, E, k_cap, eos_id,
// first_event_id, greedy; floats: eps, scale.  Returns false for shapes
// the kernel does not take.
template <typename T>
bool fill_token_params(TokenParams<T>& p, const void* const*& ptrs, const int*& ints,
                       const float*& floats) {
  auto next = [&]() { return const_cast<void*>(*ptrs++); };
  for (int l = 0; l < kTokMaxLayers; ++l) {
    TokenLayer<T>& ly = p.layer[l];
    for (const T** w : {&ly.wq, &ly.wk, &ly.wv, &ly.wo, &ly.wg, &ly.wu, &ly.wd, &ly.ln_attn,
                        &ly.ln_mlp})
      *w = static_cast<const T*>(next());
  }
  p.fnorm = static_cast<const T*>(next());
  p.lm = static_cast<const T*>(next());
  p.emb = static_cast<const T*>(next());
  p.cos = static_cast<const float*>(next());
  p.sin = static_cast<const float*>(next());
  p.first = static_cast<const unsigned char*>(next());
  p.steps = static_cast<const unsigned char*>(next());
  p.pad_only = static_cast<const unsigned char*>(next());
  p.allow = static_cast<const unsigned char*>(next());
  p.forced = static_cast<const unsigned char*>(next());
  p.temp = static_cast<const float*>(next());
  p.top_p = static_cast<const float*>(next());
  p.top_k = static_cast<const int*>(next());
  p.gumbel = static_cast<const float*>(next());
  for (T** s : {&p.x, &p.qkv, &p.attn, &p.gated, &p.kc, &p.vc}) *s = static_cast<T*>(next());
  p.logits = static_cast<float*>(next());
  p.e_off = static_cast<int*>(next());
  p.bar = static_cast<unsigned int*>(next());
  p.row = static_cast<int*>(next());
  p.ended = static_cast<unsigned char*>(next());
  p.emb_net = nullptr;
  p.ev_acc = nullptr;
  p.ev_out = nullptr;
  p.alive = nullptr;
  for (int* f : {&p.B, &p.D, &p.H, &p.dh, &p.F, &p.V, &p.L, &p.n_steps, &p.E, &p.k_cap,
                 &p.eos_id, &p.first_event_id, &p.greedy})
    *f = *ints++;
  p.eps = *floats++;
  p.scale = *floats++;
  return p.L <= kTokMaxLayers && p.n_steps <= kTokMaxSteps && p.dh <= 32 * kTokMaxChunks &&
         p.dh % 64 == 0 && p.B <= kMaxBatch &&
         static_cast<size_t>(p.V) * sizeof(float) <= kGemvSmem;
}

}  // namespace mm
