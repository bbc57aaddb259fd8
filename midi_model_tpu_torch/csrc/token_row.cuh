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
// grid barrier (5 per layer + 2 per step): norm + q/k/v; RoPE + attention
// (one warp per (row, head), 8 head dims a lane); o-proj + residual; norm +
// gate/up + SiLU; down + residual; final norm + lm_head; then sampling +
// the next input's embedding (one block per row).  The matrix phases are
// decode.cuh's: tc_phase on tensor cores for bf16 (each phase's weights
// prefetched across the barrier before it), gemv2 on CUDA cores for f32.
// The live K/V (at most T rows per row and head) and the activations sit
// in global scratch, which stays in L2.  The rounding points are the plain
// version's: matmul outputs, RoPE, the attention probabilities (before
// P.V), the attention output, SiLU and the residual adds round to T.
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

// a token layer's weights in TokenLayer order: q, k, v, o, gate, up, down
constexpr int kTokMaps = 7;

template <typename T>
struct TokenParams {
  // bf16: a tensor map over each weight (decode.cuh make_rows_map)
  CUtensorMap tm[kTokMaxLayers][kTokMaps];
  CUtensorMap tm_lm;
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
  unsigned long long* clock;  // the phase clock (PhaseSync) or null
  int B, D, H, dh, F, V, L, n_steps, E, k_cap, eos_id, first_event_id, greedy;
  float eps, scale;
};

// RoPE + attention of step j's query over positions 0..j of layer li: one
// warp per (row, head), spread over the grid; lane l < dh/8 owns head dims
// 8l .. 8l+7 (16-byte loads; RoPE's rotate-half partner is lane l -+
// dh/16).  Writes the attention output [B, W] and the fresh k (after RoPE)
// and v rows into the live K/V.  All of a pair's cached rows are loaded
// before the first score is summed.
template <typename T>
__device__ void token_attention(const TokenParams<T>& p, int li, int j) {
  const int W = p.H * p.dh;
  const int nl = p.dh / 8, half = nl / 2;
  const int lane = threadIdx.x & 31;
  const bool mine = lane < nl;
  const int partner = lane < half ? lane + half : (lane < nl ? lane - half : lane);
  const float* cs = p.cos + static_cast<size_t>(j) * p.dh + 8 * lane;
  const float* sn = p.sin + static_cast<size_t>(j) * p.dh + 8 * lane;
  const size_t step_stride = static_cast<size_t>(p.B) * W;
  for (int item = blockIdx.x * kDecWarps + (threadIdx.x >> 5); item < p.B * p.H;
       item += gridDim.x * kDecWarps) {
    const int b = item / p.H, h = item % p.H;
    const T* q = p.qkv + static_cast<size_t>(b) * 3 * W + h * p.dh + 8 * lane;
    float qv[8] = {}, kv[8] = {}, vv[8] = {};
    if (mine) {
      load8(q, qv);
      load8(q + W, kv);
      load8(q + 2 * W, vv);
    }
    float qr[8], kr[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float qp = __shfl_sync(0xffffffffu, qv[i], partner);
      const float kp = __shfl_sync(0xffffffffu, kv[i], partner);
      const float c = mine ? cs[i] : 0.f, sv = mine ? sn[i] : 0.f;
      const float rq = lane < half ? -qp : qp, rk = lane < half ? -kp : kp;
      qr[i] = round_to<T>(__fadd_rn(__fmul_rn(qv[i], c), __fmul_rn(rq, sv)));
      kr[i] = round_to<T>(__fadd_rn(__fmul_rn(kv[i], c), __fmul_rn(rk, sv)));
    }
    // live K/V: [L, T, B, W]; positions 0 .. j-1 from earlier steps, j fresh
    const size_t first = (static_cast<size_t>(li) * p.n_steps * p.B + b) * W + h * p.dh +
                         8 * lane;
    float kt[kTokMaxSteps][8];
#pragma unroll
    for (int t = 0; t < kTokMaxSteps; ++t) {
      if (t < j && mine) {
        load8(p.kc + first + t * step_stride, kt[t]);
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i) kt[t][i] = t == j ? kr[i] : 0.f;
      }
    }
    float sc[kTokMaxSteps];
    float m = -CUDART_INF_F;
#pragma unroll
    for (int t = 0; t < kTokMaxSteps; ++t) {
      if (t <= j) {
        float acc = 0.f;
#pragma unroll
        for (int i = 0; i < 8; ++i) acc += qr[i] * kt[t][i];
        sc[t] = warp_sum(acc) * p.scale;
        m = fmaxf(m, sc[t]);
      }
    }
    float sum = 0.f;
#pragma unroll
    for (int t = 0; t < kTokMaxSteps; ++t) {
      if (t <= j) {
        sc[t] = expf(sc[t] - m);
        sum += sc[t];
      }
    }
    float o[8] = {};
#pragma unroll
    for (int t = 0; t < kTokMaxSteps; ++t) {
      if (t <= j) {
        float vt[8];
        if (t < j && mine) {
          load8(p.vc + first + t * step_stride, vt);
        } else {
#pragma unroll
          for (int i = 0; i < 8; ++i) vt[i] = vv[i];
        }
        const float pt = round_to<T>(sc[t] / sum);
#pragma unroll
        for (int i = 0; i < 8; ++i) o[i] += pt * vt[i];
      }
    }
    if (mine) {
      const size_t here = first + j * step_stride;
      store8(p.kc + here, kr);
      store8(p.vc + here, vv);
      store8(p.attn + static_cast<size_t>(b) * W + h * p.dh + 8 * lane, o);
    }
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

// The sample phase's shared memory, in the staged segment (Tc::scratch()):
// work[V], the draw's scratch, then the byte rows of the mask and the allow
// plane (V + 8 bytes each: whole words around the row).  fill_token_params
// refuses a V for which it does not fit (ops/token_loop.py MAX_VOCAB).
__host__ __device__ inline size_t sample_scratch_offset(int V) {
  return (static_cast<size_t>(V) + 3) / 4 * 16;
}

__host__ __device__ inline size_t sample_stage_offset(int V) {
  return sample_scratch_offset(V) + sizeof(SampleScratch<kDecThreads>);
}

__host__ __device__ inline size_t sample_stage_bytes(int V) {
  return (static_cast<size_t>(V) + 8 + 15) / 16 * 16;
}

inline bool sample_scratch_fits(int V) {
  return sample_stage_offset(V) + 2 * sample_stage_bytes(V) <= kGemvSmem;
}

// Copy the byte row src[0, V) into stage by 4-byte async copies of the
// words around it; returns where byte 0 of the row lands.
__device__ inline const unsigned char* stage_row(const unsigned char* src, int V,
                                                 unsigned char* stage) {
  const int off = static_cast<int>(reinterpret_cast<uintptr_t>(src) & 3);
  const unsigned char* words = src - off;
  for (int w = threadIdx.x; 4 * w < off + V; w += kDecThreads)
    sm90::cp_async_4(sm90::smem_u32(stage + 4 * w), words + 4 * w);
  return stage + off;
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
  const bool forced = (p.forced != nullptr && p.forced[b]) || (p.alive != nullptr && !p.alive[b]);
  const bool pad = forced || (j > 0 && p.ended[b]);
  const unsigned char* mask =
      pad ? p.pad_only
          : (j == 0 ? p.first
                    : p.steps + (static_cast<size_t>(p.e_off[b]) * p.n_steps + j) * V);
  const unsigned char* allow = p.allow ? p.allow + static_cast<size_t>(b) * V : nullptr;
  // This phase runs once between long matrix phases, so its code comes cold
  // from the instruction cache, and the kernel's shared memory leaves next
  // to no L1: its loops are kept short (the draw too:
  // sample_top_p_k_block<.., 2, 2>), and every row it reads is first
  // brought into shared memory by async copies, all in flight at once.
  for (int v = threadIdx.x; v < V; v += kDecThreads)
    sm90::cp_async_4(sm90::smem_u32(work + v), lg + v);
  unsigned char* stage = reinterpret_cast<unsigned char*>(work) + sample_stage_offset(V);
  const unsigned char* mask_s = stage_row(mask, V, stage);
  const unsigned char* allow_s =
      allow ? stage_row(allow, V, stage + sample_stage_bytes(V)) : nullptr;
  sm90::cp_async_commit();
  sm90::cp_async_wait<0>();  // this thread's copies; the others' by the next barrier
  // the logits over temp and the row's max (each thread its own ids)
  float m = -CUDART_INF_F;
  for_each_entry<kDecThreads, 2>(V, [&](int v) { return work[v]; }, [&](int v, float l) {
    if (v < V) {
      const float x = l / temp;
      work[v] = x;
      m = fmaxf(m, x);
    }
  });
  m = block_reduce(m, true, red);
  float sum = 0.f;  // each thread sums its ids in order; work keeps the exps
  for_each_entry<kDecThreads, 2>(V, [&](int v) { return work[v]; }, [&](int v, float x) {
    if (v < V) {
      const float e = expf(x - m);
      work[v] = e;
      sum += e;
    }
  });
  sum = block_reduce(sum, false, red);
  // the normalized, masked probability of id v (read from and kept in work[v])
  auto prob = [&](int v) {
    float pr = work[v] / sum;
    pr *= mask_s[v] ? 1.f : 0.f;
    if (allow_s) pr *= allow_s[v] ? 1.f : 0.f;
    return pr;
  };
  int id;
  if (p.greedy) {
#pragma unroll 4
    for (int v = threadIdx.x; v < V; v += kDecThreads) work[v] = prob(v);
    __syncthreads();
    id = block_first_max<kDecThreads>(work, V, am).i;
  } else {
    const int n_iter = min(p.top_k[b], p.k_cap);
    const float* g =
        p.gumbel + ((static_cast<size_t>(ev) * p.n_steps + j) * p.B + b) * p.k_cap;
    auto& ss = *reinterpret_cast<SampleScratch<kDecThreads>*>(
        reinterpret_cast<unsigned char*>(work) + sample_scratch_offset(V));
    // the draw's lead round normalizes and masks as it reads
    id = sample_top_p_k_block<kDecThreads, 2, 2>(work, V, p.top_p[b], n_iter, g, ss, prob);
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

// The matrix phases of a token layer (li) and the lm_head (li == L).
template <typename T>
__device__ Plan<T> tok_qkv_plan(const TokenParams<T>& p, int li) {
  const TokenLayer<T>& ly = p.layer[li];
  const int W = p.H * p.dh;
  return plan_of<T>(p.D, 3 * W, 1, ly.ln_attn, p.eps, Src<T>{ly.wq, &p.tm[li][0], 0},
                    Src<T>{ly.wk, &p.tm[li][1], 0},
                    Src<T>{ly.wv, &p.tm[li][2], 0}, W);
}

template <typename T>
__device__ Plan<T> tok_o_plan(const TokenParams<T>& p, int li) {
  return plan_of<T>(p.H * p.dh, p.D, 1, nullptr, 0.f, Src<T>{p.layer[li].wo, &p.tm[li][3], 0});
}

template <typename T>
__device__ Plan<T> tok_gu_plan(const TokenParams<T>& p, int li) {
  const TokenLayer<T>& ly = p.layer[li];
  return plan_of<T>(p.D, p.F, 2, ly.ln_mlp, p.eps, Src<T>{ly.wg, &p.tm[li][4], 0},
                    Src<T>{ly.wu, &p.tm[li][5], 0});
}

template <typename T>
__device__ Plan<T> tok_down_plan(const TokenParams<T>& p, int li) {
  return plan_of<T>(p.F, p.D, 1, nullptr, 0.f, Src<T>{p.layer[li].wd, &p.tm[li][6], 0});
}

template <typename T>
__device__ Plan<T> tok_lm_plan(const TokenParams<T>& p) {
  return plan_of<T>(p.D, p.V, 1, p.fnorm, p.eps, Src<T>{p.lm, &p.tm_lm, 0});
}

// The whole token row of event ev (its noise and its rows in the [E, ...]
// planes); p.x holds the step-0 input.  Every thread of every block calls
// it; it ends after the last sampling phase, without a grid barrier, with
// `after` (the next phase of the caller, or null) queued on the ring.
template <typename T>
__device__ void token_row_body(const TokenParams<T>& p, int ev, Tc<T>& tc, PhaseSync& sync,
                               float* rs, float* red, ArgmaxScratch<kDecThreads>& am,
                               const Plan<T>* after) {
  const int B = p.B, D = p.D, W = p.H * p.dh, F = p.F;
  auto residual = [&](int col, int b, const float* v) {
    T* o = p.x + static_cast<size_t>(b) * D + col;
    *o = from_f32<T>(to_f32(*o) + round_to<T>(v[0]));
  };
  if (!tc.primed) tc_begin(tc, tok_qkv_plan(p, 0), B);
  for (int j = 0; j < p.n_steps; ++j) {
    for (int li = 0; li < p.L; ++li) {
      // norm + q/k/v
      matmul<1>(
          tc, tok_qkv_plan(p, li), B, p.x, rs,
          [&](int col, int b, const float* v) {
            p.qkv[static_cast<size_t>(b) * 3 * W + col] = from_f32<T>(v[0]);
          });
      tc_begin(tc, tok_o_plan(p, li), B);
      sync.barrier();
      token_attention<T>(p, li, j);
      sync.barrier();
      // o-proj + residual
      matmul<1>(tc, tok_o_plan(p, li), B, p.attn, rs, residual);
      tc_begin(tc, tok_gu_plan(p, li), B);
      sync.barrier();
      // norm + gate/up + SiLU
      matmul<2>(
          tc, tok_gu_plan(p, li), B, p.x, rs,
          [&](int u, int b, const float* v) {
            const float g = round_to<T>(silu_f32(round_to<T>(v[0])));
            p.gated[static_cast<size_t>(b) * F + u] = from_f32<T>(g * round_to<T>(v[1]));
          });
      tc_begin(tc, tok_down_plan(p, li), B);
      sync.barrier();
      // down + residual
      matmul<1>(tc, tok_down_plan(p, li), B, p.gated, rs, residual);
      tc_begin(tc, li + 1 < p.L ? tok_qkv_plan(p, li + 1) : tok_lm_plan(p), B);
      sync.barrier();
    }
    // final norm + lm_head: logits in T, kept as f32
    matmul<1>(
        tc, tok_lm_plan(p), B, p.x, rs,
        [&](int col, int b, const float* v) {
          p.logits[static_cast<size_t>(b) * p.V + col] = round_to<T>(v[0]);
        });
    if (j + 1 < p.n_steps) {
      tc_begin(tc, tok_qkv_plan(p, 0), B);
    } else if (after != nullptr) {
      tc_begin(tc, *after, B);
    }
    sync.barrier();
    for (int b = blockIdx.x; b < B; b += gridDim.x)
      sample_row<T>(p, ev, j, b, tc.scratch(), am, red);
    if (j + 1 < p.n_steps) sync.barrier();
  }
}

// Fill p from the packed host arrays and advance the cursors.  ptrs: the
// pointers of TokenParams in declaration order up to `ended`, 9 per layer
// for kTokMaxLayers layers first (emb_net, ev_acc, ev_out and alive are
// left null), then the phase clock (or null); bf16: encodes the tensor maps
// of the first L layers and the lm_head.  ints: B, D, H, dh, F, V, L, n_steps, E, k_cap, eos_id,
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
  p.clock = static_cast<unsigned long long*>(next());
  p.emb_net = nullptr;
  p.ev_acc = nullptr;
  p.ev_out = nullptr;
  p.alive = nullptr;
  for (int* f : {&p.B, &p.D, &p.H, &p.dh, &p.F, &p.V, &p.L, &p.n_steps, &p.E, &p.k_cap,
                 &p.eos_id, &p.first_event_id, &p.greedy})
    *f = *ints++;
  p.eps = *floats++;
  p.scale = *floats++;
  const bool ok = p.L <= kTokMaxLayers && p.n_steps <= kTokMaxSteps &&
                  p.dh <= 32 * kTokMaxChunks && p.dh % 64 == 0 && p.B <= kMaxBatch &&
                  sample_scratch_fits(p.V);
  if (!ok) return false;
  if constexpr (kTensorCores<T>) {
    const int W = p.H * p.dh;
    for (int l = 0; l < p.L; ++l) {
      const TokenLayer<T>& ly = p.layer[l];
      const T* w[kTokMaps] = {ly.wq, ly.wk, ly.wv, ly.wo, ly.wg, ly.wu, ly.wd};
      const int rows[kTokMaps] = {W, W, W, p.D, p.F, p.F, p.D};
      const int ks[kTokMaps] = {p.D, p.D, p.D, W, p.D, p.D, p.F};
      for (int i = 0; i < kTokMaps; ++i)
        if (!make_rows_map(&p.tm[l][i], w[i], rows[i], ks[i])) return false;
    }
    if (!make_rows_map(&p.tm_lm, p.lm, p.V, p.D)) return false;
  }
  return true;
}

}  // namespace mm
