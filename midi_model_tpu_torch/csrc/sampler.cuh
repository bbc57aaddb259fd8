// Block-wide max extraction and the top-p / top-k draw, shared by the
// standalone sampler (sampler.cu) and the token-row kernel (token_loop.cu).
//
// Semantics (the reference sampler's, on a stable descending sort): extract
// the current maximum, ties broken by the LOWEST index at every level
// (thread, warp shuffle, block); the j-th extracted element is kept iff its
// exclusive cumulative mass texcl <= top_p and j < top_k; the draw is a
// Gumbel-argmax over the kept elements, score = log(p) + gumbel[j], updated
// only on a strict '>' so the first of equal scores wins.
#pragma once

#include "common.cuh"

namespace mm {

struct MaxIdx {
  float m;
  int i;
};

// Larger value wins; equal values: lower index (symmetric, so a butterfly
// shuffle leaves every lane with the same winner).
__device__ __forceinline__ MaxIdx better(MaxIdx a, MaxIdx b) {
  return (b.m > a.m || (b.m == a.m && b.i < a.i)) ? b : a;
}

__device__ __forceinline__ MaxIdx warp_best(MaxIdx t) {
  for (int off = 16; off > 0; off >>= 1) {
    MaxIdx o{__shfl_xor_sync(0xffffffffu, t.m, off), __shfl_xor_sync(0xffffffffu, t.i, off)};
    t = better(t, o);
  }
  return t;
}

// Shared-memory scratch of one block for the reductions below.
template <int kThreads>
struct ArgmaxScratch {
  MaxIdx partial[kThreads / 32];
  MaxIdx winner;
};

// The first maximum of work[0, V) over the whole block (kThreads threads).
// An all-zero row returns index 0; every thread gets the same result.
template <int kThreads>
__device__ MaxIdx block_first_max(const float* work, int V, ArgmaxScratch<kThreads>& s) {
  constexpr int kWarps = kThreads / 32;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  MaxIdx t{-CUDART_INF_F, V};
  for (int i = threadIdx.x; i < V; i += kThreads) {
    const float x = work[i];
    if (x > t.m) {  // strided indices grow, so '>' keeps the lowest
      t.m = x;
      t.i = i;
    }
  }
  t = warp_best(t);
  if (lane == 0) s.partial[warp] = t;
  __syncthreads();
  if (warp == 0) {
    MaxIdx w = lane < kWarps ? s.partial[lane] : MaxIdx{-CUDART_INF_F, V};
    w = warp_best(w);
    if (lane == 0) s.winner = w;
  }
  __syncthreads();
  const MaxIdx r = s.winner;
  __syncthreads();  // the scratch may be reused right away
  return r;
}

// One top-p / top-k draw from work[0, V) (need not be normalized; the
// block's shared copy, zeroed entry by entry as they are extracted) with
// noise g[0, n_iter).  n_iter = min(top_k, k_cap).  A row stops as soon as
// its own texcl passes top_p: texcl only grows, so nothing later is kept.
// Remaining mass 0 gives log 0 = -inf, which never beats the initial -inf,
// so such a row returns index 0.  Every thread carries the same loop state,
// so the loop condition is uniform across the block and the barriers are safe.
template <int kThreads>
__device__ int sample_top_p_k_block(float* work, int V, float top_p, int n_iter,
                                    const float* __restrict__ g, ArgmaxScratch<kThreads>& s) {
  float best = -CUDART_INF_F;
  int bidx = 0;
  float texcl = 0.f;
  // each extraction's noise is loaded one extraction ahead, so its latency
  // hides behind the extraction before it
  float gj = n_iter > 0 ? g[0] : 0.f;
  for (int j = 0; j < n_iter && texcl <= top_p; ++j) {
    const float g_next = j + 1 < n_iter ? g[j + 1] : 0.f;
    const MaxIdx r = block_first_max<kThreads>(work, V, s);
    // kept: texcl <= top_p and j < top_k hold by the loop condition
    const float score = logf(r.m) + gj;
    gj = g_next;
    if (score > best) {
      best = score;
      bidx = r.i;
    }
    if (threadIdx.x == 0 && r.i < V) work[r.i] = 0.f;
    texcl += r.m;
    __syncthreads();
  }
  return bidx;
}

}  // namespace mm
