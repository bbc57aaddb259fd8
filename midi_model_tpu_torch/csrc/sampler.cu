// Top-p / top-k categorical sampler by iterative max extraction.
//
// Replaces: midi_model_tpu/ops/sampler.py, _sampler_kernel (Pallas TPU).
//
// What it computes, per row of probs [B, V] (need not be normalized):
// extract the current maximum (ties broken by the LOWEST index, like a stable
// descending sort); the j-th extracted element is kept iff its exclusive
// cumulative mass texcl <= top_p and j < top_k; the draw is a Gumbel-argmax
// over the kept elements, score = log(p) + gumbel[j], updated only on a
// strict '>' so the first of equal scores wins.  The noise [B, k_cap] comes
// from the caller, so the kernel is deterministic given its inputs.
//
// What bounds it on an H100: nothing big.  At [32, 3406] one pass per row
// reads 13.6 KB of shared memory, and a row runs at most min(top_k, k_cap)
// passes, usually a handful (grammar-masked rows pass top_p fast).  The cost
// is latency: each pass is a block-wide (max, index) reduction with two
// barriers.
//
// Design: one block per row; the row's probabilities are copied once into
// shared memory (ragged tail masked by the strided loop), each pass reduces
// per thread, then per warp with shuffles, then across warps in shared
// memory.  The extraction loop lives in sampler.cuh, shared with the
// token-row kernel (token_loop.cu), as the JAX package's token_loop._sample
// repeats ops/sampler.py's loop.  A row stops as soon as its own texcl
// passes top_p.  The TPU kernel stops only once EVERY row has passed;
// per-row stopping gives the same ids
// because texcl only grows, so a row past top_p can keep nothing more.  Edge
// cases match the TPU kernel: remaining mass 0 gives log 0 = -inf, which
// never beats the initial -inf, so such a row returns index 0.
#include "sampler.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
sampler_kernel(const float* __restrict__ probs, const float* __restrict__ top_p,
               const int* __restrict__ top_k, const float* __restrict__ gumbel,
               int* __restrict__ out, int V, int k_cap) {
  extern __shared__ float work[];  // [V]
  __shared__ mm::ArgmaxScratch<kThreads> scratch;

  const int row = blockIdx.x;
  const float* p = probs + static_cast<size_t>(row) * V;
  for (int i = threadIdx.x; i < V; i += kThreads) work[i] = p[i];
  const int n_iter = min(top_k[row], k_cap);
  __syncthreads();
  const int id = mm::sample_top_p_k_block<kThreads>(
      work, V, top_p[row], n_iter, gumbel + static_cast<size_t>(row) * k_cap, scratch);
  if (threadIdx.x == 0) out[row] = id;
}

}  // namespace

extern "C" int mm_sampler(const float* probs, const float* top_p, const int* top_k,
                          const float* gumbel, int* out, int B, int V, int k_cap,
                          void* stream) {
  const size_t smem = static_cast<size_t>(V) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        sampler_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  sampler_kernel<<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      probs, top_p, top_k, gumbel, out, V, k_cap);
  return mm::last_error();
}

extern "C" const char* mm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
