// Top-p / top-k categorical sampler: one block a row, one selection a draw.
//
// Replaces: midi_model_tpu/ops/sampler.py, _sampler_kernel (Pallas TPU).
//
// What it computes, per row of probs [B, V] (need not be normalized): on a
// stable descending sort (ties by the lowest index), rank j < min(top_k,
// k_cap) is kept iff its exclusive running mass texcl_j <= top_p; the draw
// is a Gumbel-argmax over the kept ranks, score = log(p) + gumbel[j],
// the first of equal scores winning.  The noise [B, k_cap] comes from the
// caller, so the kernel is deterministic given its inputs.
//
// What bounds it on an H100: nothing big.  At [32, 3406] a row is 13.6 KB,
// read once from memory into shared memory; the byte bound is ~0.14 us.
// The cost is latency: the passes over the row in shared memory and the
// block barriers between them.
//
// Design: one block per row, sampler.cuh's sample_top_p_k_block: a lead
// round (one pass that also copies the row into shared memory, one barrier)
// that settles peaked rows, else a selection of the ordered top ranks by
// digit rounds on the keys (a pass and two barriers each, one or two on the
// rows timed), a compaction, a rank by counting and one sequential texcl --
// instead of one block-wide max extraction (a pass and three barriers) per
// rank.  The routine is shared with the fused decode kernels' sample phase
// (token_row.cuh).  A row stops as soon as its own texcl passes top_p; the
// TPU kernel stops only once EVERY row has passed, which gives the same ids
// because texcl only grows.  Edge cases match the TPU kernel: no positive
// mass, or top_k <= 0, gives index 0.
#include "sampler.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
sampler_kernel(const float* __restrict__ probs, const float* __restrict__ top_p,
               const int* __restrict__ top_k, const float* __restrict__ gumbel,
               int* __restrict__ out, int V, int k_cap) {
  extern __shared__ float work[];  // [V]
  __shared__ mm::SampleScratch<kThreads> scratch;

  const int row = blockIdx.x;
  const float* p = probs + static_cast<size_t>(row) * V;
  const int n_iter = min(top_k[row], k_cap);
  // the lead round reads the row from memory (16 loads in flight a thread)
  // and keeps it in work
  const int id = mm::sample_top_p_k_block<kThreads, 16, 8>(
      work, V, top_p[row], n_iter, gumbel + static_cast<size_t>(row) * k_cap, scratch,
      [&](int i) { return p[i]; });
  if (threadIdx.x == 0) out[row] = id;
}

}  // namespace

extern "C" int mm_sampler(const float* probs, const float* top_p, const int* top_k,
                          const float* gumbel, int* out, int B, int V, int k_cap,
                          void* stream) {
  const size_t smem = static_cast<size_t>(V) * sizeof(float);
  // above 48 KB of static and dynamic shared memory only by the attribute
  if (smem + sizeof(mm::SampleScratch<kThreads>) > 48 * 1024) {
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
