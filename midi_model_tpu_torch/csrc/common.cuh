// Shared helpers for the port's kernels: dtype conversion and warp reductions.
//
// Every C entry point in this directory launches on the caller's stream,
// allocates nothing, and returns cudaGetLastError() after its launch(es) so
// the Python wrapper can raise on a refused launch.
#pragma once

#include <algorithm>

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace mm {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(signed char x) { return static_cast<float>(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

inline int last_error() { return static_cast<int>(cudaGetLastError()); }

// Grid-wide barrier for a cooperative (all blocks co-resident) launch, on a
// zeroed global pair {count, generation}: the last block to arrive resets
// the count and bumps the generation, the others spin on the generation.
// Global-memory only, so it needs no relocatable device code.  The fences
// make every write before the barrier visible to every block after it.
// With `arrive`, each block also raises *arrive to the %globaltimer of its
// arrival (the phase clock: the last block's arrival ends the phase's work).
__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ void grid_barrier(unsigned int* bar,
                                             unsigned long long* arrive = nullptr) {
  __syncthreads();
  if (threadIdx.x == 0) {
    volatile unsigned int* gen = bar + 1;
    const unsigned int g = *gen;  // read before arriving: cannot move on yet
    if (arrive != nullptr) atomicMax(arrive, global_ns());
    __threadfence();
    if (atomicAdd(bar, 1u) == gridDim.x - 1) {
      atomicExch(bar, 0u);
      __threadfence();
      atomicAdd(bar + 1, 1u);
    } else {
      while (*gen == g) __nanosleep(20);
    }
    __threadfence();
  }
  __syncthreads();
}

// Launch `kernel` cooperatively with as many blocks of `threads` as fit on
// the card at once (at most `max_blocks`), after raising its dynamic shared
// memory limit to `smem`.  A cooperative launch fails rather than run a
// grid whose blocks are not all resident, so grid_barrier cannot deadlock;
// a card that holds fewer than `min_blocks` at once is refused.
template <typename Kernel>
int launch_cooperative(Kernel kernel, int threads, size_t smem, int max_blocks, void** args,
                       void* stream, int min_blocks = 1) {
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  int device = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&device)) != cudaSuccess) return static_cast<int>(e);
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess)
    return static_cast<int>(e);
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem)) !=
      cudaSuccess)
    return static_cast<int>(e);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int blocks = std::min(sms * per_sm, max_blocks);
  if (blocks < min_blocks) return static_cast<int>(cudaErrorInvalidConfiguration);
  e = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel), dim3(blocks),
                                  dim3(threads), args, smem,
                                  static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return static_cast<int>(e);
  return last_error();
}

}  // namespace mm
