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

// A cooperative launch's shape: `blocks` in all, in clusters of `cluster`.
struct LaunchShape {
  int cluster, blocks;
};

// The largest cooperative grid of `kernel` (blocks of `threads`, `smem`
// bytes of dynamic shared memory, at most `max_blocks`) in clusters of
// `cluster` blocks, at most the blocks that fit on the card at once
// (cudaOccupancyMaxActiveClusters: clusters do not span GPCs, so the
// grid may be smaller than one block an SM).  Where the card holds fewer
// than `min_blocks` so, clusters of 1 (a card that holds fewer than
// `min_blocks` at all is refused).
template <typename Kernel>
cudaError_t cooperative_shape(Kernel kernel, int threads, size_t smem, int max_blocks,
                              int cluster, int min_blocks, LaunchShape* shape) {
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  int device = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&device)) != cudaSuccess) return e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess)
    return e;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem)) !=
      cudaSuccess)
    return e;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int blocks = std::min(sms * per_sm, max_blocks);
  if (cluster > 1) {
    cudaLaunchAttribute attr;
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = cluster;
    attr.val.clusterDim.y = attr.val.clusterDim.z = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(blocks / cluster * cluster);
    cfg.blockDim = dim3(threads);
    cfg.dynamicSmemBytes = smem;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
    int clusters = 0;
    if (cudaOccupancyMaxActiveClusters(&clusters, reinterpret_cast<const void*>(kernel), &cfg) ==
        cudaSuccess) {
      const int clustered = std::min(clusters, blocks / cluster) * cluster;
      if (clustered >= min_blocks) {
        *shape = {cluster, clustered};
        return cudaSuccess;
      }
    }
    cudaGetLastError();  // a refused query leaves clusters of 1
  }
  if (blocks < min_blocks) return cudaErrorInvalidConfiguration;
  *shape = {1, blocks};
  return cudaSuccess;
}

// Launch `kernel` cooperatively on cooperative_shape's grid, after raising
// its dynamic shared memory limit to `smem`.  A cooperative launch fails
// rather than run a grid whose blocks are not all resident, so grid_barrier
// cannot deadlock.  A clustered launch that CUDA refuses runs in clusters
// of 1.  launched[0..1] = the cluster size and the blocks launched with.
template <typename Kernel>
int launch_cooperative(Kernel kernel, int threads, size_t smem, int max_blocks, int cluster,
                       void** args, void* stream, int* launched, int min_blocks = 1) {
  LaunchShape shape;
  cudaError_t e = cooperative_shape(kernel, threads, smem, max_blocks, cluster, min_blocks, &shape);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (shape.cluster > 1) {
    cudaLaunchAttribute attrs[2];
    attrs[0].id = cudaLaunchAttributeClusterDimension;
    attrs[0].val.clusterDim.x = shape.cluster;
    attrs[0].val.clusterDim.y = attrs[0].val.clusterDim.z = 1;
    attrs[1].id = cudaLaunchAttributeCooperative;
    attrs[1].val.cooperative = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(shape.blocks);
    cfg.blockDim = dim3(threads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = static_cast<cudaStream_t>(stream);
    cfg.attrs = attrs;
    cfg.numAttrs = 2;
    if (cudaLaunchKernelExC(&cfg, reinterpret_cast<const void*>(kernel), args) != cudaSuccess) {
      cudaGetLastError();  // refused: clusters of 1
      e = cooperative_shape(kernel, threads, smem, max_blocks, 1, min_blocks, &shape);
      if (e != cudaSuccess) return static_cast<int>(e);
    }
  }
  if (shape.cluster == 1)
    e = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel), dim3(shape.blocks),
                                    dim3(threads), args, smem, static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return static_cast<int>(e);
  launched[0] = shape.cluster;
  launched[1] = shape.blocks;
  return last_error();
}

}  // namespace mm
