// The elementwise work between a hybrid layer's products, one launch each:
// the residual add with its RMSNorm, and the SwiGLU product.
//
// New for the hybrid event net (Granite 4.0-H); no TPU kernel of the JAX
// package computes them.  The plain versions are in ops/hybrid_norm.py
// (add_rms_norm_reference, and swiglu's CPU branch): these kernels give the
// same bf16 roundings, and differ only in the order of the norm's f32 sum
// and in the last bits of an f32 exp.
//
// What they compute (bf16 in and out, f32 inside):
//   add_rms_norm: x' = x + bf16(y * scale) (rounded, as x + y * scale in
//     bf16), or x' = x without y; h = w * bf16(x' * rsqrt(mean(x'^2) + eps)),
//     per row of D;
//   swiglu: out = bf16(bf16(silu(gate)) * up), gate and up the halves of
//     each row of gu [B, 2F].
//
// What bounds them: launch latency.  A decode step's rows are 32 x 2,048;
// in place of the ~9 and 2 PyTorch operations each replaces, a step of the
// 40-layer stack launches ~120 of these instead of ~700 operations.
//
// Design: add_rms_norm takes one block of 256 threads per row, 8 elements
// (16 bytes) a thread a pass; swiglu one thread per 8 outputs.
#include <cstdint>

#include "common.cuh"
#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;
constexpr int kThreads = 256;

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

__global__ void __launch_bounds__(kThreads) add_rms_norm_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ y, bf16* __restrict__ x_out,
    bf16* __restrict__ h, const bf16* __restrict__ w, int D, float scale, float eps) {
  extern __shared__ float row[];  // x' in f32 (exactly its bf16 values)
  __shared__ float s_warp[kThreads / 32];
  const size_t base = static_cast<size_t>(blockIdx.x) * D;
  float sq = 0.f;
  for (int i = threadIdx.x * 8; i < D; i += kThreads * 8) {
    float v[8];
    mm::sm90::unpack8(*reinterpret_cast<const uint4*>(x + base + i), v);
    if (y != nullptr) {
      float r[8];
      mm::sm90::unpack8(*reinterpret_cast<const uint4*>(y + base + i), r);
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] = round_bf16(v[e] + round_bf16(r[e] * scale));
      *reinterpret_cast<uint4*>(x_out + base + i) = mm::sm90::pack8(v);
    }
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      row[i + e] = v[e];
      sq = fmaf(v[e], v[e], sq);
    }
  }
  sq = mm::warp_sum(sq);
  if ((threadIdx.x & 31) == 0) s_warp[threadIdx.x >> 5] = sq;
  __syncthreads();
  float total = 0.f;
#pragma unroll
  for (int k = 0; k < kThreads / 32; ++k) total += s_warp[k];
  const float r = rsqrtf(total / static_cast<float>(D) + eps);
  for (int i = threadIdx.x * 8; i < D; i += kThreads * 8) {
    float ww[8], o[8];
    mm::sm90::unpack8(*reinterpret_cast<const uint4*>(w + i), ww);
#pragma unroll
    for (int e = 0; e < 8; ++e) o[e] = ww[e] * round_bf16(row[i + e] * r);
    *reinterpret_cast<uint4*>(h + base + i) = mm::sm90::pack8(o);
  }
}

__device__ __forceinline__ float silu(float x) { return x / (1.f + __expf(-x)); }

__global__ void __launch_bounds__(kThreads) swiglu_kernel(const bf16* __restrict__ gu,
                                                         bf16* __restrict__ out, int B, int F) {
  const int per_row = F / 8;
  const int idx = blockIdx.x * kThreads + threadIdx.x;
  if (idx >= B * per_row) return;
  const int b = idx / per_row, i = (idx % per_row) * 8;
  float g[8], u[8], o[8];
  mm::sm90::unpack8(*reinterpret_cast<const uint4*>(gu + static_cast<size_t>(b) * 2 * F + i), g);
  mm::sm90::unpack8(
      *reinterpret_cast<const uint4*>(gu + static_cast<size_t>(b) * 2 * F + F + i), u);
#pragma unroll
  for (int e = 0; e < 8; ++e) o[e] = round_bf16(silu(g[e])) * u[e];
  *reinterpret_cast<uint4*>(out + static_cast<size_t>(b) * F + i) = mm::sm90::pack8(o);
}

}  // namespace

// x, y (or null), x_out (unwritten without y), h [B, D] and w [D], bf16,
// contiguous, D a multiple of 8.
extern "C" int mm_add_rms_norm_bf16(const void* x, const void* y, void* x_out, void* h,
                                    const void* w, int B, int D, float scale, float eps,
                                    void* stream) {
  if (B < 1 || D % 8) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(float) * D;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        add_rms_norm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  add_rms_norm_kernel<<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(y), static_cast<bf16*>(x_out),
      static_cast<bf16*>(h), static_cast<const bf16*>(w), D, scale, eps);
  return mm::last_error();
}

// gu [B, 2F] and out [B, F], bf16, contiguous, F a multiple of 8.
extern "C" int mm_swiglu_bf16(const void* gu, void* out, int B, int F, void* stream) {
  if (B < 1 || F % 8) return static_cast<int>(cudaErrorInvalidValue);
  const int n = B * (F / 8);
  swiglu_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(gu), static_cast<bf16*>(out), B, F);
  return mm::last_error();
}
