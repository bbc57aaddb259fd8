// Building blocks of the whole-step decode kernels (token_loop.cu,
// fused_step.cu and event_loop.cu, through token_row.cuh and
// fused_step.cuh): phases of one cooperative grid, separated by
// mm::grid_barrier.
//
// gemv2 computes a [rows, K] x [K, N] product for a handful of activation
// rows against weights in torch's [out, in] layout, so one output column is
// one contiguous weight row.  Decode has few rows (the batch) and large
// weights, so bytes would bound an ideal kernel; this simple one is bound
// by latency (about 21 us per round of units on an H100, PERF.md).  Every
// warp of the grid takes a unit of two output columns, streams their two
// weight rows once (16-byte loads), and multiplies them against all rows of
// the activation tile staged in shared memory, keeping 2 x kRowTile f32
// sums in registers.  The activations are staged K-chunk by K-chunk, so
// any K fits.  CUDA cores, f32 accumulation, one rounding of the sum by the
// caller's epilogue: the plain versions' "matmul output in the weight
// dtype" rule.
#pragma once

#include "common.cuh"

namespace mm {

constexpr int kDecThreads = 256;
constexpr int kDecWarps = kDecThreads / 32;
constexpr int kRowTile = 32;   // activation rows per register tile
constexpr int kMaxBatch = 256; // rows the per-block norm scales can hold
constexpr size_t kGemvSmem = 64 * 1024;  // the staged activation tile

// Vec<T>::n: elements in one 16-byte load; chunk: K elements staged at once
// (activations are staged in T: every staged value is a T value).
template <typename T> struct Vec;
template <> struct Vec<float> {
  static constexpr int n = 4;
  static constexpr int chunk = 512;
};
template <> struct Vec<__nv_bfloat16> {
  static constexpr int n = 8;
  static constexpr int chunk = 1024;
};

// Weight vectors (read-only for the whole kernel: the read-only path).
__device__ __forceinline__ void load_vec(const float* p, float* out) {
  const float4 v = __ldg(reinterpret_cast<const float4*>(p));
  out[0] = v.x;
  out[1] = v.y;
  out[2] = v.z;
  out[3] = v.w;
}

__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float* out) {
  const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

// Round through T and back: the value a T tensor would hold.
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

// Eight consecutive elements of T (16-byte aligned for bf16, 32 for f32) as
// floats.  A plain load: activations are written by this kernel, so they
// must not go through the read-only (non-coherent) path.
__device__ __forceinline__ void load8(const float* p, float* out) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  out[0] = a.x, out[1] = a.y, out[2] = a.z, out[3] = a.w;
  out[4] = b.x, out[5] = b.y, out[6] = b.z, out[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* out) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

// Eight int8 pool values (8-byte aligned) as floats, each exact.
__device__ __forceinline__ void load8(const signed char* p, float* out) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const signed char* c = reinterpret_cast<const signed char*>(&raw);
#pragma unroll
  for (int i = 0; i < 8; ++i) out[i] = static_cast<float>(c[i]);
}

// The staged tile: 8 values of T at p, from or to floats.
__device__ __forceinline__ void store8(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  *reinterpret_cast<float4*>(p + 4) = make_float4(v[4], v[5], v[6], v[7]);
}

__device__ __forceinline__ void store8(__nv_bfloat16* p, const float* v) {
  uint4 raw;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = raw;
}

// Vec<T>::n staged values at p as floats (one 16-byte shared-memory load).
__device__ __forceinline__ void load_staged(const float* p, float* out) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  out[0] = x.x, out[1] = x.y, out[2] = x.z, out[3] = x.w;
}

__device__ __forceinline__ void load_staged(const __nv_bfloat16* p, float* out) {
  load8(p, out);
}

// For every unit u < n_units (spread over all warps of the grid) and row
// b < rows: acc_c = sum_k act(b, k) * row(u, c)[k] for c = 0, 1, then
// epi(u, b, acc0, acc1), row b on lane b of the unit's warp.  row(u, c) ==
// nullptr is a column that does not exist (its sum is 0).  load(b, k, out)
// writes act(b, k .. k+7), values of T.  K % 8 == 0 and 16-byte aligned
// rows (the wrappers check).  Every thread of every block calls it (it
// holds block barriers); smem is kGemvSmem of shared memory.
//
// Latency, not bandwidth, is what a decode-sized product has to hide: the
// staging issues its 16-byte loads four at a time before storing any, and
// each lane reads 16 contiguous bytes of the staged tile (no bank
// conflicts).  The loops over groups and k stay loops: the kernels hold one
// copy of this body per phase, and unrolled copies overflow the instruction
// cache.
template <typename T, class RowFn, class LoadFn, class EpiFn>
__device__ void gemv2(int rows, int K, int n_units, RowFn row, LoadFn load, EpiFn epi,
                      void* smem) {
  constexpr int V = Vec<T>::n;
  constexpr int kChunk = Vec<T>::chunk;
  constexpr int kStage = kRowTile * kChunk / 8 / kDecThreads;  // 8-vectors per thread
  static_assert(kStage % 4 == 0, "staging runs in groups of four loads");
  static_assert(sizeof(T) * kRowTile * kChunk <= kGemvSmem, "staged tile too large");
  T* xs = static_cast<T*>(smem);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int grid_warps = gridDim.x * kDecWarps;
  const int block_first = blockIdx.x * kDecWarps;
  for (int r0 = 0; r0 < rows; r0 += kRowTile) {
    const int rt = min(kRowTile, rows - r0);
    for (int u0 = 0; u0 + block_first < n_units; u0 += grid_warps) {  // block-uniform
      const int u = u0 + block_first + warp;
      const bool live = u < n_units;
      const T* w0 = live ? row(u, 0) : nullptr;
      const T* w1 = live ? row(u, 1) : nullptr;
      float acc0[kRowTile], acc1[kRowTile];
#pragma unroll
      for (int b = 0; b < kRowTile; ++b) acc0[b] = acc1[b] = 0.f;
      for (int k0 = 0; k0 < K; k0 += kChunk) {
        const int kv = min(kChunk, K - k0) / 8;  // 8-vectors per row in this chunk
        __syncthreads();  // the previous chunk is consumed
#pragma unroll 1
        for (int g = 0; g < kStage; g += 4) {
          float v[4][8];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int e = (g + i) * kDecThreads + threadIdx.x;
            if (e < rt * kv) load(r0 + e / kv, k0 + (e % kv) * 8, v[i]);
          }
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int e = (g + i) * kDecThreads + threadIdx.x;
            if (e < rt * kv) store8(xs + (e / kv) * kChunk + (e % kv) * 8, v[i]);
          }
        }
        __syncthreads();
        if (!live) continue;
        const int kc = kv * 8;
        // a loop, not unrolled: the body (all rows of the tile) is already
        // long, and the instruction cache has to hold every phase's copy
#pragma unroll 1
        for (int k = lane * V; k < kc; k += 32 * V) {
          float a[V] = {}, c[V] = {};
          if (w0) load_vec(w0 + k0 + k, a);
          if (w1) load_vec(w1 + k0 + k, c);
#pragma unroll
          for (int b = 0; b < kRowTile; ++b) {
            if (b < rt) {
              float x[V];
              load_staged(xs + b * kChunk + k, x);
#pragma unroll
              for (int i = 0; i < V; ++i) {
                acc0[b] += x[i] * a[i];
                acc1[b] += x[i] * c[i];
              }
            }
          }
        }
      }
      if (live) {
        // lane b keeps row b's sums, so the epilogues run side by side
        float mine0 = 0.f, mine1 = 0.f;
#pragma unroll
        for (int b = 0; b < kRowTile; ++b) {
          const float s0 = warp_sum(acc0[b]);
          const float s1 = warp_sum(acc1[b]);
          if (lane == b) {
            mine0 = s0;
            mine1 = s1;
          }
        }
        if (lane < rt) epi(u, r0 + lane, mine0, mine1);
      }
    }
  }
}

// rs[b] = rsqrt(mean(x[b]^2) + eps) for the rows of x [rows, D] (one warp per
// row, 16-byte loads); the caller's next block barrier publishes it.
template <typename T>
__device__ void row_scales(const T* __restrict__ x, int rows, int D, float eps, float* rs) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int b = warp; b < rows; b += kDecWarps) {
    const T* xr = x + static_cast<size_t>(b) * D;
    float s = 0.f;
#pragma unroll 4
    for (int k = lane * 8; k < D; k += 256) {
      float v[8];
      load8(xr + k, v);
#pragma unroll
      for (int i = 0; i < 8; ++i) s += v[i] * v[i];
    }
    s = warp_sum(s);
    if (lane == 0) rs[b] = rsqrtf(s / static_cast<float>(D) + eps);
  }
}

// RMSNorm of act(b, k .. k+7) with the plain version's rounding points:
// T(x * rs), then the weight multiply in T.
template <typename T>
__device__ __forceinline__ void norm8(const T* x, const T* w, const float* rs, int D, int b,
                                      int k, float* out) {
  float xv[8], wv[8];
  load8(x + static_cast<size_t>(b) * D + k, xv);
  load8(w + k, wv);
#pragma unroll
  for (int i = 0; i < 8; ++i) out[i] = round_to<T>(wv[i] * round_to<T>(xv[i] * rs[b]));
}

// Rotate-half RoPE of one head held by a warp: lane owns dims lane + 32c,
// c < C; the partner of chunk c is c +- C/2.  f32 math without contraction,
// rounded to T (the plain version's (x*cos + rot(x)*sin).to(dtype)).
template <typename T, int MAXC>
__device__ __forceinline__ void rope_head(const T* __restrict__ src, const float* __restrict__ cs,
                                          const float* __restrict__ sn, int C, float* out) {
  const int lane = threadIdx.x & 31;
  float x[MAXC];
#pragma unroll
  for (int c = 0; c < MAXC; ++c) x[c] = c < C ? to_f32(src[lane + 32 * c]) : 0.f;
  const int half = C / 2;
#pragma unroll
  for (int c = 0; c < MAXC; ++c) {
    if (c < C) {
      const int d = lane + 32 * c;
      float rot = 0.f;
#pragma unroll
      for (int o = 0; o < MAXC; ++o) {  // static partner index keeps x in registers
        if (c < half && o == c + half) rot = -x[o];
        if (c >= half && o == c - half) rot = x[o];
      }
      out[c] = round_to<T>(__fadd_rn(__fmul_rn(x[c], cs[d]), __fmul_rn(rot, sn[d])));
    }
  }
}

__device__ __forceinline__ float silu_f32(float g) { return g / (1.f + expf(-g)); }

}  // namespace mm
