// The Mamba-2 (SSD) scan of one admission bucket: prompts of their own
// lengths, from a zero state, in chunks, with the products inside a chunk
// on the tensor cores.
//
// New for the hybrid event net (Granite 4.0-H); no TPU kernel of the JAX
// package computes it.  The plain version is ops/ssm.py ssm_scan_reference.
//
// What it computes, per prompt g of length L and head h (P = 64, N = 128;
// group h / (H / G) gives B and C), with a_t = dt_t A and rows t >= L
// counted as dt = 0, x = B = C = 0:
//   y_i  = sum_{j <= i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j
//          + exp(cum_i) C_i . state_prev + D x_i        (within a chunk,
//          cum the chunk's inclusive prefix sum of a)
//   state = exp(cum_last) state_prev + sum_j exp(cum_last - cum_j) dt_j x_j B_j^T
// y [G, S, H, P] f32 (0 at rows t >= L) and each prompt's state after its
// last chunk [G, H, P, N] f32: rows past L change nothing, so it is the
// state at row L - 1.  Rounded to bf16 before a product, as the plain
// version: the decayed, dt-weighted scores, the dt-weighted x of the state
// update, and the previous state that the rows read.
//
// What bounds it on an H100: the products (a chunk of Q rows costs
// ~Q^2 (N + H P) multiply-adds a prompt against ~Q H (P + 2N) elements
// read), at the small batch of one admission.
//
// Design: one block per (prompt, head), 256 threads, chunks in order; only
// the chunks up to the prompt's length run.  A chunk's C and B rows [Q, N]
// and x transposed [P, Q] come into shared memory as bf16 (thread t loads
// row t), dt and the prefix sums beside them, and the previous state as
// bf16.  Products are mma.sync m16n8k16 (bf16 in, f32 accumulate), whose
// accumulator fragments have known (row, column) positions: the scores
// C_i . B_j of a 16 x 16 (i, j) tile are masked and scaled in registers and
// packed straight into the A fragment of the product with x.  Warp w takes
// row tiles w and 15 - w, so every warp has the same number of (i, j) tiles
// under the diagonal.  The state lives in registers across chunks: warp w
// owns its rows 16 (w % 4) .. + 16 and columns 64 (w / 4) .. + 64.
#include <cstdint>

#include "common.cuh"
#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;
using mm::sm90::mma_16816;
using mm::sm90::pack_bf16;

constexpr int kP = 64;
constexpr int kN = 128;
constexpr int kQ = 256;  // the largest chunk
constexpr int kThreads = 256;
constexpr int kCS = kN + 8;   // C and B rows in shared memory (bf16), padded
constexpr int kXS = kQ + 8;   // x^T rows
constexpr int kHS = kN + 8;   // state rows

struct ScanArgs {
  const bf16 *x, *b, *c;
  const float *dt, *a, *d;
  const int* lengths;
  float *y, *state;
  int S, H, G;
  long long x_row, bc_row, bc_prompt, x_prompt;
  int chunk;
};

constexpr size_t kSmem = sizeof(bf16) * (2 * kQ * kCS + kP * kXS + kP * kHS) +
                         sizeof(float) * (3 * kQ + 8);

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pair(bf16 lo, bf16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

__global__ void __launch_bounds__(kThreads, 1) ssm_scan_kernel(ScanArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* cs = reinterpret_cast<bf16*>(smem);  // [Q][kCS]
  bf16* bs = cs + kQ * kCS;                  // [Q][kCS]
  bf16* xt = bs + kQ * kCS;                  // [P][kXS]
  bf16* hs = xt + kP * kXS;                  // [P][kHS]
  float* cum = reinterpret_cast<float*>(hs + kP * kHS);  // [Q]
  float* dts = cum + kQ;                     // [Q]
  float* wend = dts + kQ;                    // [Q]: exp(cum_last - cum_j) dt_j
  float* warp_tot = wend + kQ;               // [8]

  const int g = blockIdx.x / a.H, h = blockIdx.x % a.H;
  const int grp = h / (a.H / a.G);
  const int t = threadIdx.x, lane = t & 31, w = t >> 5;
  const int gq = lane >> 2, tq = lane & 3;  // fragment row / column group
  const int Q = a.chunk, n_tiles = Q / 16;
  const int L = a.lengths[g];
  const int n_chunks = (min(L, a.S) + Q - 1) / Q;
  const float A = a.a[h], Dh = a.d[h];

  // the state: rows p0 .. p0 + 15, columns n0 + 8 k .. (k = 0 .. 7)
  const int p0 = 16 * (w & 3), n0 = 64 * (w >> 2);
  float st[8][4];
#pragma unroll
  for (int k = 0; k < 8; ++k)
#pragma unroll
    for (int e = 0; e < 4; ++e) st[k][e] = 0.f;

  for (int ch = 0; ch < n_chunks; ++ch) {
    const int r0 = ch * Q;
    // ---- load the chunk: thread t takes row t -------------------------------
    if (t < Q) {
      const int r = r0 + t;
      const bool valid = r < L && r < a.S;
      const bf16* xr = a.x + g * a.x_prompt + static_cast<long long>(r) * a.x_row + h * kP;
      const bf16* br = a.b + g * a.bc_prompt + static_cast<long long>(r) * a.bc_row + grp * kN;
      const bf16* cr = a.c + g * a.bc_prompt + static_cast<long long>(r) * a.bc_row + grp * kN;
      const uint4 zero = make_uint4(0, 0, 0, 0);
#pragma unroll 4
      for (int v = 0; v < kN / 8; ++v) {
        reinterpret_cast<uint4*>(bs + t * kCS)[v] =
            valid ? reinterpret_cast<const uint4*>(br)[v] : zero;
        reinterpret_cast<uint4*>(cs + t * kCS)[v] =
            valid ? reinterpret_cast<const uint4*>(cr)[v] : zero;
      }
#pragma unroll
      for (int v = 0; v < kP / 8; ++v) {
        uint4 u = valid ? reinterpret_cast<const uint4*>(xr)[v] : zero;
        const bf16* e8 = reinterpret_cast<const bf16*>(&u);
#pragma unroll
        for (int e = 0; e < 8; ++e) xt[(8 * v + e) * kXS + t] = e8[e];
      }
      dts[t] = valid ? a.dt[(static_cast<long long>(g) * a.S + r) * a.H + h] : 0.f;
    }
    // the previous state, bf16, for the rows' reads
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int col = n0 + 8 * k + 2 * tq;
      *reinterpret_cast<uint32_t*>(hs + (p0 + gq) * kHS + col) = pack_bf16(st[k][0], st[k][1]);
      *reinterpret_cast<uint32_t*>(hs + (p0 + gq + 8) * kHS + col) =
          pack_bf16(st[k][2], st[k][3]);
    }
    __syncthreads();
    // ---- prefix sums of a = dt A over the chunk --------------------------------
    {
      float v = t < Q ? dts[t] * A : 0.f;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float u = __shfl_up_sync(0xffffffffu, v, off);
        if (lane >= off) v += u;
      }
      if (lane == 31) warp_tot[w] = v;
      __syncthreads();
      for (int i = 0; i < w; ++i) v += warp_tot[i];
      if (t < Q) cum[t] = v;
      __syncthreads();
      if (t < Q) wend[t] = expf(cum[Q - 1] - cum[t]) * dts[t];
    }
    __syncthreads();

    // ---- y for this warp's row tiles -------------------------------------------
#pragma unroll 1
    for (int which = 0; which < 2; ++which) {
      const int rt = which == 0 ? w : 15 - w;
      if (rt >= n_tiles || (which == 1 && rt == w)) continue;
      const int i0 = 16 * rt;
      // C's A fragments over k = N (8 steps of 16)
      uint32_t cf[8][4];
#pragma unroll
      for (int ks = 0; ks < 8; ++ks) {
        const bf16* c0 = cs + (i0 + gq) * kCS + 16 * ks + 2 * tq;
        const bf16* c8 = c0 + 8 * kCS;
        cf[ks][0] = ld32(c0);
        cf[ks][1] = ld32(c8);
        cf[ks][2] = ld32(c0 + 8);
        cf[ks][3] = ld32(c8 + 8);
      }
      float y[8][4];
#pragma unroll
      for (int pt = 0; pt < 8; ++pt)
#pragma unroll
        for (int e = 0; e < 4; ++e) y[pt][e] = 0.f;
      if (ch > 0) {  // the previous state read by each row, then its decay
#pragma unroll
        for (int pt = 0; pt < 8; ++pt)
#pragma unroll
          for (int ks = 0; ks < 8; ++ks) {
            const bf16* hp = hs + (8 * pt + gq) * kHS + 16 * ks + 2 * tq;
            mma_16816(y[pt], cf[ks], ld32(hp), ld32(hp + 8));
          }
        const float e_lo = expf(cum[i0 + gq]), e_hi = expf(cum[i0 + gq + 8]);
#pragma unroll
        for (int pt = 0; pt < 8; ++pt) {
          y[pt][0] *= e_lo, y[pt][1] *= e_lo;
          y[pt][2] *= e_hi, y[pt][3] *= e_hi;
        }
      }
      const float cum_lo = cum[i0 + gq], cum_hi = cum[i0 + gq + 8];
#pragma unroll 1
      for (int jb = 0; jb <= rt; ++jb) {
        const int j0 = 16 * jb;
        float s[2][4];
#pragma unroll
        for (int jt = 0; jt < 2; ++jt) {
#pragma unroll
          for (int e = 0; e < 4; ++e) s[jt][e] = 0.f;
#pragma unroll
          for (int ks = 0; ks < 8; ++ks) {
            const bf16* bp = bs + (j0 + 8 * jt + gq) * kCS + 16 * ks + 2 * tq;
            mma_16816(s[jt], cf[ks], ld32(bp), ld32(bp + 8));
          }
        }
        uint32_t pf[4];
#pragma unroll
        for (int jt = 0; jt < 2; ++jt) {
          float v[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = i0 + gq + (e >= 2 ? 8 : 0);
            const int j = j0 + 8 * jt + 2 * tq + (e & 1);
            const float ci = e >= 2 ? cum_hi : cum_lo;
            v[e] = j <= i ? s[jt][e] * expf(ci - cum[j]) * dts[j] : 0.f;
          }
          pf[2 * jt] = pack_bf16(v[0], v[1]);
          pf[2 * jt + 1] = pack_bf16(v[2], v[3]);
        }
        // A fragment order: (row g, k 0-7), (row g+8, k 0-7), (row g, k 8-15), (row g+8, k 8-15)
        const uint32_t af[4] = {pf[0], pf[1], pf[2], pf[3]};
#pragma unroll
        for (int pt = 0; pt < 8; ++pt) {
          const bf16* xp = xt + (8 * pt + gq) * kXS + j0 + 2 * tq;
          mma_16816(y[pt], af, ld32(xp), ld32(xp + 8));
        }
      }
      // D x, then the rows out (zero past the prompt)
#pragma unroll
      for (int pt = 0; pt < 8; ++pt) {
        const int p = 8 * pt + 2 * tq;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int i = i0 + gq + 8 * half;
          const int r = r0 + i;
          if (r >= a.S) continue;
          const bool valid = r < L;
          const float x0 = __bfloat162float(xt[p * kXS + i]);
          const float x1 = __bfloat162float(xt[(p + 1) * kXS + i]);
          const float2 out = valid ? make_float2(fmaf(Dh, x0, y[pt][2 * half]),
                                                 fmaf(Dh, x1, y[pt][2 * half + 1]))
                                   : make_float2(0.f, 0.f);
          *reinterpret_cast<float2*>(a.y + ((static_cast<long long>(g) * a.S + r) * a.H + h) *
                                               kP + p) = out;
        }
      }
    }
    __syncthreads();  // every row has read the previous state

    // ---- the state after the chunk ----------------------------------------------
    const float decay = expf(cum[Q - 1]);
#pragma unroll
    for (int k = 0; k < 8; ++k)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[k][e] *= decay;
#pragma unroll 1
    for (int kt = 0; kt < n_tiles; ++kt) {
      const int j0 = 16 * kt;
      // x^T scaled by exp(cum_last - cum_j) dt_j along k = j
      const bf16* x_lo = xt + (p0 + gq) * kXS + j0 + 2 * tq;
      const bf16* x_hi = x_lo + 8 * kXS;
      const float w0 = wend[j0 + 2 * tq], w1 = wend[j0 + 2 * tq + 1];
      const float w8 = wend[j0 + 2 * tq + 8], w9 = wend[j0 + 2 * tq + 9];
      const uint32_t af[4] = {
          pack_bf16(__bfloat162float(x_lo[0]) * w0, __bfloat162float(x_lo[1]) * w1),
          pack_bf16(__bfloat162float(x_hi[0]) * w0, __bfloat162float(x_hi[1]) * w1),
          pack_bf16(__bfloat162float(x_lo[8]) * w8, __bfloat162float(x_lo[9]) * w9),
          pack_bf16(__bfloat162float(x_hi[8]) * w8, __bfloat162float(x_hi[9]) * w9)};
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int n = n0 + 8 * k + gq;
        const bf16* b_lo = bs + (j0 + 2 * tq) * kCS + n;
        mma_16816(st[k], af, pair(b_lo[0], b_lo[kCS]), pair(b_lo[8 * kCS], b_lo[9 * kCS]));
      }
    }
    __syncthreads();  // before the next chunk's loads
  }

  // zero the rows no chunk ran
  const long long y_base = (static_cast<long long>(g) * a.S) * a.H + h;
  for (int r = n_chunks * Q + (t >> 4); r < a.S; r += kThreads / 16)
    reinterpret_cast<float4*>(a.y + (y_base + static_cast<long long>(r) * a.H) * kP)[t & 15] =
        make_float4(0.f, 0.f, 0.f, 0.f);
  float* so = a.state + (static_cast<long long>(g) * a.H + h) * kP * kN;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int col = n0 + 8 * k + 2 * tq;
    *reinterpret_cast<float2*>(so + (p0 + gq) * kN + col) = make_float2(st[k][0], st[k][1]);
    *reinterpret_cast<float2*>(so + (p0 + gq + 8) * kN + col) = make_float2(st[k][2], st[k][3]);
  }
}

}  // namespace

// x [G, S, H, 64] with row stride x_row and prompt stride x_prompt (bf16
// elements; heads packed), b and c [G, S, G', 128] with row stride bc_row and
// prompt stride bc_prompt; dt [G, S, H], a, d [H] and lengths [G]; y [G, S,
// H, 64] and state [G, H, 64, 128] f32, contiguous.  chunk: a multiple of 16
// up to 256.
extern "C" int mm_ssm_scan_bf16(const void* x, const void* b, const void* c, const float* dt,
                                const float* a, const float* d, const int* lengths, float* y,
                                float* state, int G, int S, int H, int groups, int x_row,
                                int bc_row, int bc_prompt, int x_prompt, int chunk,
                                void* stream) {
  if (chunk < 16 || chunk > kQ || chunk % 16 || H % groups || G < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t e = cudaFuncSetAttribute(
      ssm_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(kSmem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const ScanArgs args{static_cast<const bf16*>(x), static_cast<const bf16*>(b),
                      static_cast<const bf16*>(c), dt, a, d, lengths, y, state, S, H, groups,
                      x_row, bc_row, bc_prompt, x_prompt, chunk};
  ssm_scan_kernel<<<G * H, kThreads, kSmem, static_cast<cudaStream_t>(stream)>>>(args);
  return mm::last_error();
}
