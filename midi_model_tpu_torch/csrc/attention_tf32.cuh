// Tiles and fragments of the f32 causal attention kernels at head_dim 64
// (causal_attention.cu fwd_tf32_kernel, causal_attention_bwd.cu
// dkdv_tf32_kernel and dq_tf32_kernel): every product as three TF32
// products on mma.sync m16n8k8 (hopper.cuh, "3xTF32").
//
// A tile is 64 rows of one head, f32, in shared memory at a pitch of 68
// floats (272 bytes: each row 16-byte aligned for cp.async).  Every fragment
// is read one float a lane, and 68 = 4 (mod 32) puts the 32 lanes of each
// read on 32 banks: an A fragment or a B fragment whose n runs along the
// tile's rows reads (row g, column t) at bank 4g + t; a B fragment whose k
// runs along the rows reads (row 2t, column g) at bank 8t + g.
//
// k order: a product's k index may run in any order as long as A and B
// agree.  Where A is an accumulator (P or dS, 16 x 64) its 16 x 8 tile
// hands over its columns 2t, 2t+1 in lane (g, t) — so those products take
// logical k t and t+4 from columns (rows of B) 2t and 2t+1 (a_from_acc,
// ld_b_krows), and no value moves between lanes.
#pragma once

#include "hopper.cuh"

namespace mm {
namespace tf32 {

using namespace mm::sm90;

constexpr int kR = 64;         // rows of a tile (queries or keys); the head dim is 64 too
constexpr int kPitch = 68;     // floats a shared-memory row
constexpr int kTileFloats = kR * kPitch;
constexpr int kThreads = 128;  // four warps of 16 rows

// rows [r0, r0 + 64) of one head (row stride rs floats, row 0 at base) into
// a tile by cp.async, 16 bytes a thread; rows at or past S are zero
__device__ __forceinline__ void load_tile(float* tile, const float* base, long long rs, int r0,
                                          int S) {
  for (int c = threadIdx.x; c < kR * 16; c += kThreads) {
    const int rr = c >> 4, ch = c & 15;
    const int row = r0 + rr;
    const bool ok = row < S;
    cp_async_16(smem_u32(tile + rr * kPitch + ch * 4), base + (ok ? row : 0) * rs + ch * 4, ok);
  }
}

// the A fragment of rows m0 .. m0+15, columns k0 .. k0+7 of a tile, split
__device__ __forceinline__ void ld_a(uint32_t (&hi)[4], uint32_t (&lo)[4], const float* tile,
                                     int m0, int k0, int lane) {
  const float* p = tile + (m0 + (lane >> 2)) * kPitch + k0 + (lane & 3);
  const float x[4] = {p[0], p[8 * kPitch], p[4], p[8 * kPitch + 4]};
  split_frag(x, hi, lo);
}

// the B fragment (k0 .. k0+7, n0 .. n0+7) of a product whose n runs along
// the tile's rows, B[k][n] = tile[n0 + n][k0 + k] (K in Q.K^T), split
__device__ __forceinline__ void ld_b_nrows(uint32_t (&hi)[2], uint32_t (&lo)[2],
                                           const float* tile, int n0, int k0, int lane) {
  const float* p = tile + (n0 + (lane >> 2)) * kPitch + k0 + (lane & 3);
  const float x[2] = {p[0], p[4]};
  split_frag(x, hi, lo);
}

// the B fragment of a product whose k runs along the tile's rows (V in
// P.V), B[k][n] = tile[k0 + k'][n0 + n], logical k t and t+4 at rows 2t and
// 2t+1 (the order of a_from_acc), split
__device__ __forceinline__ void ld_b_krows(uint32_t (&hi)[2], uint32_t (&lo)[2],
                                           const float* tile, int k0, int n0, int lane) {
  const float* p = tile + (k0 + 2 * (lane & 3)) * kPitch + n0 + (lane >> 2);
  const float x[2] = {p[0], p[kPitch]};
  split_frag(x, hi, lo);
}

// the A fragment over k = the 8 columns of one 16 x 8 accumulator tile c, in
// ld_b_krows' order: a0 (g, 2t), a1 (g+8, 2t), a2 (g, 2t+1), a3 (g+8, 2t+1)
__device__ __forceinline__ void a_from_acc(uint32_t (&hi)[4], uint32_t (&lo)[4],
                                           const float (&c)[4]) {
  const float x[4] = {c[0], c[2], c[1], c[3]};
  split_frag(x, hi, lo);
}

__device__ __forceinline__ void zero(float (&c)[8][4]) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[i][e] = 0.f;
}

// sum += part, f32 adds.  The tensor cores truncate as they accumulate, so
// a sum over many tiles (dk, dv, dq, the forward's output) takes each tile's
// products in a fresh accumulator (8 k steps x 3 products) and adds them
// here, rounded to nearest: over 2,047 keys that truncation, not the split,
// would otherwise set the error (PERF.md).
__device__ __forceinline__ void accumulate(float (&sum)[8][4], const float (&part)[8][4]) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) sum[i][e] += part[i][e];
}

// c (16 x 64) += A B: A's fragments for k = 8kk .. 8kk+7 from a_frag(kk, hi,
// lo), B's over the 64 columns from b_frag(kk, nt, hi, lo); the 8 column
// tiles are independent sums, so each k step issues 8 of them
template <typename AFrag, typename BFrag>
__device__ __forceinline__ void product(float (&c)[8][4], AFrag a_frag, BFrag b_frag) {
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    uint32_t ah[4], al[4];
    a_frag(kk, ah, al);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      uint32_t bh[2], bl[2];
      b_frag(kk, nt, bh, bl);
      mma_3xtf32(c[nt], ah, al, bh, bl);
    }
  }
}

// a 16 x 64 accumulator block (rows r0 + lane/4 and r0 + lane/4 + 8) to f32
// rows of stride rs, times scale; rows at or past S are skipped
__device__ __forceinline__ void store_rows(float* base, long long rs, int r0, int S,
                                           const float (&c)[8][4], float scale, int lane) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + (lane >> 2) + 8 * r;
    if (row >= S) continue;
    float2* dst = reinterpret_cast<float2*>(base + row * rs + 2 * (lane & 3));
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
      dst[4 * nt] = make_float2(c[nt][2 * r] * scale, c[nt][2 * r + 1] * scale);
  }
}

}  // namespace tf32
}  // namespace mm
