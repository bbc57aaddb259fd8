// Causal attention backward (FlashAttention-2 form, recomputed from the LSE).
//
// Replaces: the backward of midi_model_tpu/ops/attention.py
// splash_causal_attention (JAX's shipped Pallas TPU splash kernel, whose
// dq/dkv backward is fused: use_fused_bwd_kernel=True, attention.py:131),
// reached from training (train/trainer.py through llama.forward).
//
// What it computes (the plain version is
// midi_model_tpu_torch/ops/attention.py, causal_attention_backward_reference):
// from q, k, v [B, S, H | Hkv, Dh] (any strides with a contiguous last dim),
// out and dout (contiguous [B, S, H, Dh]) and the forward's f32
// log-sum-exp lse [B, H, S]:
//   D  = rowsum(dout * out)                  (f32, per query row and head)
//   P  = exp(q . k * scale - lse)            (recomputed, causal mask)
//   dv = P_T^T dout                          (P rounded to the input dtype T)
//   dS = P * (dout . v - D)
//   dq = dS k * scale,  dk = dS^T q * scale
// P is rounded to T for dv at the point where the plain version rounds it.
// These are the gradients of the plain forward, which rounds the normalized
// probabilities to T before P.V; the bf16 forward kernel rounds P before
// normalizing instead (causal_attention.cu), so its output — and hence D —
// lies within about one bf16 step of the plain forward's.
// GQA: a kv head's dk / dv sum over its H / Hkv query heads (JAX's
// jnp.repeat of k and v, attention.py:155-157).  Any S (the ragged last
// tile is masked on both the query and the key side), Dh 64 (the event
// net) or 256 (the token net), bf16 or f32 in and out, f32 sums.
//
// What bounds it on an H100: at the event net's shapes, operations — five
// S x S x Dh products per (batch, head) over the causal half (2.5x the
// forward) against one read of q, k, v, out, dout, lse and one write of dq,
// dk, dv.  At the token net's (8-row sequences, Dh 256), bytes.
//
// Every form makes three launches, no atomics: (1) D, one warp per (row,
// head); (2) dk/dv by key tile, walking the query tiles on or below the
// diagonal for each query head of the tile's kv head; (3) dq by query tile,
// walking the key tiles up to the diagonal.  Both recompute the scores and
// dP (FlashAttention-2's two-kernel split trades that recompute for no
// atomics).
//
// * bf16, Dh 64 (dkdv_tc_kernel, dq_tc_kernel): tiles of 64 rows, one warp
//   per 16 of them, every product on the tensor cores with mma.sync
//   m16n8k16 (HMMA): S^T = K Q^T and dP^T = V dO^T with K and V held as A
//   fragments, dv += P^T dO and dk += dS^T Q with P^T and dS^T converted
//   from accumulators to A fragments in registers and dO, Q read through
//   ldmatrix.trans; dq pass: S = Q K^T, dP = dO V^T, dq += dS K.  Why not
//   wgmma: its 64-row M would put a whole 64-key tile's S^T, dP^T, dk and
//   dv accumulators (4 x 32 registers) in each thread of a warpgroup beside
//   a transposed-B path for three of the five products; mma.sync keeps the
//   same tiles per warp with ldmatrix(.trans) doing the transposes.  dS is
//   rounded to bf16 for its two products (the plain version keeps it in
//   f32).  Tiles come in by cp.async (16 bytes a thread, rows past S
//   zero-filled) into padded shared memory (rows of 72 bf16: ldmatrix rows
//   fall on distinct banks), the next tile's copy in flight while the
//   current one is used.  The dk/dv pass launches its longest key tiles
//   (the first) first, the dq pass its longest query tiles (the last) first.
// * f32, Dh 64 (dkdv_tf32_kernel, dq_tf32_kernel): the plan of the bf16
//   pair — 64-row tiles, one warp per 16 rows, tiles by cp.async into padded
//   shared memory with the next in flight, the longest tiles first, the
//   same five products and transposes — with every product as three TF32
//   products on mma.sync m16n8k8 (hopper.cuh, 3xTF32: close to f32's
//   accuracy; attention_tf32.cuh has the tiles and fragments).  P^T and dS^T
//   (dq pass: dS) go from their accumulators to A fragments in registers,
//   split, unrounded; K and V (dq pass: Q and dO) are read from shared
//   memory for each step rather than held split in registers (128 more a
//   thread).  Each step's dk, dv (dq) products are summed apart and added to
//   the running sums in f32 (the tensor cores truncate as they accumulate).
// * Dh 256, bf16 and f32 (dkdv_rows256_kernel<T, R>, dq_rows256_kernel<T,
//   R>): thousands of 8-row sequences, bytes-bound.  One warp owns R = 4 key
//   rows (dk/dv) or query rows (dq) of one (sequence, head), a lane 8 of the
//   256 head dims (one 16-byte load in bf16, two in f32); it walks the other
//   side's rows one at a time, each score and dP a warp sum.  CUDA-core f32:
//   the bytes set the pace.  P is rounded to the input type for dv (bf16, or
//   none).
#include <climits>

#include "attention_tf32.cuh"
#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int kDeltaThreads = 256;  // the D pass: a warp per row

struct Strides {
  long long qb, qs, qh, kb, ks, kh, vb, vs, vh;
};

// D[b, h, s] = sum_d dout * out, one warp per (b, s, h) row
template <typename T, int DH>
__global__ void __launch_bounds__(kDeltaThreads) delta_kernel(const T* __restrict__ out,
                                                              const T* __restrict__ dout,
                                                              float* __restrict__ delta, int S,
                                                              int H, long long rows) {
  const long long row =
      static_cast<long long>(blockIdx.x) * (kDeltaThreads / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const T* o = out + row * DH;
  const T* g = dout + row * DH;
  float acc = 0.f;
  for (int d = lane; d < DH; d += 32) acc += mm::to_f32(o[d]) * mm::to_f32(g[d]);
  acc = mm::warp_sum(acc);
  if (lane == 0) {
    const long long h = row % H, bs = row / H;  // row = (b * S + s) * H + h
    const long long b = bs / S, s = bs % S;
    delta[(b * H + h) * S + s] = acc;
  }
}

// D = rowsum(dout * out), one warp per (b, s, h) row
template <typename T, int DH>
int launch_delta(const T* out, const T* dout, float* delta, int B, int S, int H,
                 cudaStream_t stream) {
  const long long rows = static_cast<long long>(B) * S * H;
  const int warps = kDeltaThreads / 32;
  delta_kernel<T, DH><<<static_cast<unsigned int>((rows + warps - 1) / warps), kDeltaThreads, 0,
                        stream>>>(out, dout, delta, S, H, rows);
  return mm::last_error();
}

// ---- bf16, Dh 64: mma.sync ------------------------------------------------------

namespace tc {

using namespace mm::sm90;
using bf16 = __nv_bfloat16;

constexpr int kR = 64;                           // rows of a tile (queries or keys)
constexpr int kThreadsTc = 128;                  // four warps of 16 rows
constexpr int kPitch = 72;                       // bf16 a shared-memory row (144 bytes)
constexpr uint32_t kTileBytes = kR * kPitch * 2;
constexpr size_t kSmem = 6 * kTileBytes + 4 * kR * sizeof(float);

// rows [r0, r0 + 64) of one head (row stride rs, row 0 at base) into a padded
// tile by cp.async; rows at or past S are zero
__device__ __forceinline__ void load_tile(uint32_t dst, const bf16* base, long long rs, int r0,
                                          int S) {
  for (int c = threadIdx.x; c < kR * 8; c += kThreadsTc) {
    const int rr = c >> 3, ch = c & 7;
    const int row = r0 + rr;
    const bool ok = row < S;
    cp_async_16(dst + (rr * kPitch + ch * 8) * 2, base + (ok ? row : 0) * rs + ch * 8, ok);
  }
}

// the A fragment of rows m0 .. m0+15, columns k0 .. k0+15 of a tile
__device__ __forceinline__ void ld_a(uint32_t (&a)[4], uint32_t tile, int m0, int k0, int lane) {
  const int row = m0 + (lane & 7) + 8 * ((lane >> 3) & 1);
  ldmatrix_x4(a, tile + (row * kPitch + k0 + 8 * (lane >> 4)) * 2);
}

// B fragments (k0 .. k0+15) of the n-tiles n0 and n0+8 from a tile stored
// with n along its rows (b[0..1] the first, b[2..3] the second)
__device__ __forceinline__ void ld_b_nrows(uint32_t (&b)[4], uint32_t tile, int n0, int k0,
                                           int lane) {
  const int i = lane >> 3;
  const int row = n0 + (lane & 7) + 8 * (i >> 1);
  ldmatrix_x4(b, tile + (row * kPitch + k0 + 8 * (i & 1)) * 2);
}

// the same from a tile stored with k along its rows (transposed on the way)
__device__ __forceinline__ void ld_b_krows(uint32_t (&b)[4], uint32_t tile, int k0, int n0,
                                           int lane) {
  const int i = lane >> 3;
  const int row = k0 + (lane & 7) + 8 * (i & 1);
  ldmatrix_x4_trans(b, tile + (row * kPitch + n0 + 8 * (i >> 1)) * 2);
}

// c[16 x 64] += a[16 x 64 over k] b, b's fragments from ld_b_* per 16-wide k slice
template <bool KRows>
__device__ __forceinline__ void product(float (&c)[8][4], const uint32_t (&a)[4][4],
                                        uint32_t tile, int lane) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      uint32_t b[4];
      if (KRows) {
        ld_b_krows(b, tile, 16 * kk, 16 * np, lane);
      } else {
        ld_b_nrows(b, tile, 16 * np, 16 * kk, lane);
      }
      mma_16816(c[2 * np], a[kk], b[0], b[1]);
      mma_16816(c[2 * np + 1], a[kk], b[2], b[3]);
    }
  }
}

// the A fragments (k = the accumulator's 64 columns) of a 16 x 64 accumulator, in bf16
__device__ __forceinline__ void to_a(uint32_t (&a)[4][4], const float (&c)[8][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    a[kk][0] = pack_bf16(c[2 * kk][0], c[2 * kk][1]);
    a[kk][1] = pack_bf16(c[2 * kk][2], c[2 * kk][3]);
    a[kk][2] = pack_bf16(c[2 * kk + 1][0], c[2 * kk + 1][1]);
    a[kk][3] = pack_bf16(c[2 * kk + 1][2], c[2 * kk + 1][3]);
  }
}

__device__ __forceinline__ void zero(float (&c)[8][4]) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[i][e] = 0.f;
}

// the lse (in log2 units; +inf past S: P = 0) and D of query rows [q0, q0 + 64)
__device__ __forceinline__ void load_rows(float* Ls, float* Ds, const float* lse,
                                          const float* delta, size_t head_row0, int q0, int S) {
  for (int r = threadIdx.x; r < kR; r += kThreadsTc) {
    const int row = q0 + r;
    Ls[r] = row < S ? lse[head_row0 + row] * kLog2e : CUDART_INF_F;
    Ds[r] = row < S ? delta[head_row0 + row] : 0.f;
  }
}

// a 16 x 64 row-major accumulator block (rows r0 + lane/4 (+8)) to bf16 rows
// of stride rs, times scale; rows at or past S are skipped
__device__ __forceinline__ void store_rows(bf16* base, long long rs, int r0, int S,
                                           const float (&c)[8][4], float scale, int lane) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + (lane >> 2) + 8 * r;
    if (row >= S) continue;
    uint32_t* dst = reinterpret_cast<uint32_t*>(base + row * rs + 2 * (lane & 3));
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
      dst[4 * nt] = pack_bf16(c[nt][2 * r] * scale, c[nt][2 * r + 1] * scale);
  }
}

__global__ void __launch_bounds__(kThreadsTc) dkdv_tc_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ delta,
    bf16* __restrict__ dk, bf16* __restrict__ dv, int S, int H, int groups, int n_t, Strides st,
    float scale, float scale_log2) {
  extern __shared__ __align__(16) uint8_t smem[];
  const uint32_t s0 = smem_u32(smem);
  const uint32_t sK = s0, sV = s0 + kTileBytes;
  auto sQ = [&](int i) { return s0 + kTileBytes * (2 + 2 * i); };
  auto sG = [&](int i) { return s0 + kTileBytes * (3 + 2 * i); };
  float* Ls = reinterpret_cast<float*>(smem + 6 * kTileBytes);  // [2][64]
  float* Ds = Ls + 2 * kR;                                       // [2][64]

  const int hkv = H / groups;
  const int bh_count = gridDim.x / n_t;
  const int kt = static_cast<int>(blockIdx.x) / bh_count;  // key tile 0 (every query tile) first
  const int bh = static_cast<int>(blockIdx.x) % bh_count;
  const int b = bh / hkv, hk = bh % hkv;
  const int k0 = kt * kR;
  const int n_q = n_t - kt;  // query tiles on or below the diagonal
  const int steps = groups * n_q;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  auto prefetch = [&](int step, int buf) {
    const int h = hk * groups + step / n_q;
    const int q0 = (kt + step % n_q) * kR;
    load_tile(sQ(buf), q + b * st.qb + h * st.qh, st.qs, q0, S);
    load_tile(sG(buf), dout + static_cast<size_t>(b) * S * H * 64 + h * 64,
              static_cast<long long>(H) * 64, q0, S);
    cp_async_commit();
    load_rows(Ls + kR * buf, Ds + kR * buf, lse, delta, (static_cast<size_t>(b) * H + h) * S,
              q0, S);
  };
  load_tile(sK, k + b * st.kb + hk * st.kh, st.ks, k0, S);
  load_tile(sV, v + b * st.vb + hk * st.vh, st.vs, k0, S);
  prefetch(0, 0);  // one group with K and V
  cp_async_wait<0>();
  __syncthreads();
  uint32_t ka[4][4], va[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    ld_a(ka[kk], sK, 16 * warp, 16 * kk, lane);
    ld_a(va[kk], sV, 16 * warp, 16 * kk, lane);
  }
  float dka[8][4], dva[8][4];
  zero(dka);
  zero(dva);
  const int key0 = k0 + 16 * warp + (lane >> 2);  // this thread's keys: key0, key0 + 8

  for (int step = 0; step < steps; ++step) {
    const int buf = step & 1;
    if (step + 1 < steps) {
      prefetch(step + 1, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int q0 = (kt + step % n_q) * kR;
    const float* L = Ls + kR * buf;
    const float* D = Ds + kR * buf;
    float pt[8][4], dst[8][4];  // S^T then P^T; dP^T then dS^T: 16 keys x 64 queries
    zero(pt);
    zero(dst);
    product<false>(pt, ka, sQ(buf), lane);
    product<false>(dst, va, sG(buf), lane);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qc = 8 * nt + 2 * (lane & 3) + (e & 1);
        float p = exp2f(fmaf(pt[nt][e], scale_log2, -L[qc]));
        if (q0 + qc < key0 + 8 * (e >> 1)) p = 0.f;  // the diagonal tile's upper half
        pt[nt][e] = p;
        dst[nt][e] = p * (dst[nt][e] - D[qc]);
      }
    }
    uint32_t a[4][4];
    to_a(a, pt);  // P rounded to bf16, as the plain version's dv
    product<true>(dva, a, sG(buf), lane);
    to_a(a, dst);
    product<true>(dka, a, sQ(buf), lane);
    __syncthreads();  // this buffer's reads are done before it is refilled
  }
  const size_t head = static_cast<size_t>(b) * S * hkv + hk;
  store_rows(dk + head * 64, static_cast<long long>(hkv) * 64, k0 + 16 * warp, S, dka, scale,
             lane);
  store_rows(dv + head * 64, static_cast<long long>(hkv) * 64, k0 + 16 * warp, S, dva, 1.f, lane);
}

__global__ void __launch_bounds__(kThreadsTc) dq_tc_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ delta,
    bf16* __restrict__ dq, int S, int H, int groups, int n_t, Strides st, float scale,
    float scale_log2) {
  extern __shared__ __align__(16) uint8_t smem[];
  const uint32_t s0 = smem_u32(smem);
  const uint32_t sQ = s0, sG = s0 + kTileBytes;
  auto sK = [&](int i) { return s0 + kTileBytes * (2 + 2 * i); };
  auto sV = [&](int i) { return s0 + kTileBytes * (3 + 2 * i); };
  float* Ls = reinterpret_cast<float*>(smem + 6 * kTileBytes);
  float* Ds = Ls + kR;

  const int bh_count = gridDim.x / n_t;
  const int qt = n_t - 1 - static_cast<int>(blockIdx.x) / bh_count;  // the longest first
  const int bh = static_cast<int>(blockIdx.x) % bh_count;
  const int b = bh / H, h = bh % H, hk = h / groups;
  const int q0 = qt * kR;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bf16* kb = k + b * st.kb + hk * st.kh;
  const bf16* vb = v + b * st.vb + hk * st.vh;

  load_tile(sQ, q + b * st.qb + h * st.qh, st.qs, q0, S);
  load_tile(sG, dout + static_cast<size_t>(b) * S * H * 64 + h * 64,
            static_cast<long long>(H) * 64, q0, S);
  load_tile(sK(0), kb, st.ks, 0, S);
  load_tile(sV(0), vb, st.vs, 0, S);
  cp_async_commit();
  load_rows(Ls, Ds, lse, delta, (static_cast<size_t>(b) * H + h) * S, q0, S);
  cp_async_wait<0>();
  __syncthreads();
  uint32_t qa[4][4], ga[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    ld_a(qa[kk], sQ, 16 * warp, 16 * kk, lane);
    ld_a(ga[kk], sG, 16 * warp, 16 * kk, lane);
  }
  const int rl = 16 * warp + (lane >> 2);  // this thread's local rows: rl, rl + 8
  const float lse_r[2] = {Ls[rl], Ls[rl + 8]};
  const float d_r[2] = {Ds[rl], Ds[rl + 8]};
  float acc[8][4];
  zero(acc);

  for (int kt = 0; kt <= qt; ++kt) {
    const int buf = kt & 1;
    if (kt < qt) {
      load_tile(sK(buf ^ 1), kb, st.ks, (kt + 1) * kR, S);
      load_tile(sV(buf ^ 1), vb, st.vs, (kt + 1) * kR, S);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    float s[8][4], ds[8][4];  // S then P; dP then dS: 16 queries x 64 keys
    zero(s);
    zero(ds);
    product<false>(s, qa, sK(buf), lane);
    product<false>(ds, ga, sV(buf), lane);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const int key = kt * kR + 8 * nt + 2 * (lane & 3) + (e & 1);
        float p = exp2f(fmaf(s[nt][e], scale_log2, -lse_r[r]));
        if (key > q0 + rl + 8 * r) p = 0.f;  // the diagonal tile's upper half
        ds[nt][e] = p * (ds[nt][e] - d_r[r]);
      }
    }
    uint32_t a[4][4];
    to_a(a, ds);
    product<true>(acc, a, sK(buf), lane);
    __syncthreads();  // this buffer's reads are done before it is refilled
  }
  store_rows(dq + (static_cast<size_t>(b) * S * H + h) * 64, static_cast<long long>(H) * 64,
             q0 + 16 * warp, S, acc, scale, lane);
}

int launch(const void* q, const void* k, const void* v, const void* out, const void* dout,
           const float* lse, float* delta, void* dq, void* dk, void* dv, int B, int S, int H,
           int Hkv, const long long* st, cudaStream_t stream) {
  const Strides strides{st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8]};
  const int n_t = (S + kR - 1) / kR;
  const long long dkdv_blocks = static_cast<long long>(B) * Hkv * n_t;
  const long long dq_blocks = static_cast<long long>(B) * H * n_t;
  if (dq_blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidConfiguration);
  cudaError_t e = cudaFuncSetAttribute(dkdv_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(kSmem));
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaFuncSetAttribute(dq_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(kSmem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const bf16* qt = static_cast<const bf16*>(q);
  const bf16* kt = static_cast<const bf16*>(k);
  const bf16* vt = static_cast<const bf16*>(v);
  const bf16* gt = static_cast<const bf16*>(dout);
  int err = launch_delta<bf16, 64>(static_cast<const bf16*>(out), gt, delta, B, S, H, stream);
  if (err) return err;
  const float scale = 0.125f;  // 64**-0.5
  dkdv_tc_kernel<<<static_cast<unsigned int>(dkdv_blocks), kThreadsTc, kSmem, stream>>>(
      qt, kt, vt, gt, lse, delta, static_cast<bf16*>(dk), static_cast<bf16*>(dv), S, H, H / Hkv,
      n_t, strides, scale, scale * kLog2e);
  if ((err = mm::last_error())) return err;
  dq_tc_kernel<<<static_cast<unsigned int>(dq_blocks), kThreadsTc, kSmem, stream>>>(
      qt, kt, vt, gt, lse, delta, static_cast<bf16*>(dq), S, H, H / Hkv, n_t, strides, scale,
      scale * kLog2e);
  return mm::last_error();
}

}  // namespace tc

// ---- f32, Dh 64: 3xTF32 on mma.sync ---------------------------------------------

namespace tf32k {

using namespace mm::tf32;

constexpr size_t kSmem = 6 * kTileFloats * sizeof(float) + 4 * kR * sizeof(float);

__global__ void __launch_bounds__(kThreads) dkdv_tf32_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, float* __restrict__ dk, float* __restrict__ dv, int S,
    int H, int groups, int n_t, Strides st, float scale, float scale_log2) {
  extern __shared__ __align__(16) float smem_f[];
  const float* sK = smem_f;
  const float* sV = smem_f + kTileFloats;
  auto sQ = [&](int i) { return smem_f + kTileFloats * (2 + 2 * i); };
  auto sG = [&](int i) { return smem_f + kTileFloats * (3 + 2 * i); };
  float* Ls = smem_f + 6 * kTileFloats;  // [2][64]
  float* Ds = Ls + 2 * kR;               // [2][64]

  const int hkv = H / groups;
  const int bh_count = gridDim.x / n_t;
  const int kt = static_cast<int>(blockIdx.x) / bh_count;  // key tile 0 (every query tile) first
  const int bh = static_cast<int>(blockIdx.x) % bh_count;
  const int b = bh / hkv, hk = bh % hkv;
  const int k0 = kt * kR;
  const int n_q = n_t - kt;  // query tiles on or below the diagonal
  const int steps = groups * n_q;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  auto prefetch = [&](int step, int buf) {
    const int h = hk * groups + step / n_q;
    const int q0 = (kt + step % n_q) * kR;
    load_tile(sQ(buf), q + b * st.qb + h * st.qh, st.qs, q0, S);
    load_tile(sG(buf), dout + static_cast<size_t>(b) * S * H * 64 + h * 64,
              static_cast<long long>(H) * 64, q0, S);
    cp_async_commit();
    tc::load_rows(Ls + kR * buf, Ds + kR * buf, lse, delta,
                  (static_cast<size_t>(b) * H + h) * S, q0, S);
  };
  load_tile(smem_f, k + b * st.kb + hk * st.kh, st.ks, k0, S);
  load_tile(smem_f + kTileFloats, v + b * st.vb + hk * st.vh, st.vs, k0, S);
  prefetch(0, 0);  // one group with K and V
  cp_async_wait<0>();
  __syncthreads();
  float dka[8][4], dva[8][4];
  zero(dka);
  zero(dva);
  const int key0 = k0 + 16 * warp + (lane >> 2);  // this thread's keys: key0, key0 + 8
  const int col0 = 2 * (lane & 3);

  for (int step = 0; step < steps; ++step) {
    const int buf = step & 1;
    if (step + 1 < steps) {
      prefetch(step + 1, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int q0 = (kt + step % n_q) * kR;
    const float* L = Ls + kR * buf;
    const float* D = Ds + kR * buf;
    const float* tq = sQ(buf);
    const float* tg = sG(buf);
    float pt[8][4], dst[8][4];  // S^T then P^T; dP^T then dS^T: 16 keys x 64 queries
    zero(pt);
    zero(dst);
    product(
        pt,
        [&](int kk, uint32_t (&ah)[4], uint32_t (&al)[4]) {
          ld_a(ah, al, sK, 16 * warp, 8 * kk, lane);
        },
        [&](int kk, int nt, uint32_t (&bh)[2], uint32_t (&bl)[2]) {
          ld_b_nrows(bh, bl, tq, 8 * nt, 8 * kk, lane);
        });
    product(
        dst,
        [&](int kk, uint32_t (&ah)[4], uint32_t (&al)[4]) {
          ld_a(ah, al, sV, 16 * warp, 8 * kk, lane);
        },
        [&](int kk, int nt, uint32_t (&bh)[2], uint32_t (&bl)[2]) {
          ld_b_nrows(bh, bl, tg, 8 * nt, 8 * kk, lane);
        });
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qc = 8 * nt + col0 + (e & 1);
        float p = exp2f(fmaf(pt[nt][e], scale_log2, -L[qc]));
        if (q0 + qc < key0 + 8 * (e >> 1)) p = 0.f;  // the diagonal tile's upper half
        pt[nt][e] = p;
        dst[nt][e] = p * (dst[nt][e] - D[qc]);
      }
    }
    float part[8][4];  // this step's dv, then dk, apart from the sums (accumulate)
    zero(part);
    product(
        part, [&](int kk, uint32_t (&ah)[4], uint32_t (&al)[4]) { a_from_acc(ah, al, pt[kk]); },
        [&](int kk, int nt, uint32_t (&bh)[2], uint32_t (&bl)[2]) {
          ld_b_krows(bh, bl, tg, 8 * kk, 8 * nt, lane);
        });
    accumulate(dva, part);
    zero(part);
    product(
        part, [&](int kk, uint32_t (&ah)[4], uint32_t (&al)[4]) { a_from_acc(ah, al, dst[kk]); },
        [&](int kk, int nt, uint32_t (&bh)[2], uint32_t (&bl)[2]) {
          ld_b_krows(bh, bl, tq, 8 * kk, 8 * nt, lane);
        });
    accumulate(dka, part);
    __syncthreads();  // this buffer's reads are done before it is refilled
  }
  const size_t head = static_cast<size_t>(b) * S * hkv + hk;
  store_rows(dk + head * 64, static_cast<long long>(hkv) * 64, k0 + 16 * warp, S, dka, scale,
             lane);
  store_rows(dv + head * 64, static_cast<long long>(hkv) * 64, k0 + 16 * warp, S, dva, 1.f, lane);
}

__global__ void __launch_bounds__(kThreads) dq_tf32_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, float* __restrict__ dq, int S, int H, int groups, int n_t,
    Strides st, float scale, float scale_log2) {
  extern __shared__ __align__(16) float smem_f[];
  float* sQ = smem_f;
  float* sG = smem_f + kTileFloats;
  auto sK = [&](int i) { return smem_f + kTileFloats * (2 + 2 * i); };
  auto sV = [&](int i) { return smem_f + kTileFloats * (3 + 2 * i); };
  float* Ls = smem_f + 6 * kTileFloats;
  float* Ds = Ls + kR;

  const int bh_count = gridDim.x / n_t;
  const int qt = n_t - 1 - static_cast<int>(blockIdx.x) / bh_count;  // the longest first
  const int bh = static_cast<int>(blockIdx.x) % bh_count;
  const int b = bh / H, h = bh % H, hk = h / groups;
  const int q0 = qt * kR;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float* kb = k + b * st.kb + hk * st.kh;
  const float* vb = v + b * st.vb + hk * st.vh;

  load_tile(sQ, q + b * st.qb + h * st.qh, st.qs, q0, S);
  load_tile(sG, dout + static_cast<size_t>(b) * S * H * 64 + h * 64,
            static_cast<long long>(H) * 64, q0, S);
  load_tile(sK(0), kb, st.ks, 0, S);
  load_tile(sV(0), vb, st.vs, 0, S);
  cp_async_commit();
  tc::load_rows(Ls, Ds, lse, delta, (static_cast<size_t>(b) * H + h) * S, q0, S);
  cp_async_wait<0>();
  __syncthreads();
  const int rl = 16 * warp + (lane >> 2);  // this thread's local rows: rl, rl + 8
  const float lse_r[2] = {Ls[rl], Ls[rl + 8]};
  const float d_r[2] = {Ds[rl], Ds[rl + 8]};
  const int col0 = 2 * (lane & 3);
  float acc[8][4];
  zero(acc);

  for (int kt = 0; kt <= qt; ++kt) {
    const int buf = kt & 1;
    if (kt < qt) {
      load_tile(sK(buf ^ 1), kb, st.ks, (kt + 1) * kR, S);
      load_tile(sV(buf ^ 1), vb, st.vs, (kt + 1) * kR, S);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* tk = sK(buf);
    const float* tv = sV(buf);
    float s[8][4], ds[8][4];  // S then P; dP then dS: 16 queries x 64 keys
    zero(s);
    zero(ds);
    product(
        s,
        [&](int kk, uint32_t (&ah)[4], uint32_t (&al)[4]) {
          ld_a(ah, al, sQ, 16 * warp, 8 * kk, lane);
        },
        [&](int kk, int nt, uint32_t (&bh)[2], uint32_t (&bl)[2]) {
          ld_b_nrows(bh, bl, tk, 8 * nt, 8 * kk, lane);
        });
    product(
        ds,
        [&](int kk, uint32_t (&ah)[4], uint32_t (&al)[4]) {
          ld_a(ah, al, sG, 16 * warp, 8 * kk, lane);
        },
        [&](int kk, int nt, uint32_t (&bh)[2], uint32_t (&bl)[2]) {
          ld_b_nrows(bh, bl, tv, 8 * nt, 8 * kk, lane);
        });
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const int key = kt * kR + 8 * nt + col0 + (e & 1);
        float p = exp2f(fmaf(s[nt][e], scale_log2, -lse_r[r]));
        if (key > q0 + rl + 8 * r) p = 0.f;  // the diagonal tile's upper half
        ds[nt][e] = p * (ds[nt][e] - d_r[r]);
      }
    }
    zero(s);  // this tile's dq, apart from the sum (accumulate)
    product(
        s, [&](int kk, uint32_t (&ah)[4], uint32_t (&al)[4]) { a_from_acc(ah, al, ds[kk]); },
        [&](int kk, int nt, uint32_t (&bh)[2], uint32_t (&bl)[2]) {
          ld_b_krows(bh, bl, tk, 8 * kk, 8 * nt, lane);
        });
    accumulate(acc, s);
    __syncthreads();  // this buffer's reads are done before it is refilled
  }
  store_rows(dq + (static_cast<size_t>(b) * S * H + h) * 64, static_cast<long long>(H) * 64,
             q0 + 16 * warp, S, acc, scale, lane);
}

int launch(const void* q, const void* k, const void* v, const void* out, const void* dout,
           const float* lse, float* delta, void* dq, void* dk, void* dv, int B, int S, int H,
           int Hkv, const long long* st, cudaStream_t stream) {
  const Strides strides{st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8]};
  const int n_t = (S + kR - 1) / kR;
  const long long dkdv_blocks = static_cast<long long>(B) * Hkv * n_t;
  const long long dq_blocks = static_cast<long long>(B) * H * n_t;
  if (dq_blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidConfiguration);
  cudaError_t e = cudaFuncSetAttribute(
      dkdv_tf32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(kSmem));
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaFuncSetAttribute(dq_tf32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(kSmem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const float* qt = static_cast<const float*>(q);
  const float* kt = static_cast<const float*>(k);
  const float* vt = static_cast<const float*>(v);
  const float* gt = static_cast<const float*>(dout);
  int err = launch_delta<float, 64>(static_cast<const float*>(out), gt, delta, B, S, H, stream);
  if (err) return err;
  const float scale = 0.125f;  // 64**-0.5
  dkdv_tf32_kernel<<<static_cast<unsigned int>(dkdv_blocks), kThreads, kSmem, stream>>>(
      qt, kt, vt, gt, lse, delta, static_cast<float*>(dk), static_cast<float*>(dv), S, H,
      H / Hkv, n_t, strides, scale, scale * kLog2e);
  if ((err = mm::last_error())) return err;
  dq_tf32_kernel<<<static_cast<unsigned int>(dq_blocks), kThreads, kSmem, stream>>>(
      qt, kt, vt, gt, lse, delta, static_cast<float*>(dq), S, H, H / Hkv, n_t, strides, scale,
      scale * kLog2e);
  return mm::last_error();
}

}  // namespace tf32k

// ---- bf16, Dh 256: packed rows on the CUDA cores ---------------------------------

namespace rows {

using namespace mm::sm90;

constexpr int kRows = 4;   // key rows (dk/dv) or query rows (dq) a warp owns, both dtypes
constexpr int kWarps = 4;  // warps a block

__device__ __forceinline__ float dot8(const float (&a)[8], const float (&b)[8]) {
  float d = 0.f;
#pragma unroll
  for (int e = 0; e < 8; ++e) d = fmaf(a[e], b[e], d);
  return d;
}

template <typename T, int R>
__global__ void __launch_bounds__(kWarps * 32) dkdv_rows256_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ delta,
    T* __restrict__ dk, T* __restrict__ dv, int S, int H, int groups, int n_t,
    long long bh_count, Strides st, float scale, float scale_log2) {
  const int lane = threadIdx.x & 31;
  const long long item = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (item >= bh_count * n_t) return;
  const int kt = static_cast<int>(item / bh_count);  // key tile 0 (every query row) first
  const long long bh = item % bh_count;
  const int hkv = H / groups;
  const int b = static_cast<int>(bh / hkv), hk = static_cast<int>(bh % hkv);
  const int k0 = kt * R;
  float kf[R][8], vf[R][8], dka[R][8], dva[R][8];
#pragma unroll
  for (int j = 0; j < R; ++j) {
#pragma unroll
    for (int e = 0; e < 8; ++e) kf[j][e] = vf[j][e] = dka[j][e] = dva[j][e] = 0.f;
    if (k0 + j < S) {
      load8(k + b * st.kb + hk * st.kh + (k0 + j) * st.ks + lane * 8, kf[j]);
      load8(v + b * st.vb + hk * st.vh + (k0 + j) * st.vs + lane * 8, vf[j]);
    }
  }
  for (int g = 0; g < groups; ++g) {
    const int h = hk * groups + g;
    const T* qb = q + b * st.qb + h * st.qh + lane * 8;
    const T* gb = dout + (static_cast<size_t>(b) * S * H + h) * 256 + lane * 8;
    const size_t row0 = (static_cast<size_t>(b) * H + h) * S;
    for (int i = k0; i < S; ++i) {  // the query rows that see a key of the tile
      float qf[8], gf[8];
      load8(qb + i * st.qs, qf);
      load8(gb + static_cast<size_t>(i) * H * 256, gf);
      const float lse2 = lse[row0 + i] * kLog2e, di = delta[row0 + i];
#pragma unroll
      for (int j = 0; j < R; ++j) {
        if (k0 + j > i) break;
        const float s = mm::warp_sum(dot8(qf, kf[j]));
        const float dp = mm::warp_sum(dot8(gf, vf[j]));
        const float p = exp2f(fmaf(s, scale_log2, -lse2));
        const float ds = p * (dp - di);
        const float pr = round_to<T>(p);  // as the plain version's dv
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          dva[j][e] = fmaf(pr, gf[e], dva[j][e]);
          dka[j][e] = fmaf(ds, qf[e], dka[j][e]);
        }
      }
    }
  }
#pragma unroll
  for (int j = 0; j < R; ++j) {
    if (k0 + j >= S) break;
    const size_t at = ((static_cast<size_t>(b) * S + k0 + j) * hkv + hk) * 256 + lane * 8;
    float r8[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) r8[e] = dka[j][e] * scale;
    store8(dk + at, r8);
    store8(dv + at, dva[j]);
  }
}

template <typename T, int R>
__global__ void __launch_bounds__(kWarps * 32) dq_rows256_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ delta,
    T* __restrict__ dq, int S, int H, int groups, int n_t, long long bh_count, Strides st,
    float scale, float scale_log2) {
  const int lane = threadIdx.x & 31;
  const long long item = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (item >= bh_count * n_t) return;
  const int qt = n_t - 1 - static_cast<int>(item / bh_count);  // the longest first
  const long long bh = item % bh_count;
  const int b = static_cast<int>(bh / H), h = static_cast<int>(bh % H), hk = h / groups;
  const int q0 = qt * R;
  const size_t row0 = (static_cast<size_t>(b) * H + h) * S;
  float qf[R][8], gf[R][8], acc[R][8], lse2[R], di[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
#pragma unroll
    for (int e = 0; e < 8; ++e) qf[i][e] = gf[i][e] = acc[i][e] = 0.f;
    lse2[i] = di[i] = 0.f;
    if (q0 + i < S) {
      load8(q + b * st.qb + h * st.qh + (q0 + i) * st.qs + lane * 8, qf[i]);
      load8(dout + ((static_cast<size_t>(b) * S + q0 + i) * H + h) * 256 + lane * 8, gf[i]);
      lse2[i] = lse[row0 + q0 + i] * kLog2e;
      di[i] = delta[row0 + q0 + i];
    }
  }
  const T* kb = k + b * st.kb + hk * st.kh + lane * 8;
  const T* vb = v + b * st.vb + hk * st.vh + lane * 8;
  const int last = min(S, q0 + R) - 1;
  for (int j = 0; j <= last; ++j) {
    float kf[8], vf[8];
    load8(kb + j * st.ks, kf);
    load8(vb + j * st.vs, vf);
#pragma unroll
    for (int i = 0; i < R; ++i) {
      if (j > q0 + i || q0 + i >= S) continue;
      const float s = mm::warp_sum(dot8(qf[i], kf));
      const float dp = mm::warp_sum(dot8(gf[i], vf));
      const float ds = exp2f(fmaf(s, scale_log2, -lse2[i])) * (dp - di[i]);
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[i][e] = fmaf(ds, kf[e], acc[i][e]);
    }
  }
#pragma unroll
  for (int i = 0; i < R; ++i) {
    if (q0 + i >= S) break;
    float r8[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) r8[e] = acc[i][e] * scale;
    store8(dq + ((static_cast<size_t>(b) * S + q0 + i) * H + h) * 256 + lane * 8, r8);
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* out, const void* dout,
           const float* lse, float* delta, void* dq, void* dk, void* dv, int B, int S, int H,
           int Hkv, const long long* st, cudaStream_t stream) {
  const Strides strides{st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8]};
  const int n_t = (S + kRows - 1) / kRows;
  const long long dq_blocks = (static_cast<long long>(B) * H * n_t + kWarps - 1) / kWarps;
  const long long dkdv_blocks = (static_cast<long long>(B) * Hkv * n_t + kWarps - 1) / kWarps;
  if (dq_blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidConfiguration);
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* gt = static_cast<const T*>(dout);
  int err = launch_delta<T, 256>(static_cast<const T*>(out), gt, delta, B, S, H, stream);
  if (err) return err;
  const float scale = 0.0625f;  // 256**-0.5
  dkdv_rows256_kernel<T, kRows>
      <<<static_cast<unsigned int>(dkdv_blocks), kWarps * 32, 0, stream>>>(
      qt, kt, vt, gt, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), S, H, H / Hkv,
      n_t, static_cast<long long>(B) * Hkv, strides, scale, scale * kLog2e);
  if ((err = mm::last_error())) return err;
  dq_rows256_kernel<T, kRows><<<static_cast<unsigned int>(dq_blocks), kWarps * 32, 0,
                                 stream>>>(
      qt, kt, vt, gt, lse, delta, static_cast<T*>(dq), S, H, H / Hkv, n_t,
      static_cast<long long>(B) * H, strides, scale, scale * kLog2e);
  return mm::last_error();
}

}  // namespace rows

int launch_f32(const void* q, const void* k, const void* v, const void* out, const void* dout,
               const void* lse, void* delta, void* dq, void* dk, void* dv, int B, int S, int H,
               int Hkv, int Dh, const long long* st, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  switch (Dh) {
    case 64: return tf32k::launch(q, k, v, out, dout, l, dl, dq, dk, dv, B, S, H, Hkv, st, s);
    case 256:
      return rows::launch<float>(q, k, v, out, dout, l, dl, dq, dk, dv, B, S, H, Hkv, st, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

int launch_bf16(const void* q, const void* k, const void* v, const void* out, const void* dout,
                const void* lse, void* delta, void* dq, void* dk, void* dv, int B, int S, int H,
                int Hkv, int Dh, const long long* st, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  switch (Dh) {
    case 64: return tc::launch(q, k, v, out, dout, l, dl, dq, dk, dv, B, S, H, Hkv, st, s);
    case 256:
      return rows::launch<__nv_bfloat16>(q, k, v, out, dout, l, dl, dq, dk, dv, B, S, H, Hkv, st,
                                         s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q, k, v: [B, S, H | Hkv, Dh] by strides [q_b, q_s, q_h, k_b, k_s, k_h, v_b,
// v_s, v_h] (elements; the last dim contiguous; 16-byte aligned with strides
// that are multiples of 16 bytes: 8 bf16, 4 f32 elements); out, dout, dq:
// contiguous [B, S, H, Dh]; dk, dv: contiguous [B, S, Hkv, Dh]; lse: the forward's f32
// [B, H, S]; delta: f32 [B, H, S] scratch.
extern "C" int mm_causal_attention_bwd_f32(const void* q, const void* k, const void* v,
                                           const void* out, const void* dout, const void* lse,
                                           void* delta, void* dq, void* dk, void* dv, int B,
                                           int S, int H, int Hkv, int Dh,
                                           const long long* strides, void* stream) {
  return launch_f32(q, k, v, out, dout, lse, delta, dq, dk, dv, B, S, H, Hkv, Dh, strides,
                    stream);
}

extern "C" int mm_causal_attention_bwd_bf16(const void* q, const void* k, const void* v,
                                            const void* out, const void* dout, const void* lse,
                                            void* delta, void* dq, void* dk, void* dv, int B,
                                            int S, int H, int Hkv, int Dh,
                                            const long long* strides, void* stream) {
  return launch_bf16(q, k, v, out, dout, lse, delta, dq, dk, dv, B, S, H, Hkv, Dh, strides,
                     stream);
}
