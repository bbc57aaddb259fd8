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
// * bf16, Dh 256 (dkdv_rows256_kernel, dq_rows256_kernel): thousands of
//   8-row sequences, bytes-bound.  One warp owns 4 key rows (dk/dv) or 4
//   query rows (dq) of one (sequence, head), a lane 8 of the 256 head dims
//   (16-byte loads); it walks the other side's rows one at a time, each
//   score and dP a warp sum.  CUDA-core f32: the bytes set the pace.
// * f32, both head dims (dkdv_kernel, dq_kernel): the parity path, on the
//   CUDA cores in f32.  Tiles are R rows of f32 in shared memory, padded to
//   dodge bank conflicts, with R * Dh = 4096: R = 64 at Dh 64 (100 KB of
//   tiles), R = 16 at Dh 256 (68 KB) — 16 output values per thread.
#include <climits>

#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTileElems = 4096;  // R * Dh

struct Strides {
  long long qb, qs, qh, kb, ks, kh, vb, vs, vh;
};

template <int DH>
struct Tile {
  static constexpr int R = kTileElems / DH;  // rows per tile: 64 or 16
  static constexpr int P = DH + 1;           // padded row pitch of a [R][DH] tile
  static constexpr int PR = R + 1;           // padded row pitch of a [R][R] tile
  static constexpr int kScores = R * R / kThreads;  // (row, key) pairs per thread
  static constexpr int kOut = R * DH / kThreads;    // output values per thread
  static_assert(R * R % kThreads == 0 && R * DH % kThreads == 0, "tile split");
};

// rows [r0, r0 + R) of one head of x (row stride rs, element 0 at base) into
// a padded tile; rows at or past S are zero
template <int DH>
__device__ __forceinline__ void load_tile(float* tile, const float* base, long long rs, int r0,
                                          int S) {
  constexpr int R = Tile<DH>::R, P = Tile<DH>::P;
  for (int idx = threadIdx.x; idx < R * DH; idx += kThreads) {
    const int rr = idx / DH, d = idx % DH;
    const int row = r0 + rr;
    tile[rr * P + d] = row < S ? base[row * rs + d] : 0.f;
  }
}

// the per-row lse and D of query rows [q0, q0 + R) of head (b, h)
__device__ __forceinline__ void load_rows(float* Ls, float* Ds, const float* lse,
                                          const float* delta, size_t head_row0, int q0, int S,
                                          int R) {
  for (int r = threadIdx.x; r < R; r += kThreads) {
    const int row = q0 + r;
    Ls[r] = row < S ? lse[head_row0 + row] : 0.f;
    Ds[r] = row < S ? delta[head_row0 + row] : 0.f;
  }
}

// P and dS of the pair (query row q0 + r, key row k0 + c) from the tiles;
// both 0 where the key lies past the row or the row past S
template <int DH>
__device__ __forceinline__ void prob_and_ds(const float* Qs, const float* Ks, const float* Vs,
                                            const float* dOs, const float* Ls, const float* Ds,
                                            int r, int c, int q0, int k0, int S, float scale,
                                            float& p, float& ds) {
  constexpr int P = Tile<DH>::P;
  const int qi = q0 + r, kj = k0 + c;
  p = 0.f;
  ds = 0.f;
  if (qi < S && kj <= qi) {
    float s = 0.f, dp = 0.f;
#pragma unroll 16
    for (int d = 0; d < DH; ++d) {
      s += Qs[r * P + d] * Ks[c * P + d];
      dp += dOs[r * P + d] * Vs[c * P + d];
    }
    p = expf(s * scale - Ls[r]);
    ds = p * (dp - Ds[r]);
  }
}

// D[b, h, s] = sum_d dout * out, one warp per (b, s, h) row
template <typename T, int DH>
__global__ void __launch_bounds__(kThreads) delta_kernel(const T* __restrict__ out,
                                                         const T* __restrict__ dout,
                                                         float* __restrict__ delta, int S, int H,
                                                         long long rows) {
  const long long row = static_cast<long long>(blockIdx.x) * (kThreads / 32) + (threadIdx.x >> 5);
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

template <int DH>
__global__ void __launch_bounds__(kThreads) dkdv_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, float* __restrict__ dk, float* __restrict__ dv, int S,
    int H, int groups, Strides st, float scale) {
  using Tl = Tile<DH>;
  constexpr int R = Tl::R, P = Tl::P, PR = Tl::PR;
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + R * P;
  float* Qs = Vs + R * P;
  float* dOs = Qs + R * P;
  float* Ps = dOs + R * P;  // P, for dv
  float* dSs = Ps + R * PR;
  float* Ls = dSs + R * PR;
  float* Ds = Ls + R;

  const int hkv = H / groups;
  const int b = blockIdx.x / hkv;
  const int hk = blockIdx.x % hkv;
  const int k0 = blockIdx.y * R;
  load_tile<DH>(Ks, k + b * st.kb + hk * st.kh, st.ks, k0, S);
  load_tile<DH>(Vs, v + b * st.vb + hk * st.vh, st.vs, k0, S);

  float acc_k[Tl::kOut], acc_v[Tl::kOut];
#pragma unroll
  for (int i = 0; i < Tl::kOut; ++i) acc_k[i] = acc_v[i] = 0.f;

  const int n_tiles = (S + R - 1) / R;
  for (int g = 0; g < groups; ++g) {
    const int h = hk * groups + g;
    const size_t head_row0 = (static_cast<size_t>(b) * H + h) * S;
    // query tiles on or below the diagonal: the first holds query row k0
    for (int qt = blockIdx.y; qt < n_tiles; ++qt) {
      const int q0 = qt * R;
      __syncthreads();  // the last tile's reads are done
      load_tile<DH>(Qs, q + b * st.qb + h * st.qh, st.qs, q0, S);
      load_tile<DH>(dOs, dout + static_cast<size_t>(b) * S * H * DH + h * DH,
                       static_cast<long long>(H) * DH, q0, S);
      load_rows(Ls, Ds, lse, delta, head_row0, q0, S, R);
      __syncthreads();
#pragma unroll
      for (int i = 0; i < Tl::kScores; ++i) {
        const int e = threadIdx.x + kThreads * i;
        const int r = e / R, c = e % R;
        float p, ds;
        prob_and_ds<DH>(Qs, Ks, Vs, dOs, Ls, Ds, r, c, q0, k0, S, scale, p, ds);
        Ps[r * PR + c] = p;
        dSs[r * PR + c] = ds;
      }
      __syncthreads();
#pragma unroll
      for (int i = 0; i < Tl::kOut; ++i) {
        const int e = threadIdx.x + kThreads * i;
        const int j = e / DH, d = e % DH;
        float av = acc_v[i], ak = acc_k[i];
#pragma unroll 8
        for (int r = 0; r < R; ++r) {
          av += Ps[r * PR + j] * dOs[r * P + d];
          ak += dSs[r * PR + j] * Qs[r * P + d];
        }
        acc_v[i] = av;
        acc_k[i] = ak;
      }
    }
  }
#pragma unroll
  for (int i = 0; i < Tl::kOut; ++i) {
    const int e = threadIdx.x + kThreads * i;
    const int j = e / DH, d = e % DH;
    const int row = k0 + j;
    if (row < S) {
      const size_t at = ((static_cast<size_t>(b) * S + row) * hkv + hk) * DH + d;
      dk[at] = acc_k[i] * scale;
      dv[at] = acc_v[i];
    }
  }
}

template <int DH>
__global__ void __launch_bounds__(kThreads) dq_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, float* __restrict__ dq, int S, int H, int groups,
    Strides st, float scale) {
  using Tl = Tile<DH>;
  constexpr int R = Tl::R, P = Tl::P, PR = Tl::PR;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* dOs = Qs + R * P;
  float* Ks = dOs + R * P;
  float* Vs = Ks + R * P;
  float* dSs = Vs + R * P;
  float* Ls = dSs + R * PR;
  float* Ds = Ls + R;

  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int hk = h / groups;
  const int q0 = blockIdx.y * R;
  load_tile<DH>(Qs, q + b * st.qb + h * st.qh, st.qs, q0, S);
  load_tile<DH>(dOs, dout + static_cast<size_t>(b) * S * H * DH + h * DH,
                static_cast<long long>(H) * DH, q0, S);
  load_rows(Ls, Ds, lse, delta, (static_cast<size_t>(b) * H + h) * S, q0, S, R);

  float acc[Tl::kOut];
#pragma unroll
  for (int i = 0; i < Tl::kOut; ++i) acc[i] = 0.f;
  const int last_q = min(S, q0 + R) - 1;
  for (int kt = 0; kt <= last_q / R; ++kt) {
    const int k0 = kt * R;
    __syncthreads();  // the last tile's reads are done
    load_tile<DH>(Ks, k + b * st.kb + hk * st.kh, st.ks, k0, S);
    load_tile<DH>(Vs, v + b * st.vb + hk * st.vh, st.vs, k0, S);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < Tl::kScores; ++i) {
      const int e = threadIdx.x + kThreads * i;
      const int r = e / R, c = e % R;
      float p, ds;
      prob_and_ds<DH>(Qs, Ks, Vs, dOs, Ls, Ds, r, c, q0, k0, S, scale, p, ds);
      dSs[r * PR + c] = ds;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < Tl::kOut; ++i) {
      const int e = threadIdx.x + kThreads * i;
      const int r = e / DH, d = e % DH;
      float a = acc[i];
#pragma unroll 8
      for (int c = 0; c < R; ++c) a += dSs[r * PR + c] * Ks[c * P + d];
      acc[i] = a;
    }
  }
#pragma unroll
  for (int i = 0; i < Tl::kOut; ++i) {
    const int e = threadIdx.x + kThreads * i;
    const int r = e / DH, d = e % DH;
    if (q0 + r < S)
      dq[((static_cast<size_t>(b) * S + q0 + r) * H + h) * DH + d] = acc[i] * scale;
  }
}

template <int DH>
constexpr size_t dkdv_smem() {
  using Tl = Tile<DH>;
  return sizeof(float) * (4 * Tl::R * Tl::P + 2 * Tl::R * Tl::PR + 2 * Tl::R);
}

template <int DH>
constexpr size_t dq_smem() {
  using Tl = Tile<DH>;
  return sizeof(float) * (4 * Tl::R * Tl::P + Tl::R * Tl::PR + 2 * Tl::R);
}

// D = rowsum(dout * out), one warp per (b, s, h) row
template <typename T, int DH>
int launch_delta(const T* out, const T* dout, float* delta, int B, int S, int H,
                 cudaStream_t stream) {
  const long long rows = static_cast<long long>(B) * S * H;
  const int warps = kThreads / 32;
  delta_kernel<T, DH><<<static_cast<unsigned int>((rows + warps - 1) / warps), kThreads, 0,
                        stream>>>(out, dout, delta, S, H, rows);
  return mm::last_error();
}

template <int DH>
int launch_dh(const void* q, const void* k, const void* v, const void* out, const void* dout,
              const float* lse, float* delta, void* dq, void* dk, void* dv, int B, int S, int H,
              int Hkv, const long long* st, cudaStream_t stream) {
  constexpr int R = Tile<DH>::R;
  const Strides strides{st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8]};
  const float scale = 1.0f / sqrtf(static_cast<float>(DH));
  const float* qt = static_cast<const float*>(q);
  const float* kt = static_cast<const float*>(k);
  const float* vt = static_cast<const float*>(v);
  const float* gt = static_cast<const float*>(dout);
  cudaError_t e = cudaFuncSetAttribute(dkdv_kernel<DH>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(dkdv_smem<DH>()));
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaFuncSetAttribute(dq_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(dq_smem<DH>()));
  if (e != cudaSuccess) return static_cast<int>(e);

  int err = launch_delta<float, DH>(static_cast<const float*>(out), gt, delta, B, S, H, stream);
  if (err) return err;
  const int tiles = (S + R - 1) / R;
  dkdv_kernel<DH><<<dim3(B * Hkv, tiles), kThreads, dkdv_smem<DH>(), stream>>>(
      qt, kt, vt, gt, lse, delta, static_cast<float*>(dk), static_cast<float*>(dv), S, H,
      H / Hkv, strides, scale);
  if ((err = mm::last_error())) return err;
  dq_kernel<DH><<<dim3(B * H, tiles), kThreads, dq_smem<DH>(), stream>>>(
      qt, kt, vt, gt, lse, delta, static_cast<float*>(dq), S, H, H / Hkv, strides, scale);
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

// ---- bf16, Dh 256: packed rows on the CUDA cores ---------------------------------

namespace rows {

using namespace mm::sm90;
using bf16 = __nv_bfloat16;

constexpr int kRows = 4;   // key rows (dk/dv) or query rows (dq) a warp owns
constexpr int kWarps = 4;  // warps a block

__device__ __forceinline__ void ld8(const bf16* p, float (&f)[8]) {
  unpack8(*reinterpret_cast<const uint4*>(p), f);
}

__device__ __forceinline__ float dot8(const float (&a)[8], const float (&b)[8]) {
  float d = 0.f;
#pragma unroll
  for (int e = 0; e < 8; ++e) d = fmaf(a[e], b[e], d);
  return d;
}

__global__ void __launch_bounds__(kWarps * 32) dkdv_rows256_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ delta,
    bf16* __restrict__ dk, bf16* __restrict__ dv, int S, int H, int groups, int n_t,
    long long bh_count, Strides st, float scale, float scale_log2) {
  const int lane = threadIdx.x & 31;
  const long long item = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (item >= bh_count * n_t) return;
  const int kt = static_cast<int>(item / bh_count);  // key tile 0 (every query row) first
  const long long bh = item % bh_count;
  const int hkv = H / groups;
  const int b = static_cast<int>(bh / hkv), hk = static_cast<int>(bh % hkv);
  const int k0 = kt * kRows;
  float kf[kRows][8], vf[kRows][8], dka[kRows][8], dva[kRows][8];
#pragma unroll
  for (int j = 0; j < kRows; ++j) {
#pragma unroll
    for (int e = 0; e < 8; ++e) kf[j][e] = vf[j][e] = dka[j][e] = dva[j][e] = 0.f;
    if (k0 + j < S) {
      ld8(k + b * st.kb + hk * st.kh + (k0 + j) * st.ks + lane * 8, kf[j]);
      ld8(v + b * st.vb + hk * st.vh + (k0 + j) * st.vs + lane * 8, vf[j]);
    }
  }
  for (int g = 0; g < groups; ++g) {
    const int h = hk * groups + g;
    const bf16* qb = q + b * st.qb + h * st.qh + lane * 8;
    const bf16* gb = dout + (static_cast<size_t>(b) * S * H + h) * 256 + lane * 8;
    const size_t row0 = (static_cast<size_t>(b) * H + h) * S;
    for (int i = k0; i < S; ++i) {  // the query rows that see a key of the tile
      float qf[8], gf[8];
      ld8(qb + i * st.qs, qf);
      ld8(gb + static_cast<size_t>(i) * H * 256, gf);
      const float lse2 = lse[row0 + i] * kLog2e, di = delta[row0 + i];
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        if (k0 + j > i) break;
        const float s = mm::warp_sum(dot8(qf, kf[j]));
        const float dp = mm::warp_sum(dot8(gf, vf[j]));
        const float p = exp2f(fmaf(s, scale_log2, -lse2));
        const float ds = p * (dp - di);
        const float pb = round_bf16(p);  // as the plain version's dv
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          dva[j][e] = fmaf(pb, gf[e], dva[j][e]);
          dka[j][e] = fmaf(ds, qf[e], dka[j][e]);
        }
      }
    }
  }
#pragma unroll
  for (int j = 0; j < kRows; ++j) {
    if (k0 + j >= S) break;
    const size_t at = ((static_cast<size_t>(b) * S + k0 + j) * hkv + hk) * 256 + lane * 8;
    float r8[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) r8[e] = dka[j][e] * scale;
    *reinterpret_cast<uint4*>(dk + at) = pack8(r8);
    *reinterpret_cast<uint4*>(dv + at) = pack8(dva[j]);
  }
}

__global__ void __launch_bounds__(kWarps * 32) dq_rows256_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ delta,
    bf16* __restrict__ dq, int S, int H, int groups, int n_t, long long bh_count, Strides st,
    float scale, float scale_log2) {
  const int lane = threadIdx.x & 31;
  const long long item = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (item >= bh_count * n_t) return;
  const int qt = n_t - 1 - static_cast<int>(item / bh_count);  // the longest first
  const long long bh = item % bh_count;
  const int b = static_cast<int>(bh / H), h = static_cast<int>(bh % H), hk = h / groups;
  const int q0 = qt * kRows;
  const size_t row0 = (static_cast<size_t>(b) * H + h) * S;
  float qf[kRows][8], gf[kRows][8], acc[kRows][8], lse2[kRows], di[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
#pragma unroll
    for (int e = 0; e < 8; ++e) qf[i][e] = gf[i][e] = acc[i][e] = 0.f;
    lse2[i] = di[i] = 0.f;
    if (q0 + i < S) {
      ld8(q + b * st.qb + h * st.qh + (q0 + i) * st.qs + lane * 8, qf[i]);
      ld8(dout + ((static_cast<size_t>(b) * S + q0 + i) * H + h) * 256 + lane * 8, gf[i]);
      lse2[i] = lse[row0 + q0 + i] * kLog2e;
      di[i] = delta[row0 + q0 + i];
    }
  }
  const bf16* kb = k + b * st.kb + hk * st.kh + lane * 8;
  const bf16* vb = v + b * st.vb + hk * st.vh + lane * 8;
  const int last = min(S, q0 + kRows) - 1;
  for (int j = 0; j <= last; ++j) {
    float kf[8], vf[8];
    ld8(kb + j * st.ks, kf);
    ld8(vb + j * st.vs, vf);
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      if (j > q0 + i || q0 + i >= S) continue;
      const float s = mm::warp_sum(dot8(qf[i], kf));
      const float dp = mm::warp_sum(dot8(gf[i], vf));
      const float ds = exp2f(fmaf(s, scale_log2, -lse2[i])) * (dp - di[i]);
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[i][e] = fmaf(ds, kf[e], acc[i][e]);
    }
  }
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    if (q0 + i >= S) break;
    float r8[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) r8[e] = acc[i][e] * scale;
    *reinterpret_cast<uint4*>(dq + ((static_cast<size_t>(b) * S + q0 + i) * H + h) * 256 +
                              lane * 8) = pack8(r8);
  }
}

int launch(const void* q, const void* k, const void* v, const void* out, const void* dout,
           const float* lse, float* delta, void* dq, void* dk, void* dv, int B, int S, int H,
           int Hkv, const long long* st, cudaStream_t stream) {
  const Strides strides{st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8]};
  const int n_t = (S + kRows - 1) / kRows;
  const long long dq_blocks = (static_cast<long long>(B) * H * n_t + kWarps - 1) / kWarps;
  const long long dkdv_blocks = (static_cast<long long>(B) * Hkv * n_t + kWarps - 1) / kWarps;
  if (dq_blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidConfiguration);
  const bf16* qt = static_cast<const bf16*>(q);
  const bf16* kt = static_cast<const bf16*>(k);
  const bf16* vt = static_cast<const bf16*>(v);
  const bf16* gt = static_cast<const bf16*>(dout);
  int err = launch_delta<bf16, 256>(static_cast<const bf16*>(out), gt, delta, B, S, H, stream);
  if (err) return err;
  const float scale = 0.0625f;  // 256**-0.5
  dkdv_rows256_kernel<<<static_cast<unsigned int>(dkdv_blocks), kWarps * 32, 0, stream>>>(
      qt, kt, vt, gt, lse, delta, static_cast<bf16*>(dk), static_cast<bf16*>(dv), S, H, H / Hkv,
      n_t, static_cast<long long>(B) * Hkv, strides, scale, scale * kLog2e);
  if ((err = mm::last_error())) return err;
  dq_rows256_kernel<<<static_cast<unsigned int>(dq_blocks), kWarps * 32, 0, stream>>>(
      qt, kt, vt, gt, lse, delta, static_cast<bf16*>(dq), S, H, H / Hkv, n_t,
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
    case 64:
      return launch_dh<64>(q, k, v, out, dout, l, dl, dq, dk, dv, B, S, H, Hkv, st, s);
    case 256:
      return launch_dh<256>(q, k, v, out, dout, l, dl, dq, dk, dv, B, S, H, Hkv, st, s);
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
    case 256: return rows::launch(q, k, v, out, dout, l, dl, dq, dk, dv, B, S, H, Hkv, st, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q, k, v: [B, S, H | Hkv, Dh] by strides [q_b, q_s, q_h, k_b, k_s, k_h, v_b,
// v_s, v_h] (elements; the last dim contiguous; for bf16 16-byte aligned
// with strides that are multiples of 8); out, dout, dq: contiguous
// [B, S, H, Dh]; dk, dv: contiguous [B, S, Hkv, Dh]; lse: the forward's f32
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
