// Causal attention backward (FlashAttention-2 form, recomputed from the LSE).
//
// Replaces: the backward of midi_model_tpu/ops/attention.py
// splash_causal_attention (JAX's shipped Pallas TPU splash kernel, whose
// dq/dkv backward is fused: use_fused_bwd_kernel=True, attention.py:131),
// reached from training (train/trainer.py through llama.forward).
//
// What it computes (the plain version is
// midi_model_tpu_torch/ops/attention.py, causal_attention_backward_reference),
// for the forward out = P_T @ v with P = softmax_t<=s(q . k * Dh**-0.5) and
// P_T its rounding to the input dtype T: from q, k, v [B, S, H | Hkv, Dh]
// (any strides with a contiguous last dim), out and dout (contiguous
// [B, S, H, Dh]) and the forward's f32 log-sum-exp lse [B, H, S]:
//   D  = rowsum(dout * out)                  (f32, per query row and head)
//   P  = exp(q . k * scale - lse)            (recomputed, causal mask)
//   dv = P_T^T dout                          (P rounded to T, as the forward)
//   dS = P * (dout . v - D)
//   dq = dS k * scale,  dk = dS^T q * scale
// GQA: a kv head's dk / dv sum over its H / Hkv query heads (JAX's
// jnp.repeat of k and v, attention.py:155-157).  Any S (the ragged last
// tile is masked on both the query and the key side), Dh 64 (the event
// net) or 256 (the token net), bf16 or f32 in and out, f32 math.
//
// What bounds it on an H100: operations.  Five S x S x Dh products per
// (batch, head) over the causal half (2.5x the forward), against one read
// of q, k, v, out, dout, lse and one write of dq, dk, dv.  This first
// version runs them on the CUDA cores in f32 (no tensor cores, no
// wgmma/TMA); what it buys is that no S x S tensor reaches device memory.
//
// Design: three launches, no atomics.  (1) D, one warp per (row, head).
// (2) dk/dv: grid (B*Hkv, key tiles); a block holds one key/value tile and
// walks every query tile on or below the diagonal for each query head of
// its kv head, accumulating dk and dv in registers.  (3) dq: grid (B*H,
// query tiles); a block holds one query tile and walks the key tiles up to
// the diagonal.  Both recompute the scores and dS (FlashAttention-2's
// two-kernel split trades that recompute for no atomics).  Tiles are R rows
// of f32 in shared memory, padded to dodge bank conflicts, with R * Dh =
// 4096: R = 64 at Dh 64 (100 KB of tiles), R = 16 at Dh 256 (68 KB; the
// token net's sequences are 8 rows long) — 16 output values per thread.
#include "common.cuh"

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
// a padded f32 tile; rows at or past S are zero
template <typename T, int DH>
__device__ __forceinline__ void load_tile(float* tile, const T* base, long long rs, int r0,
                                          int S) {
  constexpr int R = Tile<DH>::R, P = Tile<DH>::P;
  for (int idx = threadIdx.x; idx < R * DH; idx += kThreads) {
    const int rr = idx / DH, d = idx % DH;
    const int row = r0 + rr;
    tile[rr * P + d] = row < S ? mm::to_f32(base[row * rs + d]) : 0.f;
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

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads) dkdv_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ delta,
    T* __restrict__ dk, T* __restrict__ dv, int S, int H, int groups, Strides st, float scale) {
  using Tl = Tile<DH>;
  constexpr int R = Tl::R, P = Tl::P, PR = Tl::PR;
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + R * P;
  float* Qs = Vs + R * P;
  float* dOs = Qs + R * P;
  float* Ps = dOs + R * P;  // P rounded to T, for dv
  float* dSs = Ps + R * PR;
  float* Ls = dSs + R * PR;
  float* Ds = Ls + R;

  const int hkv = H / groups;
  const int b = blockIdx.x / hkv;
  const int hk = blockIdx.x % hkv;
  const int k0 = blockIdx.y * R;
  load_tile<T, DH>(Ks, k + b * st.kb + hk * st.kh, st.ks, k0, S);
  load_tile<T, DH>(Vs, v + b * st.vb + hk * st.vh, st.vs, k0, S);

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
      load_tile<T, DH>(Qs, q + b * st.qb + h * st.qh, st.qs, q0, S);
      load_tile<T, DH>(dOs, dout + static_cast<size_t>(b) * S * H * DH + h * DH,
                       static_cast<long long>(H) * DH, q0, S);
      load_rows(Ls, Ds, lse, delta, head_row0, q0, S, R);
      __syncthreads();
#pragma unroll
      for (int i = 0; i < Tl::kScores; ++i) {
        const int e = threadIdx.x + kThreads * i;
        const int r = e / R, c = e % R;
        float p, ds;
        prob_and_ds<DH>(Qs, Ks, Vs, dOs, Ls, Ds, r, c, q0, k0, S, scale, p, ds);
        Ps[r * PR + c] = mm::to_f32(mm::from_f32<T>(p));
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
      dk[at] = mm::from_f32<T>(acc_k[i] * scale);
      dv[at] = mm::from_f32<T>(acc_v[i]);
    }
  }
}

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads) dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ delta,
    T* __restrict__ dq, int S, int H, int groups, Strides st, float scale) {
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
  load_tile<T, DH>(Qs, q + b * st.qb + h * st.qh, st.qs, q0, S);
  load_tile<T, DH>(dOs, dout + static_cast<size_t>(b) * S * H * DH + h * DH,
                   static_cast<long long>(H) * DH, q0, S);
  load_rows(Ls, Ds, lse, delta, (static_cast<size_t>(b) * H + h) * S, q0, S, R);

  float acc[Tl::kOut];
#pragma unroll
  for (int i = 0; i < Tl::kOut; ++i) acc[i] = 0.f;
  const int last_q = min(S, q0 + R) - 1;
  for (int kt = 0; kt <= last_q / R; ++kt) {
    const int k0 = kt * R;
    __syncthreads();  // the last tile's reads are done
    load_tile<T, DH>(Ks, k + b * st.kb + hk * st.kh, st.ks, k0, S);
    load_tile<T, DH>(Vs, v + b * st.vb + hk * st.vh, st.vs, k0, S);
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
      dq[((static_cast<size_t>(b) * S + q0 + r) * H + h) * DH + d] = mm::from_f32<T>(acc[i] * scale);
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

template <typename T, int DH>
int launch_dh(const void* q, const void* k, const void* v, const void* out, const void* dout,
              const float* lse, float* delta, void* dq, void* dk, void* dv, int B, int S, int H,
              int Hkv, const long long* st, cudaStream_t stream) {
  constexpr int R = Tile<DH>::R;
  const Strides strides{st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8]};
  const float scale = 1.0f / sqrtf(static_cast<float>(DH));
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* gt = static_cast<const T*>(dout);
  cudaError_t e = cudaFuncSetAttribute(dkdv_kernel<T, DH>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(dkdv_smem<DH>()));
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaFuncSetAttribute(dq_kernel<T, DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(dq_smem<DH>()));
  if (e != cudaSuccess) return static_cast<int>(e);

  const long long rows = static_cast<long long>(B) * S * H;
  const int warps = kThreads / 32;
  delta_kernel<T, DH><<<static_cast<unsigned int>((rows + warps - 1) / warps), kThreads, 0,
                        stream>>>(static_cast<const T*>(out), gt, delta, S, H, rows);
  int err = mm::last_error();
  if (err) return err;
  const int tiles = (S + R - 1) / R;
  dkdv_kernel<T, DH><<<dim3(B * Hkv, tiles), kThreads, dkdv_smem<DH>(), stream>>>(
      qt, kt, vt, gt, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), S, H, H / Hkv,
      strides, scale);
  if ((err = mm::last_error())) return err;
  dq_kernel<T, DH><<<dim3(B * H, tiles), kThreads, dq_smem<DH>(), stream>>>(
      qt, kt, vt, gt, lse, delta, static_cast<T*>(dq), S, H, H / Hkv, strides, scale);
  return mm::last_error();
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* out, const void* dout,
           const void* lse, void* delta, void* dq, void* dk, void* dv, int B, int S, int H,
           int Hkv, int Dh, const long long* st, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  switch (Dh) {
    case 64: return launch_dh<T, 64>(q, k, v, out, dout, l, dl, dq, dk, dv, B, S, H, Hkv, st, s);
    case 256: return launch_dh<T, 256>(q, k, v, out, dout, l, dl, dq, dk, dv, B, S, H, Hkv, st, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q, k, v: [B, S, H | Hkv, Dh] by strides [q_b, q_s, q_h, k_b, k_s, k_h, v_b,
// v_s, v_h] (elements; the last dim contiguous); out, dout, dq: contiguous
// [B, S, H, Dh]; dk, dv: contiguous [B, S, Hkv, Dh]; lse: the forward's f32
// [B, H, S]; delta: f32 [B, H, S] scratch.
extern "C" int mm_causal_attention_bwd_f32(const void* q, const void* k, const void* v,
                                           const void* out, const void* dout, const void* lse,
                                           void* delta, void* dq, void* dk, void* dv, int B,
                                           int S, int H, int Hkv, int Dh,
                                           const long long* strides, void* stream) {
  return launch<float>(q, k, v, out, dout, lse, delta, dq, dk, dv, B, S, H, Hkv, Dh, strides,
                       stream);
}

extern "C" int mm_causal_attention_bwd_bf16(const void* q, const void* k, const void* v,
                                            const void* out, const void* dout, const void* lse,
                                            void* delta, void* dq, void* dk, void* dv, int B,
                                            int S, int H, int Hkv, int Dh,
                                            const long long* strides, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, out, dout, lse, delta, dq, dk, dv, B, S, H, Hkv, Dh,
                               strides, stream);
}
