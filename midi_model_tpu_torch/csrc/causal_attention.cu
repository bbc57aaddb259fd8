// Causal attention forward (flash style, online softmax).
//
// Replaces: the forward of midi_model_tpu/ops/attention.py
// splash_causal_attention / flash_causal_attention (JAX's shipped Pallas TPU
// splash and flash kernels), reached from llama.prefill_paged.
//
// What it computes: out[b, s, h, :] = softmax_t<=s(q[b,s,h,:] . k[b,t,hk,:]
// * Dh**-0.5) @ v[b, t, hk, :] with hk = h / (H / Hkv), inputs [B, S, H, Dh]
// given by strides (no transpose copy), any S, Dh 64 (the event net) or 256
// (the token net, in its cacheless forward; its tiles fill 214 KB of shared
// memory), bf16 or f32 in and out.  When the caller passes an lse buffer
// (training: the backward, causal_attention_bwd.cu, recomputes the softmax
// from it) each row's f32 log-sum-exp of its scaled scores goes there too,
// [B, H, S].
//
// What bounds it on an H100: at prefill shapes (S in the thousands, Dh = 64)
// it is compute: 4 * S^2 * Dh / 2 flops per (batch, head) against 4 * S * Dh
// bytes.  This first version runs its products on the CUDA cores in f32 (no
// tensor cores, no wgmma/TMA), so it is far from the card's bf16 peak; what
// it does buy is that the [B, H, S, S] score tensor never reaches device
// memory (the plain version writes and rereads it).
//
// Design: grid (B*H, ceil(S/64)).  A block of 256 threads holds one 64-row
// query tile in shared memory and walks 64-row K/V tiles up to the causal
// edge.  Four threads share a query row: each scores 16 of the tile's 64
// keys, the row max and sum are reduced over the four with shuffles, the
// probabilities go to shared memory, and each thread then accumulates Dh/4
// output dims.  Softmax statistics and the accumulator stay in f32; the
// output is normalized once at the end and rounded to the input dtype.
#include "common.cuh"

namespace {

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kThreads = 256;  // 4 threads per query row
constexpr int kKeysPerThread = kBlockK / 4;

template <int DH>
constexpr size_t smem_bytes() {
  // Q, K, V tiles [64][DH+1] and P [64][65], all f32 (padding avoids bank conflicts)
  return sizeof(float) * (3 * kBlockQ * (DH + 1) + kBlockQ * (kBlockK + 1));
}

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
causal_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, T* __restrict__ out, float* __restrict__ lse,
                        int S, int H, int groups,
                        long long qsb, long long qss, long long qsh, long long ksb,
                        long long kss, long long ksh, long long vsb, long long vss,
                        long long vsh, float scale) {
  constexpr int P = DH + 1;
  constexpr int DPT = DH / 4;  // output dims per thread
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + kBlockQ * P;
  float* Vs = Ks + kBlockK * P;
  float* Ps = Vs + kBlockK * P;

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh % H;
  const int hk = h / groups;
  const int q0 = blockIdx.y * kBlockQ;
  const int r = threadIdx.x >> 2;   // query row within the tile
  const int sub = threadIdx.x & 3;  // which quarter of keys / dims
  const int qi = q0 + r;

  const T* qb = q + b * qsb + h * qsh;
  const T* kb = k + b * ksb + hk * ksh;
  const T* vb = v + b * vsb + hk * vsh;

  for (int idx = threadIdx.x; idx < kBlockQ * DH; idx += kThreads) {
    const int rr = idx / DH, d = idx % DH;
    const int row = q0 + rr;
    Qs[rr * P + d] = row < S ? mm::to_f32(qb[row * qss + d]) : 0.f;
  }

  float m_i = -CUDART_INF_F;
  float l_i = 0.f;
  float acc[DPT];
#pragma unroll
  for (int e = 0; e < DPT; ++e) acc[e] = 0.f;

  const int last_q = min(S, q0 + kBlockQ) - 1;
  const int n_tiles = last_q / kBlockK + 1;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kBlockK;
    __syncthreads();  // the previous tile's K/V reads are done
    for (int idx = threadIdx.x; idx < kBlockK * DH; idx += kThreads) {
      const int rr = idx / DH, d = idx % DH;
      const int row = k0 + rr;
      Ks[rr * P + d] = row < S ? mm::to_f32(kb[row * kss + d]) : 0.f;
      Vs[rr * P + d] = row < S ? mm::to_f32(vb[row * vss + d]) : 0.f;
    }
    __syncthreads();

    float s[kKeysPerThread];
    float mx = -CUDART_INF_F;
#pragma unroll
    for (int c = 0; c < kKeysPerThread; ++c) {
      const int j = sub + 4 * c;
      const int kj = k0 + j;
      float dot = 0.f;
#pragma unroll 16
      for (int d = 0; d < DH; ++d) dot += Qs[r * P + d] * Ks[j * P + d];
      s[c] = (kj <= qi && kj < S) ? dot * scale : -CUDART_INF_F;
      mx = fmaxf(mx, s[c]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m_i, mx);
    // m_new = -inf only while a row has seen no key (never for a real row
    // after tile 0, which always holds key 0)
    const float corr = m_new == -CUDART_INF_F ? 1.f : expf(m_i - m_new);
    float psum = 0.f;
#pragma unroll
    for (int c = 0; c < kKeysPerThread; ++c) {
      const float p = s[c] == -CUDART_INF_F ? 0.f : expf(s[c] - m_new);
      Ps[r * (kBlockK + 1) + sub + 4 * c] = p;
      psum += p;
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    psum += __shfl_xor_sync(0xffffffffu, psum, 2);
    l_i = l_i * corr + psum;
    m_i = m_new;
    __syncwarp();  // a row's P is written and read by the same four lanes

#pragma unroll
    for (int e = 0; e < DPT; ++e) acc[e] *= corr;
    for (int j = 0; j < kBlockK; ++j) {
      const float p = Ps[r * (kBlockK + 1) + j];
#pragma unroll
      for (int e = 0; e < DPT; ++e) acc[e] += p * Vs[j * P + sub + 4 * e];
    }
  }

  if (qi < S) {
    const float inv = l_i > 0.f ? 1.f / l_i : 0.f;
    T* ob = out + ((static_cast<size_t>(b) * S + qi) * H + h) * DH;
#pragma unroll
    for (int e = 0; e < DPT; ++e) ob[sub + 4 * e] = mm::from_f32<T>(acc[e] * inv);
    if (lse != nullptr && sub == 0)  // the row's m and l: every real row saw key 0
      lse[(static_cast<size_t>(b) * H + h) * S + qi] = m_i + logf(l_i);
  }
}

template <typename T, int DH>
int launch_dh(const void* q, const void* k, const void* v, void* out, float* lse, int B, int S,
              int H, int Hkv, const long long* st, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<DH>();
  cudaError_t e = cudaFuncSetAttribute(causal_attention_kernel<T, DH>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(B * H, (S + kBlockQ - 1) / kBlockQ);
  causal_attention_kernel<T, DH><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), lse, S, H, H / Hkv, st[0], st[1], st[2], st[3], st[4], st[5], st[6],
      st[7], st[8], 1.0f / sqrtf(static_cast<float>(DH)));
  return mm::last_error();
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, void* lse, int B, int S,
           int H, int Hkv, int Dh, const long long* st, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  switch (Dh) {
    case 64: return launch_dh<T, 64>(q, k, v, out, l, B, S, H, Hkv, st, s);    // event net
    case 256: return launch_dh<T, 256>(q, k, v, out, l, B, S, H, Hkv, st, s);  // token net
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// strides: [q_b, q_s, q_h, k_b, k_s, k_h, v_b, v_s, v_h] in elements; the
// last dim of each input is contiguous; out is a contiguous [B, S, H, Dh];
// lse: null, or a contiguous f32 [B, H, S] for the rows' log-sum-exp.
extern "C" int mm_causal_attention_f32(const void* q, const void* k, const void* v, void* out,
                                       void* lse, int B, int S, int H, int Hkv, int Dh,
                                       const long long* strides, void* stream) {
  return launch<float>(q, k, v, out, lse, B, S, H, Hkv, Dh, strides, stream);
}

extern "C" int mm_causal_attention_bf16(const void* q, const void* k, const void* v, void* out,
                                        void* lse, int B, int S, int H, int Hkv, int Dh,
                                        const long long* strides, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, out, lse, B, S, H, Hkv, Dh, strides, stream);
}
