// Causal attention forward (flash style, online softmax).
//
// Replaces: the forward of midi_model_tpu/ops/attention.py
// splash_causal_attention / flash_causal_attention (JAX's shipped Pallas TPU
// splash and flash kernels), reached from llama.prefill_paged and training.
//
// What it computes: out[b, s, h, :] = softmax_t<=s(q[b,s,h,:] . k[b,t,hk,:]
// * Dh**-0.5) @ v[b, t, hk, :] with hk = h / (H / Hkv), inputs [B, S, H, Dh]
// given by strides (no transpose copy), any S, Dh 64 (the event net) or 256
// (the token net, in its cacheless forward), bf16 or f32 in and out.  When
// the caller passes an lse buffer (training: the backward,
// causal_attention_bwd.cu, recomputes the softmax from it) each row's f32
// natural-log log-sum-exp of its scaled scores goes there too, [B, H, S].
//
// What bounds it on an H100: at the event net's shapes (S in the hundreds
// to thousands, Dh 64), operations — 4 * S^2 * Dh / 2 flops per (batch,
// head) against 4 * S * Dh bytes; at the token net's (8-row sequences, Dh
// 256), bytes.  Three kernels:
//
// * bf16, Dh 64 (fwd_wgmma_kernel): prefill and the event net's training
//   forward, so its products run on Hopper's tensor cores.
//   A block takes 128 query rows of one (b, h): two consumer warpgroups of
//   64 rows and one producer warp.  The producer keeps 128-key K/V tiles in
//   flight with TMA (cp.async.bulk.tensor over 4-d tensor maps built on the
//   host from the caller's strides, 128-byte swizzle, rows past S
//   zero-filled) into a 3-stage ring guarded by full/empty mbarriers.  Each
//   consumer warpgroup computes S = Q.K^T with wgmma (both operands in shared
//   memory), the online softmax in f32 registers (exp2 with scale * log2(e)
//   folded into one FMA; only the diagonal tile is masked, tiles above it are
//   never loaded), converts P to bf16 in registers and runs P.V with wgmma's
//   register-A form (V N-major in shared memory): the score tile never
//   leaves registers.  Blocks of the last (longest) query tiles launch
//   first.  No setmaxnreg: at 288 threads a block may hold 224 registers a
//   thread, more than a consumer needs, and one block fills an SM's share of
//   shared memory for three stages.
//   Rounding: P is rounded to bf16 *unnormalized*, relative to the running
//   row max, before P.V; the row sum l adds the unrounded f32 values, and
//   the output is divided by l once at the end.  The plain version (and
//   JAX's xla_attention) round the normalized probabilities instead; the two
//   differ by about one bf16 step of the output (PERF.md, row 8).
// * bf16, Dh 256 (fwd_rows256_kernel): the token net's training forward,
//   [B*S', 8, 4, 256] — thousands of 8-row sequences, so memory-bound (each
//   of q, k, v, out moved once is the bound).  One warp owns 8 query rows of
//   one (sequence, head), a lane 8 of the 256 head dims (16-byte loads), and
//   walks the keys up to its last row one at a time (the next key's row
//   loaded while the current one is scored); the score of a (row, key) pair
//   is a warp sum.  No shared memory and no padding: four warps a block over
//   four (sequence, head) pairs.  CUDA-core f32: the bytes set the pace.
//   Same rounding point as above (p relative to the running max, rounded to
//   bf16 before it scales v).
// * f32, both head dims (causal_attention_kernel, below): the parity path
//   (tensor cores would mean TF32).  Grid (B*H, ceil(S/64)); a block of 256
//   threads holds one 64-row query tile in shared memory and walks 64-row K/V
//   tiles up to the causal edge.  Four threads share a query row: each
//   scores 16 of the tile's 64 keys, the row max and sum are reduced over the
//   four with shuffles, the probabilities go to shared memory, and each
//   thread then accumulates Dh/4 output dims.  Softmax statistics and the
//   accumulator stay in f32; the output is normalized once at the end.  At
//   Dh 256 its f32 tiles fill 214 KB of shared memory.
#include <climits>

#include "common.cuh"
#include "hopper.cuh"

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

template <int DH>
__global__ void __launch_bounds__(kThreads)
causal_attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, float* __restrict__ out,
                        float* __restrict__ lse,
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

  const float* qb = q + b * qsb + h * qsh;
  const float* kb = k + b * ksb + hk * ksh;
  const float* vb = v + b * vsb + hk * vsh;

  for (int idx = threadIdx.x; idx < kBlockQ * DH; idx += kThreads) {
    const int rr = idx / DH, d = idx % DH;
    const int row = q0 + rr;
    Qs[rr * P + d] = row < S ? qb[row * qss + d] : 0.f;
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
      Ks[rr * P + d] = row < S ? kb[row * kss + d] : 0.f;
      Vs[rr * P + d] = row < S ? vb[row * vss + d] : 0.f;
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
    float* ob = out + ((static_cast<size_t>(b) * S + qi) * H + h) * DH;
#pragma unroll
    for (int e = 0; e < DPT; ++e) ob[sub + 4 * e] = acc[e] * inv;
    if (lse != nullptr && sub == 0)  // the row's m and l: every real row saw key 0
      lse[(static_cast<size_t>(b) * H + h) * S + qi] = m_i + logf(l_i);
  }
}

template <int DH>
int launch_dh(const void* q, const void* k, const void* v, void* out, float* lse, int B, int S,
              int H, int Hkv, const long long* st, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<DH>();
  cudaError_t e = cudaFuncSetAttribute(causal_attention_kernel<DH>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(B * H, (S + kBlockQ - 1) / kBlockQ);
  causal_attention_kernel<DH><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(out), lse, S, H, H / Hkv, st[0], st[1], st[2], st[3], st[4], st[5], st[6],
      st[7], st[8], 1.0f / sqrtf(static_cast<float>(DH)));
  return mm::last_error();
}

// ---- bf16, Dh 64: TMA + wgmma --------------------------------------------------

namespace wg {

using namespace mm::sm90;

constexpr int kRows = 128;                   // query rows per block (two warpgroups of 64)
constexpr int kKeys = 128;                   // keys per K/V tile
constexpr int kStages = 3;                   // K/V tiles in flight
constexpr int kConsumers = 256;              // two warpgroups
constexpr int kThreads = kConsumers + 32;    // plus the producer warp
constexpr uint32_t kTile = kRows * 64 * 2;   // bytes of a 128-row bf16 tile (= kKeys rows)
constexpr uint32_t kBars = kTile * (1 + 2 * kStages);  // barriers after Q and the ring
constexpr size_t kSmem = 1024 + kBars + 8 * (1 + 2 * kStages);  // + 1024-byte alignment slack

__global__ void __launch_bounds__(kThreads, 1)
fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ out,
                 float* __restrict__ lse, int S, int H, int groups, int n_qt, float scale_log2) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // the 128-byte swizzle wants 1024-byte atoms
  const uint32_t sQ = base;
  const uint32_t full_q = base + kBars;
  auto sK = [&](int st) { return base + kTile * (1 + 2 * st); };
  auto sV = [&](int st) { return base + kTile * (2 + 2 * st); };
  auto full = [&](int st) { return full_q + 8u * (1 + st); };
  auto empty = [&](int st) { return full_q + 8u * (1 + kStages + st); };

  // the longest query tiles (the last) first
  const int bh_count = gridDim.x / n_qt;
  const int qt = n_qt - 1 - static_cast<int>(blockIdx.x) / bh_count;
  const int bh = static_cast<int>(blockIdx.x) % bh_count;
  const int b = bh / H, h = bh % H, hk = h / groups;
  const int q0 = qt * kRows;
  const int n_kt = qt + 1;  // key tiles up to the diagonal (kKeys == kRows)
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    mbar_init(full_q, 1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(full(st), 1);
      mbar_init(empty(st), kConsumers);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (warp == kConsumers / 32) {  // the producer warp: one lane starts every copy
    if (lane == 0) {
      mbar_expect_tx(full_q, kTile);
      tma_load_4d(sQ, &tq, full_q, 0, h, q0, b);
      for (int j = 0; j < n_kt; ++j) {
        const int st = j % kStages;
        mbar_wait(empty(st), ((j / kStages) & 1) ^ 1);  // the first round passes at once
        mbar_expect_tx(full(st), 2 * kTile);
        tma_load_4d(sK(st), &tk, full(st), 0, hk, j * kKeys, b);
        tma_load_4d(sV(st), &tv, full(st), 0, hk, j * kKeys, b);
      }
    }
    return;
  }

  // a consumer warpgroup: 64 query rows; this thread holds rows row0, row0 + 8
  const int wgi = warp >> 2;
  const int row0 = q0 + 64 * wgi + 16 * (warp & 3) + (lane >> 2);
  const int col0 = 2 * (lane & 3);
  float o[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = 0.f;
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F};  // running max of the scaled (log2) scores
  float l[2] = {0.f, 0.f};                      // this thread's part of the row sums
  const uint64_t dq = desc_sw128(sQ + 64u * 128u * wgi, 16, 1024);
  mbar_wait(full_q, 0);

  for (int j = 0; j < n_kt; ++j) {
    const int st = j % kStages;
    mbar_wait(full(st), (j / kStages) & 1);

    float s[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) s[i] = 0.f;
    const uint64_t dk = desc_sw128(sK(st), 16, 1024);
    fence_operands(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)  // 16 head dims (32 bytes) a step inside the swizzle atom
      wgmma_m64n128k16_ss(s, dq + 2 * kk, dk + 2 * kk, kk);
    wgmma_commit();
    wgmma_wait_all();
    fence_operands(s);

    if (j == qt) {  // the diagonal tile: keys past the row (and past S) drop out
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        const int key = j * kKeys + 8 * (i >> 2) + col0 + (i & 1);
        if (key > row0 + 8 * ((i >> 1) & 1)) s[i] = -CUDART_INF_F;
      }
    }
    // every row keeps at least one key of every tile, so the max is finite
    float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
    for (int i = 0; i < 64; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r] * scale_log2);
      corr[r] = exp2f(m[r] - m_new);
      m[r] = m_new;
    }
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      const int r = (i >> 1) & 1;
      s[i] = exp2f(fmaf(s[i], scale_log2, -m[r]));
      rs[r] += s[i];
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + rs[r];
#pragma unroll
    for (int i = 0; i < 32; ++i) o[i] *= corr[(i >> 1) & 1];

    uint32_t a[8][4];
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) pack_a(a[kk], s, kk);
    const uint64_t dv = desc_sw128(sV(st), 1024, 1024);
    fence_operands(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)  // 16 keys (two 1024-byte atoms) a step
      wgmma_m64n64k16_rs_nmajor(o, a[kk], dv + 128 * kk);
    wgmma_commit();
    wgmma_wait_all();
    fence_operands(o);
    mbar_arrive(empty(st));
  }

  __nv_bfloat16* ob = out + (static_cast<size_t>(b) * S * H + h) * 64;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int row = row0 + 8 * r;
    if (row < S) {
      const float inv = 1.f / l[r];
      uint32_t* orow = reinterpret_cast<uint32_t*>(ob + static_cast<size_t>(row) * H * 64 + col0);
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
        orow[4 * jj] = pack_bf16(o[4 * jj + 2 * r] * inv, o[4 * jj + 2 * r + 1] * inv);
      if (lse != nullptr && (lane & 3) == 0)
        lse[(static_cast<size_t>(b) * H + h) * S + row] = m[r] * CUDART_LN2_F + logf(l[r]);
    }
  }
}

// A 4-d map over one input [B, S, heads, 64] bf16 given by element strides
// (sb, ss, sh), dims innermost first (64, heads, S, B); a box is 128 rows of
// one (b, head), 128-byte swizzled; rows past S read as zeros.
int make_map(EncodeTiled encode, CUtensorMap* map, const void* base, int B, int S, int heads,
             long long sb, long long ss, long long sh) {
  const cuuint64_t dims[4] = {64, static_cast<cuuint64_t>(heads), static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(sh) * 2, static_cast<cuuint64_t>(ss) * 2,
                                 static_cast<cuuint64_t>(sb) * 2};
  const cuuint32_t box[4] = {64, 1, kRows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base),
                            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

int launch(const void* q, const void* k, const void* v, void* out, float* lse, int B, int S,
           int H, int Hkv, const long long* st, cudaStream_t stream) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorSymbolNotFound);
  CUtensorMap tq, tk, tv;
  int err = make_map(encode, &tq, q, B, S, H, st[0], st[1], st[2]);
  if (!err) err = make_map(encode, &tk, k, B, S, Hkv, st[3], st[4], st[5]);
  if (!err) err = make_map(encode, &tv, v, B, S, Hkv, st[6], st[7], st[8]);
  if (err) return err;
  const int n_qt = (S + kRows - 1) / kRows;
  const long long blocks = static_cast<long long>(B) * H * n_qt;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidConfiguration);
  const cudaError_t e = cudaFuncSetAttribute(
      fwd_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(kSmem));
  if (e != cudaSuccess) return static_cast<int>(e);
  fwd_wgmma_kernel<<<static_cast<unsigned int>(blocks), kThreads, kSmem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(out), lse, S, H, H / Hkv, n_qt,
      0.125f * mm::sm90::kLog2e);  // Dh**-0.5 * log2(e)
  return mm::last_error();
}

}  // namespace wg

// ---- bf16, Dh 256: packed rows on the CUDA cores -------------------------------

namespace rows {

using namespace mm::sm90;

constexpr int kR = 8;      // query rows a warp owns
constexpr int kWarps = 4;  // warps (sequence, head pairs) a block

__device__ __forceinline__ uint4 ld16(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint4*>(p);
}

__global__ void __launch_bounds__(kWarps * 32)
fwd_rows256_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                   const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out,
                   float* __restrict__ lse, int S, int H, int groups, int n_qt, long long bh_count,
                   long long qsb, long long qss, long long qsh, long long ksb, long long kss,
                   long long ksh, long long vsb, long long vss, long long vsh, float scale_log2) {
  const int lane = threadIdx.x & 31;
  const long long item = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (item >= bh_count * n_qt) return;
  const int qt = n_qt - 1 - static_cast<int>(item / bh_count);  // the longest tiles first
  const long long bh = item % bh_count;
  const int b = static_cast<int>(bh / H), h = static_cast<int>(bh % H), hk = h / groups;
  const int q0 = qt * kR;
  const __nv_bfloat16* qb = q + b * qsb + h * qsh + lane * 8;
  const __nv_bfloat16* kb = k + b * ksb + hk * ksh + lane * 8;
  const __nv_bfloat16* vb = v + b * vsb + hk * vsh + lane * 8;

  uint4 qv[kR];
  float o[kR][8], m[kR], l[kR];
#pragma unroll
  for (int i = 0; i < kR; ++i) {
    qv[i] = q0 + i < S ? ld16(qb + (q0 + i) * qss) : make_uint4(0, 0, 0, 0);
    m[i] = -CUDART_INF_F;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < 8; ++e) o[i][e] = 0.f;
  }
  const int last = min(S, q0 + kR) - 1;
  uint4 kn = ld16(kb), vn = ld16(vb);
  for (int j = 0; j <= last; ++j) {
    const uint4 kc = kn, vc = vn;
    if (j < last) {  // the next key's row while this one is scored
      kn = ld16(kb + (j + 1) * kss);
      vn = ld16(vb + (j + 1) * vss);
    }
    float kf[8], vf[8], sc[kR];
    unpack8(kc, kf);
#pragma unroll
    for (int i = 0; i < kR; ++i) {
      float qf[8];
      unpack8(qv[i], qf);
      float d = 0.f;
#pragma unroll
      for (int e = 0; e < 8; ++e) d = fmaf(qf[e], kf[e], d);
      sc[i] = mm::warp_sum(d);
    }
    unpack8(vc, vf);
#pragma unroll
    for (int i = 0; i < kR; ++i) {
      if (j <= q0 + i) {
        const float s2 = sc[i] * scale_log2;
        const float m_new = fmaxf(m[i], s2);
        const float corr = exp2f(m[i] - m_new);
        const float p = exp2f(s2 - m_new);
        const float pb = round_bf16(p);
        l[i] = l[i] * corr + p;
#pragma unroll
        for (int e = 0; e < 8; ++e) o[i][e] = fmaf(pb, vf[e], o[i][e] * corr);
        m[i] = m_new;
      }
    }
  }
  __nv_bfloat16* ob = out + (static_cast<size_t>(b) * S * H + h) * 256 + lane * 8;
#pragma unroll
  for (int i = 0; i < kR; ++i) {
    const int row = q0 + i;
    if (row < S) {
      const float inv = 1.f / l[i];
      float r8[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) r8[e] = o[i][e] * inv;
      *reinterpret_cast<uint4*>(ob + static_cast<size_t>(row) * H * 256) = pack8(r8);
      if (lse != nullptr && lane == 0)
        lse[(static_cast<size_t>(b) * H + h) * S + row] = m[i] * CUDART_LN2_F + logf(l[i]);
    }
  }
}

int launch(const void* q, const void* k, const void* v, void* out, float* lse, int B, int S,
           int H, int Hkv, const long long* st, cudaStream_t stream) {
  const int n_qt = (S + kR - 1) / kR;
  const long long bh_count = static_cast<long long>(B) * H;
  const long long blocks = (bh_count * n_qt + kWarps - 1) / kWarps;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidConfiguration);
  fwd_rows256_kernel<<<static_cast<unsigned int>(blocks), kWarps * 32, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out), lse, S, H,
      H / Hkv, n_qt, bh_count, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8],
      0.0625f * mm::sm90::kLog2e);  // Dh**-0.5 * log2(e)
  return mm::last_error();
}

}  // namespace rows

int launch_f32(const void* q, const void* k, const void* v, void* out, void* lse, int B, int S,
               int H, int Hkv, int Dh, const long long* st, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  switch (Dh) {
    case 64: return launch_dh<64>(q, k, v, out, l, B, S, H, Hkv, st, s);    // event net
    case 256: return launch_dh<256>(q, k, v, out, l, B, S, H, Hkv, st, s);  // token net
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

int launch_bf16(const void* q, const void* k, const void* v, void* out, void* lse, int B, int S,
                int H, int Hkv, int Dh, const long long* st, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  switch (Dh) {
    case 64: return wg::launch(q, k, v, out, l, B, S, H, Hkv, st, s);     // event net
    case 256: return rows::launch(q, k, v, out, l, B, S, H, Hkv, st, s);  // token net
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// strides: [q_b, q_s, q_h, k_b, k_s, k_h, v_b, v_s, v_h] in elements; the
// last dim of each input is contiguous; out is a contiguous [B, S, H, Dh];
// lse: null, or a contiguous f32 [B, H, S] for the rows' log-sum-exp.  The
// bf16 forms read 16 bytes at a time (TMA at Dh 64): the inputs' base
// addresses are 16-byte aligned and their strides multiples of 8 elements,
// non-decreasing from head to position to batch (the wrapper copies an input
// that is not).
extern "C" int mm_causal_attention_f32(const void* q, const void* k, const void* v, void* out,
                                       void* lse, int B, int S, int H, int Hkv, int Dh,
                                       const long long* strides, void* stream) {
  return launch_f32(q, k, v, out, lse, B, S, H, Hkv, Dh, strides, stream);
}

extern "C" int mm_causal_attention_bf16(const void* q, const void* k, const void* v, void* out,
                                        void* lse, int B, int S, int H, int Hkv, int Dh,
                                        const long long* strides, void* stream) {
  return launch_bf16(q, k, v, out, lse, B, S, H, Hkv, Dh, strides, stream);
}
