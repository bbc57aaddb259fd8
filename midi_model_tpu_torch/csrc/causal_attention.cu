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
// * f32, Dh 64 (fwd_tf32_kernel): the f32 prefill and the event net's
//   training forward under --fp32, operations-bound, so on the tensor cores:
//   every product as three TF32 products (hopper.cuh, 3xTF32: x = hi + lo,
//   a b = a_lo b_hi + a_hi b_lo + a_hi b_hi, the small terms first, f32
//   sums), which keeps close to f32's accuracy where plain TF32 keeps ~3
//   digits.  mma.sync m16n8k8: a block takes 64 query rows of one (b, h),
//   one warp per 16 rows; Q is split into hi/lo fragments in registers once;
//   64-key K/V tiles come in by cp.async into padded shared memory
//   (attention_tf32.cuh: every fragment read hits 32 banks), the next tile
//   in flight while the current one is used.  S = Q.K^T in registers, the
//   online softmax in f32 (exp2, only the diagonal tile masked), P kept in
//   f32 and split for P.V straight from its accumulator (no lane moves);
//   each tile's P.V is summed apart and added to the output in f32 (the
//   tensor cores truncate as they accumulate).  Blocks of the last
//   (longest) query tiles launch first.  The output is normalized once at
//   the end; the plain version normalizes P before P.V, so the two differ
//   by f32 rounding only.
// * Dh 256, bf16 and f32 (fwd_rows256_kernel<T, R>): the token net's
//   training forward, [B*S', 8, 4, 256] — thousands of 8-row sequences, so
//   memory-bound (each of q, k, v, out moved once is the bound).  One warp
//   owns R query rows of one (sequence, head), a lane 8 of the 256 head dims
//   (one 16-byte load in bf16, two in f32), and walks the keys up to its last
//   row one at a time (the next key's row loaded while the current one is
//   scored); the score of a (row, key) pair is a warp sum.  No shared memory
//   and no padding: four warps a block over four (sequence, head) pairs.
//   CUDA-core f32 sums: the bytes set the pace.  p (relative to the running
//   max) is rounded to the input type before it scales v: bf16, or none.
#include <climits>

#include "attention_tf32.cuh"
#include "common.cuh"
#include "hopper.cuh"

namespace {

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
           int H, int Hkv, const long long* st, float scale, cudaStream_t stream) {
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
      scale * mm::sm90::kLog2e);
  return mm::last_error();
}

}  // namespace wg

// ---- f32, Dh 64: 3xTF32 on mma.sync ---------------------------------------------

namespace tf32k {

using namespace mm::tf32;

constexpr size_t kSmem = 4 * kTileFloats * sizeof(float);  // K and V, two buffers each

__global__ void __launch_bounds__(kThreads)
fwd_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, float* __restrict__ out, float* __restrict__ lse,
                int S, int H, int groups, int n_qt, long long qsb, long long qss, long long qsh,
                long long ksb, long long kss, long long ksh, long long vsb, long long vss,
                long long vsh, float scale_log2) {
  extern __shared__ __align__(16) float smem_f[];
  auto sK = [&](int i) { return smem_f + kTileFloats * (2 * i); };
  auto sV = [&](int i) { return smem_f + kTileFloats * (2 * i + 1); };

  // the longest query tiles (the last) first
  const int bh_count = gridDim.x / n_qt;
  const int qt = n_qt - 1 - static_cast<int>(blockIdx.x) / bh_count;
  const int bh = static_cast<int>(blockIdx.x) % bh_count;
  const int b = bh / H, h = bh % H, hk = h / groups;
  const int q0 = qt * kR;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float* kb = k + b * ksb + hk * ksh;
  const float* vb = v + b * vsb + hk * vsh;

  // Q lands in buffer 1's K slot beside K/V tile 0, and goes to registers
  load_tile(sK(1), q + b * qsb + h * qsh, qss, q0, S);
  load_tile(sK(0), kb, kss, 0, S);
  load_tile(sV(0), vb, vss, 0, S);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  uint32_t qh[8][4], ql[8][4];
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) ld_a(qh[kk], ql[kk], sK(1), 16 * warp, 8 * kk, lane);
  __syncthreads();  // every warp holds its Q before buffer 1 is refilled

  // this thread's rows row0 and row0 + 8, columns col0, col0 + 1 of each 8
  const int row0 = q0 + 16 * warp + (lane >> 2);
  const int col0 = 2 * (lane & 3);
  float o[8][4];
  zero(o);
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F};  // running max of the scaled (log2) scores
  float l[2] = {0.f, 0.f};                      // this thread's part of the row sums

  for (int j = 0; j <= qt; ++j) {
    const int buf = j & 1;
    if (j < qt) {  // the next K/V tile in flight while this one is used
      load_tile(sK(buf ^ 1), kb, kss, (j + 1) * kR, S);
      load_tile(sV(buf ^ 1), vb, vss, (j + 1) * kR, S);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* tk = sK(buf);
    const float* tv = sV(buf);
    float s[8][4];
    zero(s);
    product(
        s,
        [&](int kk, uint32_t (&ah)[4], uint32_t (&al)[4]) {
#pragma unroll
          for (int i = 0; i < 4; ++i) ah[i] = qh[kk][i], al[i] = ql[kk][i];
        },
        [&](int kk, int nt, uint32_t (&bh)[2], uint32_t (&bl)[2]) {
          ld_b_nrows(bh, bl, tk, 8 * nt, 8 * kk, lane);
        });
    if (j == qt) {  // the diagonal tile: keys past the row (and past S) drop out
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (j * kR + 8 * nt + col0 + (e & 1) > row0 + 8 * (e >> 1)) s[nt][e] = -CUDART_INF_F;
    }
    // every row keeps at least one key of every tile, so the max is finite
    float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[nt][e]);
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
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[nt][e] = exp2f(fmaf(s[nt][e], scale_log2, -m[e >> 1]));
        rs[e >> 1] += s[nt][e];
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + rs[r];
    float pv[8][4];  // this tile's P.V, apart from o (attention_tf32.cuh, accumulate)
    zero(pv);
    product(
        pv, [&](int kk, uint32_t (&ah)[4], uint32_t (&al)[4]) { a_from_acc(ah, al, s[kk]); },
        [&](int kk, int nt, uint32_t (&bh)[2], uint32_t (&bl)[2]) {
          ld_b_krows(bh, bl, tv, 8 * kk, 8 * nt, lane);
        });
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[nt][e] = fmaf(o[nt][e], corr[e >> 1], pv[nt][e]);
    __syncthreads();  // this buffer's reads are done before it is refilled
  }

  float* ob = out + (static_cast<size_t>(b) * S * H + h) * 64;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int row = row0 + 8 * r;
    if (row < S) {
      const float inv = 1.f / l[r];
      float2* orow = reinterpret_cast<float2*>(ob + static_cast<size_t>(row) * H * 64 + col0);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
        orow[4 * nt] = make_float2(o[nt][2 * r] * inv, o[nt][2 * r + 1] * inv);
      if (lse != nullptr && (lane & 3) == 0)
        lse[(static_cast<size_t>(b) * H + h) * S + row] = m[r] * CUDART_LN2_F + logf(l[r]);
    }
  }
}

int launch(const void* q, const void* k, const void* v, void* out, float* lse, int B, int S,
           int H, int Hkv, const long long* st, float scale, cudaStream_t stream) {
  const int n_qt = (S + kR - 1) / kR;
  const long long blocks = static_cast<long long>(B) * H * n_qt;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidConfiguration);
  const cudaError_t e = cudaFuncSetAttribute(
      fwd_tf32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(kSmem));
  if (e != cudaSuccess) return static_cast<int>(e);
  fwd_tf32_kernel<<<static_cast<unsigned int>(blocks), kThreads, kSmem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(out), lse, S, H, H / Hkv, n_qt, st[0], st[1], st[2], st[3], st[4],
      st[5], st[6], st[7], st[8], scale * mm::sm90::kLog2e);
  return mm::last_error();
}

}  // namespace tf32k

// ---- Dh 256, bf16 and f32: packed rows on the CUDA cores -------------------------

namespace rows {

using namespace mm::sm90;

constexpr int kWarps = 4;  // warps (sequence, head pairs) a block

// R: query rows a warp owns (its registers hold R rows of q and of the output)
template <typename T, int R>
__global__ void __launch_bounds__(kWarps * 32)
fwd_rows256_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                   T* __restrict__ out, float* __restrict__ lse, int S, int H, int groups,
                   int n_qt, long long bh_count, long long qsb, long long qss, long long qsh,
                   long long ksb, long long kss, long long ksh, long long vsb, long long vss,
                   long long vsh, float scale_log2) {
  const int lane = threadIdx.x & 31;
  const long long item = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (item >= bh_count * n_qt) return;
  const int qt = n_qt - 1 - static_cast<int>(item / bh_count);  // the longest tiles first
  const long long bh = item % bh_count;
  const int b = static_cast<int>(bh / H), h = static_cast<int>(bh % H), hk = h / groups;
  const int q0 = qt * R;
  const T* qb = q + b * qsb + h * qsh + lane * 8;
  const T* kb = k + b * ksb + hk * ksh + lane * 8;
  const T* vb = v + b * vsb + hk * vsh + lane * 8;

  Row8<T> qv[R];
  float o[R][8], m[R], l[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    if (q0 + i < S) {
      qv[i].load(qb + (q0 + i) * qss);
    } else {
      qv[i].zero();
    }
    m[i] = -CUDART_INF_F;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < 8; ++e) o[i][e] = 0.f;
  }
  const int last = min(S, q0 + R) - 1;
  Row8<T> kn, vn;
  kn.load(kb);
  vn.load(vb);
  for (int j = 0; j <= last; ++j) {
    const Row8<T> kc = kn, vc = vn;
    if (j < last) {  // the next key's row while this one is scored
      kn.load(kb + (j + 1) * kss);
      vn.load(vb + (j + 1) * vss);
    }
    float kf[8], vf[8], sc[R];
    kc.get(kf);
#pragma unroll
    for (int i = 0; i < R; ++i) {
      float qf[8];
      qv[i].get(qf);
      float d = 0.f;
#pragma unroll
      for (int e = 0; e < 8; ++e) d = fmaf(qf[e], kf[e], d);
      sc[i] = mm::warp_sum(d);
    }
    vc.get(vf);
#pragma unroll
    for (int i = 0; i < R; ++i) {
      if (j <= q0 + i) {
        const float s2 = sc[i] * scale_log2;
        const float m_new = fmaxf(m[i], s2);
        const float corr = exp2f(m[i] - m_new);
        const float p = exp2f(s2 - m_new);
        const float pr = round_to<T>(p);
        l[i] = l[i] * corr + p;
#pragma unroll
        for (int e = 0; e < 8; ++e) o[i][e] = fmaf(pr, vf[e], o[i][e] * corr);
        m[i] = m_new;
      }
    }
  }
  T* ob = out + (static_cast<size_t>(b) * S * H + h) * 256 + lane * 8;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int row = q0 + i;
    if (row < S) {
      const float inv = 1.f / l[i];
      float r8[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) r8[e] = o[i][e] * inv;
      store8(ob + static_cast<size_t>(row) * H * 256, r8);
      if (lse != nullptr && lane == 0)
        lse[(static_cast<size_t>(b) * H + h) * S + row] = m[i] * CUDART_LN2_F + logf(l[i]);
    }
  }
}

template <typename T, int R>
int launch(const void* q, const void* k, const void* v, void* out, float* lse, int B, int S,
           int H, int Hkv, const long long* st, float scale, cudaStream_t stream) {
  const int n_qt = (S + R - 1) / R;
  const long long bh_count = static_cast<long long>(B) * H;
  const long long blocks = (bh_count * n_qt + kWarps - 1) / kWarps;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidConfiguration);
  fwd_rows256_kernel<T, R><<<static_cast<unsigned int>(blocks), kWarps * 32, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), lse, S, H, H / Hkv, n_qt, bh_count, st[0], st[1], st[2], st[3],
      st[4], st[5], st[6], st[7], st[8], scale * mm::sm90::kLog2e);
  return mm::last_error();
}

// rows a warp owns: 8 (a whole token-net sequence) in both dtypes; ptxas
// reports no spills for either form (213 / 221 registers, bf16 / f32)
constexpr int kWarpRows = 8;

}  // namespace rows

int launch_f32(const void* q, const void* k, const void* v, void* out, void* lse, int B, int S,
               int H, int Hkv, int Dh, const long long* st, float scale, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  switch (Dh) {
    case 64: return tf32k::launch(q, k, v, out, l, B, S, H, Hkv, st, scale, s);  // event net
    case 256:  // token net
      return rows::launch<float, rows::kWarpRows>(q, k, v, out, l, B, S, H, Hkv, st, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

int launch_bf16(const void* q, const void* k, const void* v, void* out, void* lse, int B, int S,
                int H, int Hkv, int Dh, const long long* st, float scale, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  switch (Dh) {
    case 64: return wg::launch(q, k, v, out, l, B, S, H, Hkv, st, scale, s);  // event net
    case 256:  // token net
      return rows::launch<__nv_bfloat16, rows::kWarpRows>(q, k, v, out, l, B, S, H, Hkv, st,
                                                          scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// strides: [q_b, q_s, q_h, k_b, k_s, k_h, v_b, v_s, v_h] in elements; the
// last dim of each input is contiguous; out is a contiguous [B, S, H, Dh];
// lse: null, or a contiguous f32 [B, H, S] for the rows' log-sum-exp.  Every
// form reads 16 bytes at a time (TMA at bf16 Dh 64, cp.async at f32 Dh 64):
// the inputs' base addresses are 16-byte aligned and their strides multiples
// of 16 bytes (8 bf16, 4 f32 elements), non-decreasing from head to position
// to batch (the wrapper copies an input that is not).  scale: the scores'
// scale (the wrapper's default Dh**-0.5, 0.125 and 0.0625 exactly).
extern "C" int mm_causal_attention_f32(const void* q, const void* k, const void* v, void* out,
                                       void* lse, int B, int S, int H, int Hkv, int Dh,
                                       const long long* strides, float scale, void* stream) {
  return launch_f32(q, k, v, out, lse, B, S, H, Hkv, Dh, strides, scale, stream);
}

extern "C" int mm_causal_attention_bf16(const void* q, const void* k, const void* v, void* out,
                                        void* lse, int B, int S, int H, int Hkv, int Dh,
                                        const long long* strides, float scale, void* stream) {
  return launch_bf16(q, k, v, out, lse, B, S, H, Hkv, Dh, strides, scale, stream);
}
