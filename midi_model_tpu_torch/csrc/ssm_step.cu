// One decode row of a Mamba-2 layer for every slot: the causal
// convolution over the slot's conv state and the new row, SiLU, softplus,
// the f32 SSM state updated in place, y = C.h + D x, and the gated RMSNorm.
//
// New for the hybrid event net (Granite 4.0-H); no TPU kernel of the JAX
// package computes it.  The plain version is ops/ssm.py ssm_step_reference.
//
// What it computes, per slot b (H heads of P = 64, state N = 128, G groups,
// convolution width K = 4, I = H P, C = I + 2 G N channels), from the
// in_proj row zxbcdt[b] = [z (I) | xBC (C) | dt (H)] (bf16):
//   xBC' = silu(bias + sum_k w[:, k] window[k]) rounded to bf16, window =
//          the slot's K - 1 conv-state rows then xBC; the conv state then
//          holds the window's last K - 1 rows;
//   per head h (group h / (H / G)): dt = softplus(dt[h] + dt_bias[h]),
//          state[h] = exp(-exp(A_log[h]) dt) state[h] + dt x_h B^T,
//          y_h = state[h] C + D[h] x_h   (f32);
//   out = norm_w * bf16((y * silu(z)) * rsqrt(mean((y * silu(z))^2) + eps)).
//
// What bounds it on an H100: bytes.  The f32 state (P N 4 = 32 KB a head)
// is read and written once a step; everything else is small.
//
// Design: one block per (slot, head), 256 threads.  Thread t holds row
// p = t / 4 of the head's state, float4 columns q, q + 4, ... (q = t % 4),
// so a warp's loads cover 8 rows x 64 contiguous bytes; the state's loads
// are issued first and the convolution (this head's x channels and its
// group's B and C channels, from L2 for the B, C shared by the group's
// heads) computed while they land.  y reduces over a row's 4 threads by
// shuffles.  The gated norm needs the whole slot: each block writes its
// gated values and its sum of squares to scratch and takes a ticket on the
// slot's arrival counter; the last block of the slot sums the heads' sums
// IN HEAD ORDER (the same bits whatever the arrival order), writes the
// normalised output, shifts the group channels' conv state (every head that
// reads them has arrived) and resets the counter to 0.  A block shifts its
// own x channels' conv state itself.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kP = 64;   // head dim
constexpr int kN = 128;  // state size
constexpr int kK = 4;    // convolution width
constexpr int kThreads = 256;

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float silu(float x) { return x / (1.f + __expf(-x)); }

__device__ __forceinline__ float softplus(float x) {  // torch's, threshold 20
  return x > 20.f ? x : log1pf(__expf(x));
}

struct StepArgs {
  const bf16* zxbcdt;   // [B, I + C + H]
  bf16* conv_state;     // [B, K - 1, C]
  float* ssm_state;     // [B, H, P, N]
  const bf16 *conv_w, *conv_b, *dt_bias, *a_log, *d, *norm_w;
  bf16* out;            // [B, I]
  float* gated;         // [B, I + H]: gated values, then each head's sum of squares
  int* arrivals;        // [B], zero between launches
  int H, G;
  float eps;
};

__global__ void __launch_bounds__(kThreads) ssm_step_kernel(StepArgs a) {
  const int slot = blockIdx.y, head = blockIdx.x;
  const int H = a.H, I = H * kP, GN = a.G * kN, C = I + 2 * GN;
  const int grp = head / (H / a.G);
  const int t = threadIdx.x, p = t >> 2, q = t & 3;

  float4* st = reinterpret_cast<float4*>(a.ssm_state + (static_cast<size_t>(slot) * H + head) *
                                                            kP * kN + p * kN);
  float4 h[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) h[j] = st[j * 4 + q];

  __shared__ __align__(16) float xs[kP];
  __shared__ __align__(16) float bs[kN];
  __shared__ __align__(16) float cs[kN];
  __shared__ float s_dt, s_decay, s_warp[kThreads / 32];
  __shared__ int s_last;

  const bf16* row = a.zxbcdt + static_cast<size_t>(slot) * (I + C + H);
  const bf16* xbc = row + I;
  bf16* cst = a.conv_state + static_cast<size_t>(slot) * (kK - 1) * C;
  for (int idx = t; idx < kP + 2 * kN; idx += kThreads) {
    const int ch = idx < kP ? head * kP + idx
                            : (idx < kP + kN ? I + grp * kN + (idx - kP)
                                             : I + GN + grp * kN + (idx - kP - kN));
    float acc = mm::to_f32(a.conv_b[ch]);
#pragma unroll
    for (int k = 0; k < kK - 1; ++k)
      acc += mm::to_f32(cst[k * C + ch]) * mm::to_f32(a.conv_w[ch * kK + k]);
    acc += mm::to_f32(xbc[ch]) * mm::to_f32(a.conv_w[ch * kK + kK - 1]);
    const float v = __bfloat162float(__float2bfloat16(silu(acc)));
    if (idx < kP) xs[idx] = v;
    else if (idx < kP + kN) bs[idx - kP] = v;
    else cs[idx - kP - kN] = v;
  }
  if (t == 0) {
    const float dt = softplus(mm::to_f32(row[I + C + head]) + mm::to_f32(a.dt_bias[head]));
    s_dt = dt;
    s_decay = expf(dt * -expf(mm::to_f32(a.a_log[head])));
  }
  __syncthreads();

  // this head's x channels' conv state: every read of it is done
  if (t < kP) {
    const int ch = head * kP + t;
#pragma unroll
    for (int k = 0; k < kK - 2; ++k) cst[k * C + ch] = cst[(k + 1) * C + ch];
    cst[(kK - 2) * C + ch] = xbc[ch];
  }

  const float decay = s_decay, dtx = s_dt * xs[p];
  const float4* b4 = reinterpret_cast<const float4*>(bs);
  const float4* c4 = reinterpret_cast<const float4*>(cs);
  float y = 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float4 bb = b4[j * 4 + q], cc = c4[j * 4 + q];
    float4 v = h[j];
    v.x = fmaf(v.x, decay, dtx * bb.x);
    v.y = fmaf(v.y, decay, dtx * bb.y);
    v.z = fmaf(v.z, decay, dtx * bb.z);
    v.w = fmaf(v.w, decay, dtx * bb.w);
    y = fmaf(v.x, cc.x, y);
    y = fmaf(v.y, cc.y, y);
    y = fmaf(v.z, cc.z, y);
    y = fmaf(v.w, cc.w, y);
    st[j * 4 + q] = v;
  }
  y += __shfl_xor_sync(0xffffffffu, y, 1);
  y += __shfl_xor_sync(0xffffffffu, y, 2);
  float g = 0.f;
  float* gated = a.gated + static_cast<size_t>(slot) * (I + H);
  if (q == 0) {
    y = fmaf(mm::to_f32(a.d[head]), xs[p], y);
    g = y * silu(mm::to_f32(row[head * kP + p]));
    gated[head * kP + p] = g;
    __threadfence();  // visible to the slot's last block
  }
  const float sq = mm::warp_sum(g * g);
  if ((t & 31) == 0) s_warp[t >> 5] = sq;
  __syncthreads();
  if (t == 0) {
    float total = 0.f;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) total += s_warp[w];
    gated[I + head] = total;
    __threadfence();
    s_last = atomicAdd(a.arrivals + slot, 1) == H - 1;
  }
  __syncthreads();
  if (!s_last) return;
  __threadfence();

  // the slot's last block: the norm over all heads, the group channels' shift
  if (t < 32) {
    float total = 0.f;
    for (int hh = t; hh < H; hh += 32) total += __ldcg(gated + I + hh);
    // lanes hold heads t, t + 32, ...: sum them in lane order
    for (int off = 1; off < 32; off <<= 1) total += __shfl_xor_sync(0xffffffffu, total, off);
    if (t == 0) s_dt = rsqrtf(total / static_cast<float>(I) + a.eps);
  }
  __syncthreads();
  const float r = s_dt;
  bf16* out = a.out + static_cast<size_t>(slot) * I;
  for (int i = t; i < I; i += kThreads) {
    const float v = __bfloat162float(__float2bfloat16(__ldcg(gated + i) * r));
    out[i] = __float2bfloat16(mm::to_f32(a.norm_w[i]) * v);
  }
  for (int ch = I + t; ch < C; ch += kThreads) {
#pragma unroll
    for (int k = 0; k < kK - 2; ++k) cst[k * C + ch] = cst[(k + 1) * C + ch];
    cst[(kK - 2) * C + ch] = xbc[ch];
  }
  if (t == 0) a.arrivals[slot] = 0;
}

}  // namespace

// zxbcdt [B, I + C + H], conv_state [B, 3, C] and the parameters bf16;
// ssm_state [B, H, 64, 128] f32; out [B, I] bf16; gated [B, I + H] f32
// scratch; arrivals [B] int32 zeros (left at zero).
extern "C" int mm_ssm_step_bf16(const void* zxbcdt, void* conv_state, float* ssm_state,
                                const void* conv_w, const void* conv_b, const void* dt_bias,
                                const void* a_log, const void* d, const void* norm_w, void* out,
                                float* gated, int* arrivals, int B, int H, int G, float eps,
                                void* stream) {
  if (B < 1 || H < 1 || G < 1 || H % G || B > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const StepArgs args{static_cast<const bf16*>(zxbcdt), static_cast<bf16*>(conv_state), ssm_state,
                      static_cast<const bf16*>(conv_w), static_cast<const bf16*>(conv_b),
                      static_cast<const bf16*>(dt_bias), static_cast<const bf16*>(a_log),
                      static_cast<const bf16*>(d), static_cast<const bf16*>(norm_w),
                      static_cast<bf16*>(out), gated, arrivals, H, G, eps};
  ssm_step_kernel<<<dim3(H, B), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(args);
  return mm::last_error();
}
