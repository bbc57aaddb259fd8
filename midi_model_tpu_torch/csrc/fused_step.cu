// One event-net decode step over ALL layers in ONE launch.
//
// Replaces: midi_model_tpu/ops/fused_step.py, _fused_step_kernel (Pallas TPU).
//
// What it computes: fused_step.cuh's fused_step_body for one event (the
// plain version is midi_model_tpu_torch/ops/fused_step.py,
// fused_decode_step_reference): every layer's norm, q/k/v, RoPE, paged
// attention with the f32 self-term merge, the append, o-proj and SwiGLU,
// on the residual stream x [B, D] in place.
//
// Four forms: bf16 or f32 weights, over pools of the weights' dtype (updated
// in place) or over int8 pools with their bf16 scale pool (read only; the
// fresh rows leave as [L, B, W] outputs for the wrapper to quantize and
// scatter, as the TPU kernel's quantized form does).
//
// What bounds it on an H100: bytes.  The per-layer weights (tv2o-medium:
// q/k/v 3M, o 1M, gate/up 8M, down 4M parameters, 33.5 MB in bf16) are read
// once per event, 403 MB at 12 layers — 0.12 ms at 3.35 TB/s — plus the
// cached rows each slot attends over (2 * len * H * dh * sizeof(T) per
// slot and layer; int8 pools: 1 byte a value plus 4 bytes of scales a row
// and head).  What it has to hide is latency: 60 phases a step.
//
// Design: one cooperative persistent grid, one block per SM, the phases of
// fused_step.cuh separated by a global-memory grid barrier; bf16 products
// on tensor cores (mma.sync), each phase's weights streamed by TMA into a
// ring that the block fills for the next phase before the barrier
// (decode.cuh); f32 products on CUDA cores.  With p.clock set, block 0
// stamps each phase (decode.cuh PhaseSync).
#include "fused_step.cuh"

namespace {

template <typename T, typename KV>
__global__ void __launch_bounds__(mm::kDecThreads, 1)
    fused_step_kernel(const __grid_constant__ mm::StepParams<T, KV> p) {
  extern __shared__ float4 smem4[];
  __shared__ float rs[mm::kMaxBatch];
  mm::Tc<T> tc;  // the weight ring and staged activations; the attention rows
  tc.init(reinterpret_cast<uint8_t*>(smem4));
  mm::PhaseSync sync{p.bar, p.clock, 0};
  sync.start();
  mm::fused_step_body<T, KV>(p, 0, tc, sync, rs, nullptr);
  sync.end();
}

// The packed host arrays of mm::fill_step_params.
template <typename T, typename KV>
int launch(const void* const* ptrs, const int* ints, const float* floats, int* launched,
           void* stream) {
  mm::StepParams<T, KV> p;
  if (!mm::fill_step_params(p, ptrs, ints, floats))
    return static_cast<int>(cudaErrorInvalidValue);
  void* args[] = {&p};
  // no slot has more attention items than blocks (fused_step.cuh)
  return mm::launch_cooperative(fused_step_kernel<T, KV>, mm::kDecThreads,
                                mm::decode_smem<T>(), 1 << 20, mm::decode_cluster<T>(), args,
                                stream, launched, mm::kAttnItems);
}

}  // namespace

extern "C" int mm_fused_step_f32(const void* const* ptrs, const int* ints,
                                 const float* floats, int* launched, void* stream) {
  return launch<float, float>(ptrs, ints, floats, launched, stream);
}

extern "C" int mm_fused_step_bf16(const void* const* ptrs, const int* ints,
                                  const float* floats, int* launched, void* stream) {
  return launch<__nv_bfloat16, __nv_bfloat16>(ptrs, ints, floats, launched, stream);
}

extern "C" int mm_fused_step_f32_int8(const void* const* ptrs, const int* ints,
                                      const float* floats, int* launched, void* stream) {
  return launch<float, signed char>(ptrs, ints, floats, launched, stream);
}

extern "C" int mm_fused_step_bf16_int8(const void* const* ptrs, const int* ints,
                                       const float* floats, int* launched, void* stream) {
  return launch<__nv_bfloat16, signed char>(ptrs, ints, floats, launched, stream);
}
