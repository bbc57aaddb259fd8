// The whole token row of one event — every step of the token net, the
// shared lm_head, the grammar masks and the sampler — in ONE launch.
//
// Replaces: midi_model_tpu/ops/token_loop.py, _token_row_kernel (Pallas TPU).
//
// What it computes: token_row.cuh's token_row_body for one event (the plain
// version is midi_model_tpu_torch/ops/token_loop.py,
// decode_token_row_reference).  Outputs row [B, T] int32 and ended [B] (eos
// at step 0).
//
// What bounds it on an H100: bytes.  Every step reads all token-net and
// lm_head weights once (tv2o-medium: 3 layers x 7M + 3.5M parameters,
// about 51 MB in bf16), about 408 MB per event — 0.12 ms at 3.35 TB/s.
// Activations are [B, <=3W] and fit in L2.  This first version is far from
// that floor (~4 ms at bs=32): each of its 136 phases per event pays
// staging, CUDA-core FMA and barrier latency (PERF.md).
//
// Design (simple first version): one cooperative persistent grid, the
// phases of token_row.cuh separated by a global-memory grid barrier.
#include "token_row.cuh"

namespace {

template <typename T>
__global__ void __launch_bounds__(mm::kDecThreads, 1) token_row_kernel(mm::TokenParams<T> p) {
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);  // gemv2's staged tile; the sampler's work[V]
  __shared__ float rs[mm::kMaxBatch];
  __shared__ float red[mm::kDecWarps];
  __shared__ mm::ArgmaxScratch<mm::kDecThreads> am;
  mm::token_row_body<T>(p, 0, xs, rs, red, am);
}

// The packed host arrays of mm::fill_token_params.
template <typename T>
int launch(const void* const* ptrs, const int* ints, const float* floats, void* stream) {
  mm::TokenParams<T> p;
  if (!mm::fill_token_params(p, ptrs, ints, floats))
    return static_cast<int>(cudaErrorInvalidValue);
  void* args[] = {&p};
  return mm::launch_cooperative(token_row_kernel<T>, mm::kDecThreads, mm::kGemvSmem, 1 << 20,
                                args, stream);
}

}  // namespace

extern "C" int mm_token_row_f32(const void* const* ptrs, const int* ints, const float* floats,
                                void* stream) {
  return launch<float>(ptrs, ints, floats, stream);
}

extern "C" int mm_token_row_bf16(const void* const* ptrs, const int* ints, const float* floats,
                                 void* stream) {
  return launch<__nv_bfloat16>(ptrs, ints, floats, stream);
}
