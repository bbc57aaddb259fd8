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
// lm_head weights (tv2o-medium: 3 layers x 7M + 3.5M parameters, about 51
// MB in bf16): counted once (the weights stay in the 50 MB L2 across the 8
// steps at best) that is 0.015 ms at 3.35 TB/s, counted once a step 0.12
// ms.  Activations are [B, <=3W] and fit in L2.  What it has to hide is
// latency: 14 phases a step (bf16), each a grid barrier.
//
// Design: one cooperative persistent grid, one block per SM, the phases of
// token_row.cuh separated by a global-memory grid barrier.  bf16 products
// on tensor cores (mma.sync) with each phase's weights streamed by TMA into
// a ring that the block fills for the next phase before the barrier
// (decode.cuh); f32 products on CUDA cores.  With p.clock set, block 0
// stamps each phase (decode.cuh PhaseSync).
#include "token_row.cuh"

namespace {

template <typename T>
__global__ void __launch_bounds__(mm::kDecThreads, 1)
    token_row_kernel(const __grid_constant__ mm::TokenParams<T> p) {
  extern __shared__ float4 smem4[];
  __shared__ float rs[mm::kMaxBatch];
  __shared__ float red[mm::kDecWarps];
  __shared__ mm::ArgmaxScratch<mm::kDecThreads> am;
  mm::Tc<T> tc;  // the weight ring and staged activations; the sampler's work[V]
  tc.init(reinterpret_cast<uint8_t*>(smem4));
  mm::PhaseSync sync{p.bar, p.clock, 0};
  sync.start();
  mm::token_row_body<T>(p, 0, tc, sync, rs, red, am, nullptr);
  sync.end();
}

// The packed host arrays of mm::fill_token_params.
template <typename T>
int launch(const void* const* ptrs, const int* ints, const float* floats, int* launched,
           void* stream) {
  mm::TokenParams<T> p;
  if (!mm::fill_token_params(p, ptrs, ints, floats))
    return static_cast<int>(cudaErrorInvalidValue);
  void* args[] = {&p};
  return mm::launch_cooperative(token_row_kernel<T>, mm::kDecThreads, mm::decode_smem<T>(),
                                1 << 20, mm::decode_cluster<T>(), args, stream, launched);
}

}  // namespace

extern "C" int mm_token_row_f32(const void* const* ptrs, const int* ints,
                                const float* floats, int* launched, void* stream) {
  return launch<float>(ptrs, ints, floats, launched, stream);
}

extern "C" int mm_token_row_bf16(const void* const* ptrs, const int* ints,
                                 const float* floats, int* launched, void* stream) {
  return launch<__nv_bfloat16>(ptrs, ints, floats, launched, stream);
}
