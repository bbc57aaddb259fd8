// E whole events — token rows AND event-net steps — in ONE launch.
//
// Replaces: midi_model_tpu/ops/event_loop.py, _event_loop_kernel (Pallas
// TPU), in both its forms: aligned (merged_decode_events, every slot at the
// same history length; entry points mm_event_loop_*) and ragged
// (merged_decode_ragged, the continuous batcher's slots; entry points
// mm_event_loop_ragged_*).
//
// What it computes (the plain version is
// midi_model_tpu_torch/ops/event_loop.py, decode_event_block_reference),
// for events e = 0..E-1: the token row of token_row.cuh from the token
// net's input (the given hidden at e = 0, the event net's final RMSNorm of
// the residual after), with event e's noise plane; the event embedding of
// the sampled row (the sum of its 8 event-net embedding rows, in f32 in
// step order, rounded once to T), summed by the block that samples the
// row; then fused_step.cuh's step over all event-net layers at the uniform
// length len0 + e, appending at that position.  Outputs rows [E, B, T]
// int32 and, in the residual buffer, the last event's residual before the
// final norm.
//
// What bounds it on an H100: bytes, as its two bodies (token_loop.cu,
// fused_step.cu): about 51 (L2-resident at best) + 403 MB of weights per
// event at tv2o-medium in bf16, plus the cached rows; what it has to hide
// is the latency of its ~170 phases an event.  What one launch per E
// events removes, next to the per-event kernels, is the host's work
// between them: the launches, the embedding gather and the per-event
// geometry tables; and the weight ring carries each body's first weights
// across the other's last barrier.
//
// The ragged form (the plain version is decode_event_block_ragged_reference
// in the same module) gives every slot its own length and RoPE position
// index_s + e (the host's per-event tables), per-slot knobs, allow plane and
// noise, and keeps a per-slot alive mask in global memory: it starts as the
// host's `active`; a retired slot samples pad at every step, appends
// nothing, attends over nothing and keeps its residual frozen (a slot dead
// at entry keeps the zero residual it starts with); after event e's last
// layer a slot retires when its row's step 0 is eos or its length
// index_s + e + 1 reaches the capacity — the eos row itself goes through
// the event net.  The host derives the new index from the rows (one per
// non-pad row).
//
// Design: one cooperative persistent grid; between events one extra phase
// writes the token net's next input, T(fnorm * T(x * rsqrt)) of the
// residual — the plain version's RMSNorm rounding points.  In the ragged
// form block 0 also updates the alive mask there, from the previous event's
// rows: every read of the mask by that event's phases lies behind the grid
// barrier that ended it, and the barrier after this phase publishes the
// update to the token row and the step body that read it.
#include "fused_step.cuh"
#include "token_row.cuh"

namespace {

template <typename T>
struct LoopParams {
  mm::TokenParams<T> tok;
  mm::StepParams<T> step;
  const T* fnorm;  // the event net's final norm [D]
  unsigned char* alive;  // [B] the ragged form's alive mask, in place; null when aligned
  int n_events;
};

template <typename T>
__global__ void __launch_bounds__(mm::kDecThreads, 1)
    event_loop_kernel(const __grid_constant__ LoopParams<T> p) {
  extern __shared__ float4 smem4[];
  __shared__ float rs[mm::kMaxBatch];
  __shared__ float red[mm::kDecWarps];
  __shared__ mm::ArgmaxScratch<mm::kDecThreads> am;
  mm::Tc<T> tc;  // the weight ring and staged activations; work[V], the attention rows
  tc.init(reinterpret_cast<uint8_t*>(smem4));
  mm::PhaseSync sync{p.step.bar, p.step.clock, 0};
  sync.start();
  const int B = p.step.B, D = p.step.D;
  const mm::Plan<T> step_first = mm::step_qkv_plan(p.step, 0);
  const mm::Plan<T> tok_first = mm::tok_qkv_plan(p.tok, 0);
  for (int e = 0; e < p.n_events; ++e) {
    if (e > 0) {  // the token net's input: the final norm of the residual
      if (p.alive && blockIdx.x == 0) {  // retire after event e-1: eos row or capacity
        const int cap = p.step.pps * p.step.page_size;
        for (int b = threadIdx.x; b < B; b += mm::kDecThreads) {
          const int prev = (e - 1) * B + b;
          // lengths[e-1][b] = min(index_b + e - 1, cap): + 1 is the new length
          if (p.tok.row[static_cast<size_t>(prev) * p.tok.n_steps] == p.tok.eos_id ||
              p.step.lengths[prev] + 1 >= cap)
            p.alive[b] = 0;
        }
      }
      mm::row_scales<T>(p.step.x, B, D, p.step.eps, rs);
      __syncthreads();
      for (int i = (blockIdx.x * mm::kDecThreads + threadIdx.x) * 8; i < B * D;
           i += gridDim.x * mm::kDecThreads * 8) {
        const int b = i / D;
        float v[8];
        mm::norm8<T>(p.step.x, p.fnorm, rs, D, b, i - b * D, v);
        mm::store8(p.tok.x + i, v);
      }
      sync.barrier();
    }
    // the token row writes the event embedding to step.x
    mm::token_row_body<T>(p.tok, e, tc, sync, rs, red, am, &step_first);
    sync.barrier();
    mm::fused_step_body<T>(p.step, e, tc, sync, rs, e + 1 < p.n_events ? &tok_first : nullptr);
    if (e + 1 < p.n_events) sync.barrier();
  }
  sync.end();
}

// ptrs: mm::fill_token_params's pointers, then emb_net [V, D] and ev_acc
// [B, D] f32 scratch, then mm::fill_step_params's (the geometry tables with
// one row per event; the same barrier pair as the token row's), then the
// final norm, then (ragged) the alive mask [B] uint8; ints: the token
// row's, the step's, then n_events; floats: the token row's, then the
// step's.
template <typename T>
int launch(const void* const* ptrs, const int* ints, const float* floats, int* launched,
           void* stream, bool ragged) {
  LoopParams<T> p;
  bool ok = mm::fill_token_params(p.tok, ptrs, ints, floats);
  p.tok.emb_net = static_cast<const T*>(*ptrs++);
  p.tok.ev_acc = static_cast<float*>(const_cast<void*>(*ptrs++));
  ok = mm::fill_step_params(p.step, ptrs, ints, floats) && ok;
  p.tok.ev_out = p.step.x;
  p.fnorm = static_cast<const T*>(*ptrs++);
  p.alive = ragged ? static_cast<unsigned char*>(const_cast<void*>(*ptrs++)) : nullptr;
  p.tok.alive = p.alive;
  p.step.alive = p.alive;
  p.n_events = *ints++;
  if (!ok || p.tok.B != p.step.B || p.tok.D != p.step.D || p.tok.bar != p.step.bar ||
      p.n_events < 1 || (ragged && !p.alive))
    return static_cast<int>(cudaErrorInvalidValue);
  void* args[] = {&p};
  // no slot has more attention items than blocks (fused_step.cuh)
  return mm::launch_cooperative(event_loop_kernel<T>, mm::kDecThreads, mm::decode_smem<T>(),
                                1 << 20, mm::decode_cluster<T>(), args, stream, launched,
                                mm::kAttnItems);
}

}  // namespace

extern "C" int mm_event_loop_f32(const void* const* ptrs, const int* ints,
                                 const float* floats, int* launched, void* stream) {
  return launch<float>(ptrs, ints, floats, launched, stream, false);
}

extern "C" int mm_event_loop_bf16(const void* const* ptrs, const int* ints,
                                  const float* floats, int* launched, void* stream) {
  return launch<__nv_bfloat16>(ptrs, ints, floats, launched, stream, false);
}

extern "C" int mm_event_loop_ragged_f32(const void* const* ptrs, const int* ints,
                                        const float* floats, int* launched, void* stream) {
  return launch<float>(ptrs, ints, floats, launched, stream, true);
}

extern "C" int mm_event_loop_ragged_bf16(const void* const* ptrs, const int* ints,
                                         const float* floats, int* launched, void* stream) {
  return launch<__nv_bfloat16>(ptrs, ints, floats, launched, stream, true);
}
