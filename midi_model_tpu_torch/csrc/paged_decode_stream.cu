// All-heads paged flash decode with the fresh-row append, streamed over a
// flat (slot, chunk) work list: the continuous batcher's ragged lengths,
// which the host does not know.
//
// Replaces: midi_model_tpu/ops/paged_allheads.py, _decode_kernel_stream
// (Pallas TPU, one grid cell streaming a slot-major (slot, block) list), for
// bf16, f32 and int8 pools.
//
// What it computes: see paged_decode.cuh (the function of paged_decode.cu;
// the plain version is decode_reference + kv_append in
// ops/paged_allheads.py).
//
// What bounds it on an H100: bytes — every live row is read once, at ~2
// flops per byte, and the ragged lengths would leave a grid of one block per
// slot mostly idle while a few long slots finish.
//
// Design: the work list is implicit.  Item i is chunk j — rows
// [j * item_rows, (j + 1) * item_rows) — of slot s in the flat slot-major
// order over max(1, ceil(length / item_rows)) chunks per slot; each block
// finds its own (s, j) with a warp scan over the slots' chunk counts, and
// blocks past the list's end exit at once.  The host issues one launch and
// no work-list ops; the block then runs paged_decode.cuh's routine, whose
// last block per slot merges and appends in the same launch.
#include <cstdint>

#include "paged_decode.cuh"

namespace {

using mm::paged::Args;

// Chunks of up to `rows` rows that a slot of `length` rows makes (an empty
// slot makes one, of no rows: it still writes its stats and appends).
__device__ __forceinline__ int chunks_of(int length, int rows) {
  return max(1, (length + rows - 1) / rows);
}

// Warp-wide (all 32 lanes): (slot, chunk, the slot's chunk count) of item
// `item` in the flat slot-major list over the lengths; slot -1 past its end.
__device__ int3 find_item(const int* lengths, int B, int rows, int item) {
  const int lane = threadIdx.x & 31;
  int before = 0;  // items of the slots already passed
  for (int s0 = 0; s0 < B; s0 += 32) {
    const int nb = s0 + lane < B ? chunks_of(lengths[s0 + lane], rows) : 0;
    int cum = nb;  // inclusive scan over the warp's 32 slots
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, cum, off);
      if (lane >= off) cum += y;
    }
    const unsigned hit = __ballot_sync(0xffffffffu, before + cum > item);
    if (hit) {
      const int src = __ffs(hit) - 1;
      const int end = before + __shfl_sync(0xffffffffu, cum, src);
      const int n = __shfl_sync(0xffffffffu, nb, src);
      return make_int3(s0 + src, item - (end - n), n);
    }
    before += __shfl_sync(0xffffffffu, cum, 31);
  }
  return make_int3(-1, 0, 0);
}

template <typename T, int D>
__global__ void __launch_bounds__(mm::paged::kThreads, mm::paged::kBlocksPerSm)
    paged_decode_stream_kernel(Args<T> a) {
  __shared__ int3 s_item;
  if (threadIdx.x < 32) {
    const int3 found = find_item(a.lengths, a.B, a.item_rows, blockIdx.x);
    if (threadIdx.x == 0) s_item = found;
  }
  __syncthreads();
  const int3 it = s_item;
  if (it.x < 0) return;  // past the list's end
  const int r0 = it.y * a.item_rows;
  const int n = max(0, min(a.item_rows, a.lengths[it.x] - r0));
  mm::paged::decode_item<T, D>(a, it.x, r0, n, it.y, it.z, blockIdx.x);
}

}  // namespace

#define MM_PAGED_DECODE_STREAM(NAME, T)                                                       \
  extern "C" int NAME(const float* q, void* k_pool, void* v_pool, void* scales,               \
                      const int* lengths, const int* base_pages, float* o, float* m,          \
                      float* l, const void* new_k, const void* new_v,                         \
                      const void* new_scales, const int* write_pages,                         \
                      const int* write_offs, float* part, int* arrivals, int B, int H,        \
                      int Hkv, int D, int W, int page_size, int item_rows, int n_items,       \
                      int append, void* stream) {                                             \
    const Args<T> a{q, static_cast<T*>(k_pool), static_cast<T*>(v_pool),                      \
                    static_cast<__nv_bfloat16*>(scales), lengths, base_pages, o, m, l,        \
                    static_cast<const T*>(new_k), static_cast<const T*>(new_v),               \
                    static_cast<const __nv_bfloat16*>(new_scales), write_pages, write_offs,   \
                    part, arrivals, B, H, Hkv, H / Hkv, D, W / Hkv, W, page_size, item_rows,  \
                    append};                                                                  \
    MM_PAGED_DISPATCH(paged_decode_stream_kernel, T, a, dim3(n_items), stream)                \
  }

MM_PAGED_DECODE_STREAM(mm_paged_decode_stream_f32, float)
MM_PAGED_DECODE_STREAM(mm_paged_decode_stream_bf16, __nv_bfloat16)
MM_PAGED_DECODE_STREAM(mm_paged_decode_stream_int8, int8_t)
