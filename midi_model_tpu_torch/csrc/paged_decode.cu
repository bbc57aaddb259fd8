// All-heads paged flash decode with the fresh-row append, over a (slot,
// chunk) grid: the cell kernel, for calls whose longest slot the host knows.
//
// Replaces: midi_model_tpu/ops/paged_allheads.py, _decode_kernel_cell (Pallas
// TPU, per-slot grid), for bf16, f32 and int8 pools.  paged_decode_stream.cu
// computes the same function over a flat work list.
//
// What it computes: see paged_decode.cuh (the plain version is
// decode_reference + kv_append in ops/paged_allheads.py).
//
// What bounds it on an H100: bytes — every live row is read once, at ~2
// flops per byte; with every slot short (the router sends it at most
// CELL_MAX_ROWS rows) a grid of one block per slot would leave most SMs
// idle and each block with too few bytes in flight.
//
// Design: block (c, b) runs paged_decode.cuh's routine on rows
// [c * item_rows, (c + 1) * item_rows) of slot b, for every head.  The wrapper
// sizes the grid from the longest length (gridDim.x chunks per slot) and
// picks item_rows so that the grid holds about two blocks per SM; a chunk
// past its slot's length exits at once (chunk 0 of an empty slot runs: it
// writes the empty stats and appends), and the grid's last chunk takes every
// row left, so a slot longer than the grid was sized for is still right.
// The slot's last block merges its chunks and appends, in this launch, under
// MHA and GQA alike.
#include <cstdint>

#include "paged_decode.cuh"

namespace {

using mm::paged::Args;

template <typename T, int D>
__global__ void __launch_bounds__(mm::paged::kThreads, mm::paged::kBlocksPerSm)
    paged_decode_kernel(Args<T> a) {
  const int s = blockIdx.y;
  const int j = blockIdx.x;
  const int len = a.lengths[s];
  const int chunks = static_cast<int>(gridDim.x);
  const int n_items = min(chunks, max(1, (len + a.item_rows - 1) / a.item_rows));
  if (j >= n_items) return;
  // the grid's last chunk takes the rest: right for any length, if slow
  // where the longest length was understated
  const int r0 = j * a.item_rows;
  const int n = j == chunks - 1 ? len - r0 : min(a.item_rows, len - r0);
  mm::paged::decode_item<T, D>(a, s, r0, max(n, 0), j, n_items, s * chunks + j);
}

}  // namespace

#define MM_PAGED_DECODE(NAME, T)                                                              \
  extern "C" int NAME(const float* q, void* k_pool, void* v_pool, void* scales,               \
                      const int* lengths, const int* base_pages, float* o, float* m,          \
                      float* l, const void* new_k, const void* new_v,                         \
                      const void* new_scales, const int* write_pages,                         \
                      const int* write_offs, float* part, int* arrivals, int B, int H,        \
                      int Hkv, int D, int W, int page_size, int item_rows, int chunks,        \
                      int append, void* stream) {                                             \
    const Args<T> a{q, static_cast<T*>(k_pool), static_cast<T*>(v_pool),                      \
                    static_cast<__nv_bfloat16*>(scales), lengths, base_pages, o, m, l,        \
                    static_cast<const T*>(new_k), static_cast<const T*>(new_v),               \
                    static_cast<const __nv_bfloat16*>(new_scales), write_pages, write_offs,   \
                    part, arrivals, B, H, Hkv, H / Hkv, D, W / Hkv, W, page_size, item_rows,  \
                    append};                                                                  \
    MM_PAGED_DISPATCH(paged_decode_kernel, T, a, dim3(chunks, B), stream)                     \
  }

MM_PAGED_DECODE(mm_paged_decode_f32, float)
MM_PAGED_DECODE(mm_paged_decode_bf16, __nv_bfloat16)
MM_PAGED_DECODE(mm_paged_decode_int8, int8_t)
