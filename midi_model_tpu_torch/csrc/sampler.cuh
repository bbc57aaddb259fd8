// The top-p / top-k draw by one selection, and the first-max extraction of
// the greedy draw, shared by the standalone sampler (sampler.cu) and the
// fused decode kernels' sample phase (token_row.cuh sample_row).
//
// Semantics (the reference sampler's): order the entries by value, ties by
// the lowest index (a stable descending sort); rank j < n_iter = min(top_k,
// k_cap) is kept iff its exclusive running mass texcl_j -- the ordered
// values summed one by one in f32 -- is <= top_p; the draw is the first rank
// of the largest log(p_j) + g[j] over the kept ranks (the noise indexed by
// rank), and 0 when none beats -inf (no mass, top_k <= 0).
//
// sample_top_p_k_block selects instead of extracting the maximum once per
// rank (one strided pass over V and three block barriers a rank, up to 128
// ranks).  What sets its pace on an H100 is latency: a block of 8 warps has
// two warps an SM sub-partition, so a warp-synchronous instruction (vote,
// shuffle, reduce: ~30 cycles each, one after another) inside a pass over V
// costs more than the arithmetic, and integer work runs at half the f32
// rate.  So no pass over V holds a warp-synchronous instruction, and the
// passes compare f32 values where they can:
// - keys: a positive entry's f32 bit pattern above its inverted index, so
//   one unsigned 64-bit order is the stable descending sort.  Entries that
//   are not positive never win and add nothing to texcl, so they stay out.
// - the lead round (one pass, one barrier): each thread keeps its top two
//   by value, each warp its top kSampleLead keys by as many tournaments of
//   its lanes (__reduce_max_sync on the key's halves), and every warp merges
//   the block's lists into the ranks they settle exactly: up to the first
//   rank held by the last listed key of a warp with more positive entries
//   than it listed.  A row whose texcl passes top_p inside them (peaked
//   rows) or whose n_iter they cover is done.
// - a window (up to kSampleWin ranks, after the last window's smallest):
//   kSampleDigit-bit digit rounds on the keys until the chosen bucket and
//   the keys above it number at most the window's ranks + kSampleSlack.  A
//   round is a pass in which each thread adds its digits to its own bytes in
//   shared memory (atomics no one waits for; while the digit lies in the
//   value bits the bucket is a range of values), then two barriers: the
//   bytes summed per 32 threads, then per digit.  A pass counts each
//   thread's candidates, a block scan places them, the thread writes them
//   in order, each is ranked by counting the candidates before it, and the
//   window's values and ids land in rank order.
// - the finish (every warp alike, so no broadcast): texcl summed rank by
//   rank in f32 (a tree or warp scan would round otherwise and could flip a
//   keep), the noise of each rank, and the first best score by two
//   __reduce_*_sync.  A row past top_p, or at n_iter, stops; else the next
//   window.
// tests/test_torch_sampler_tiles.py emulates this on the CPU.
#pragma once

#include "common.cuh"

namespace mm {

struct MaxIdx {
  float m;
  int i;
};

// Larger value wins; equal values: lower index (symmetric, so a butterfly
// shuffle leaves every lane with the same winner).
__device__ __forceinline__ MaxIdx better(MaxIdx a, MaxIdx b) {
  return (b.m > a.m || (b.m == a.m && b.i < a.i)) ? b : a;
}

__device__ __forceinline__ MaxIdx warp_best(MaxIdx t) {
  for (int off = 16; off > 0; off >>= 1) {
    MaxIdx o{__shfl_xor_sync(0xffffffffu, t.m, off), __shfl_xor_sync(0xffffffffu, t.i, off)};
    t = better(t, o);
  }
  return t;
}

// Shared-memory scratch of one block for the reductions below.
template <int kThreads>
struct ArgmaxScratch {
  MaxIdx partial[kThreads / 32];
  MaxIdx winner;
};

// The first maximum of work[0, V) over the whole block (kThreads threads).
// An all-zero row returns index 0; every thread gets the same result.
template <int kThreads>
__device__ MaxIdx block_first_max(const float* work, int V, ArgmaxScratch<kThreads>& s) {
  constexpr int kWarps = kThreads / 32;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  MaxIdx t{-CUDART_INF_F, V};
  for (int i = threadIdx.x; i < V; i += kThreads) {
    const float x = work[i];
    if (x > t.m) {  // strided indices grow, so '>' keeps the lowest
      t.m = x;
      t.i = i;
    }
  }
  t = warp_best(t);
  if (lane == 0) s.partial[warp] = t;
  __syncthreads();
  if (warp == 0) {
    MaxIdx w = lane < kWarps ? s.partial[lane] : MaxIdx{-CUDART_INF_F, V};
    w = warp_best(w);
    if (lane == 0) s.winner = w;
  }
  __syncthreads();
  const MaxIdx r = s.winner;
  __syncthreads();  // the scratch may be reused right away
  return r;
}

constexpr int kSampleLead = 2;    // keys each warp lists in the lead round
constexpr int kSampleWin = 128;   // ranks a window orders
constexpr int kSampleSlack = 32;  // candidates a window may take beyond its ranks
constexpr int kSampleDigit = 5;   // key bits a digit round splits: 32 bins
constexpr int kSampleCap = kSampleWin + kSampleSlack;  // candidates of a window
constexpr unsigned kFullMask = 0xffffffffu;

using u64 = unsigned long long;

// The draw's shared memory (the caller's, beside work[V]).
template <int kThreads>
struct SampleScratch {
  static constexpr int kWarps = kThreads / 32;
  static constexpr int kListed = kWarps * kSampleLead;
  u64 lead[kWarps][kSampleLead];          // each warp's top keys
  float vmin[kWarps];                     // each warp's smallest positive entry
  int npos[kWarps];                       // each warp's positive entries
  int wsum[kWarps];                       // each warp's candidates (the block scan)
  u64 lead_key[kWarps][kListed];          // each warp's copy of the lead keys by rank
  float lead_val[kWarps][kListed];        // ... and their values
  // a digit round's counts: a byte per thread and digit, thread t's count
  // of digit d in byte t % 4 of word 32 (t / 4) + (d ^ (t / 4)) % 32 (the
  // xor spreads a warp's lanes over the banks)
  alignas(16) unsigned hist[kThreads / 4][32];
  int part[kWarps][32];                   // per 32 threads, per digit
  // a window's candidates (0-padded to 4), then a spare slot
  alignas(16) float cand_val[kSampleCap + 8];
  alignas(16) int cand_idx[kSampleCap + 8];
  alignas(16) float sorted_val[kSampleWin];    // a window's values by rank
  int sorted_idx[kSampleWin];                  // ... and their ids
  float tex[kWarps][kSampleWin];               // each warp's copy of their texcl
};

// Keys of a row of V entries: (f32 bits << b) | (2^b - 1 - index), b the
// index's bits, so a larger key is a larger value or, at equal values, a
// lower index.
struct SampleKeys {
  int b;
  u64 imask;
  __device__ explicit SampleKeys(int V) {
    b = V > 1 ? 32 - __clz(V - 1) : 0;
    imask = (1ull << b) - 1;
  }
  __device__ u64 key(float x, int i) const {
    return (static_cast<u64>(__float_as_uint(x)) << b) | (imask - static_cast<u64>(i));
  }
  __device__ float value(u64 k) const { return __uint_as_float(static_cast<unsigned>(k >> b)); }
  __device__ int index(u64 k) const { return static_cast<int>(imask - (k & imask)); }
};

__device__ __forceinline__ u64 warp_max_u64(u64 k) {
  const unsigned hi = __reduce_max_sync(kFullMask, static_cast<unsigned>(k >> 32));
  const unsigned lo = __reduce_max_sync(
      kFullMask, static_cast<unsigned>(k >> 32) == hi ? static_cast<unsigned>(k) : 0u);
  return (static_cast<u64>(hi) << 32) | lo;
}

// The warp's first best: the largest score among the lanes' (s, r) with
// valid set and s > -inf, the lowest r among equal scores; every lane gets
// it.  r = -1 when there is none.
struct Best {
  float s;
  int r;
};

__device__ __forceinline__ Best warp_first_best(float s, int r, bool valid) {
  // scores as unsigned integers in the same order (0: none); + 0 turns a
  // -0 into +0, which compares equal to it
  const unsigned bits = __float_as_uint(s + 0.f);
  const unsigned ord =
      valid && s > -CUDART_INF_F ? (bits & 0x80000000u ? ~bits : bits | 0x80000000u) : 0u;
  const unsigned top = __reduce_max_sync(kFullMask, ord);
  if (top == 0) return Best{-CUDART_INF_F, -1};
  const int first = static_cast<int>(
      __reduce_min_sync(kFullMask, ord == top ? static_cast<unsigned>(r) : ~0u));
  return Best{__uint_as_float(top & 0x80000000u ? top & 0x7fffffffu : ~top), first};
}

// f(i, x) for this thread's entries i = threadIdx.x + kThreads s of a row
// of V, x = load(i) (0 past V), kUnroll passes at a time: their loads and
// their chains overlap instead of waiting on each other.
template <int kThreads, int kUnroll, typename Load, typename F>
__device__ __forceinline__ void for_each_entry(int V, Load&& load, F&& f) {
  for (int s0 = 0; threadIdx.x + s0 * kThreads < V; s0 += kUnroll) {
    float x[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = threadIdx.x + (s0 + u) * kThreads;
      x[u] = i < V ? load(i) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) f(threadIdx.x + (s0 + u) * kThreads, x[u]);
  }
}

// (value, index) after (vh, ih) in the stable descending order?  (Bitwise:
// no branch.)
__device__ __forceinline__ bool ranks_after(float x, int i, float vh, int ih) {
  return (x < vh) | ((x == vh) & (i > ih));
}

// One top-p / top-k draw from a row of V entries (f32 >= 0, need not be
// normalized) with noise g[0, n_iter), n_iter = min(top_k, k_cap).  The
// lead round reads entry i as load(i) -- thread i % kThreads alone, so load
// may read work[i] itself -- and stores it to work[i], which the later
// passes read.  V <= 255 kThreads (a thread's digit counts are bytes).
// Every thread returns the same id.  The caller syncs the block before it
// writes work or s again.  kLeadUnroll / kUnroll: the entries a thread
// loads at once in the lead pass / the later passes -- high where the code
// stays in the instruction cache (the sampler kernel), low where it comes
// cold each time (the fused kernels' sample phase runs once between long
// matrix phases, so the draw's cost there follows its code size).
template <int kThreads, int kLeadUnroll, int kUnroll, typename Load>
__device__ int sample_top_p_k_block(float* work, int V, float top_p, int n_iter,
                                    const float* __restrict__ g, SampleScratch<kThreads>& s,
                                    Load&& load) {
  constexpr int kWarps = kThreads / 32;
  constexpr int kListed = kWarps * kSampleLead;
  constexpr int kQ = kSampleWin / 32;  // a window's ranks a lane
  static_assert(kSampleLead == 2 && kListed <= 32, "a thread's top two; one lane a listed key");
  if (n_iter <= 0) return 0;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const SampleKeys keys(V);
  const auto from_work = [&](int i) { return work[i]; };
  // the lead ranks' noise (rank = lane), loaded ahead of the pass
  const float g_lead = lane < min(n_iter, kListed) ? g[lane] : 0.f;

  // ---- the lead round: each thread's top two by value (its indices grow,
  // so a strict '>' keeps the lower index of equal values), its count of
  // positive entries and its smallest
  float v1 = 0.f, v2 = 0.f, vmin = CUDART_INF_F;
  int i1 = 0, i2 = 0, npos = 0;
  for_each_entry<kThreads, kLeadUnroll>(V, load, [&](int i, float x) {
    if (i < V) work[i] = x;
    const bool pos = x > 0.f;
    npos += pos ? 1 : 0;
    vmin = pos ? fminf(vmin, x) : vmin;
    const bool b1 = x > v1, b2 = x > v2;
    v2 = b1 ? v1 : (b2 ? x : v2);
    i2 = b1 ? i1 : (b2 ? i : i2);
    v1 = b1 ? x : v1;
    i1 = b1 ? i : i1;
  });
  // the digit counts start at zero: each thread clears 32 bytes
  reinterpret_cast<uint4*>(&s.hist[0][0])[2 * threadIdx.x] = make_uint4(0, 0, 0, 0);
  reinterpret_cast<uint4*>(&s.hist[0][0])[2 * threadIdx.x + 1] = make_uint4(0, 0, 0, 0);
  u64 top0 = v1 > 0.f ? keys.key(v1, i1) : 0, top1 = v2 > 0.f ? keys.key(v2, i2) : 0;
  u64 listed[kSampleLead];
#pragma unroll
  for (int r = 0; r < kSampleLead; ++r) {  // the lanes' tournaments
    const u64 best = warp_max_u64(top0);
    listed[r] = best;
    if (top0 == best) {  // the winner pops its head (keys are distinct)
      top0 = top1;
      top1 = 0;
    }
  }
  const int wpos = __reduce_add_sync(kFullMask, npos);
  const float wmin = __uint_as_float(__reduce_min_sync(kFullMask, __float_as_uint(vmin)));
  if (lane == 0) {
#pragma unroll
    for (int r = 0; r < kSampleLead; ++r) s.lead[warp][r] = listed[r];
    s.npos[warp] = wpos;
    s.vmin[warp] = wmin;
  }
  __syncthreads();

  // ---- the merge, every warp alike: lane l holds listed key l
  int n_pos = 0;
  float vmin_all = CUDART_INF_F;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    n_pos += s.npos[w];
    vmin_all = fminf(vmin_all, s.vmin[w]);
  }
  if (n_pos == 0) return 0;
  const int n_need = min(n_iter, n_pos);
  const u64 kmin_all = keys.key(vmin_all, V - 1);  // at most the smallest positive key
  const u64* flat = &s.lead[0][0];
  const u64 e = lane < kListed ? flat[lane] : 0;
  int rank = 0;  // empty keys (0) rank past every listed one
#pragma unroll 4
  for (int j = 0; j < kListed; ++j) rank += flat[j] > e ? 1 : 0;
  // exact up to the first rank of a warp's last listed key that has more behind it
  const bool open_end = lane < kListed && lane % kSampleLead == kSampleLead - 1 &&
                        s.npos[lane / kSampleLead] > kSampleLead;
  const int exact = __reduce_min_sync(kFullMask, open_end ? rank + 1 : n_pos);
  const int m = min(exact, n_need);
  // the keys and values in rank order, in this warp's own copy
  if (e != 0) {
    s.lead_key[warp][rank] = e;
    s.lead_val[warp][rank] = keys.value(e);
  }
  __syncwarp();
  float t = 0.f;  // texcl, rank by rank
  float my_t = CUDART_NAN_F;  // texcl at rank `lane`
#pragma unroll 4
  for (int r = 0; r < kListed; ++r) {
    const float v = r < m ? s.lead_val[warp][r] : 0.f;
    if (r == lane) my_t = t;
    t += v;
  }
  const int rl = lane & (kListed - 1);
  const Best lead_best = warp_first_best(logf(s.lead_val[warp][rl]) + g_lead, lane,
                                         lane < m && my_t <= top_p);
  float best = lead_best.s;
  int bidx = lead_best.r >= 0 ? keys.index(s.lead_key[warp][lead_best.r]) : 0;
  if (n_need <= exact || !(t <= top_p)) return bidx;

  // ---- windows of ranks [r0, r0 + n_win), entries after (vh, ih)
  int r0 = m;
  float vh = keys.value(s.lead_key[warp][m - 1]);
  int ih = keys.index(s.lead_key[warp][m - 1]);
  // this thread's counts: byte t % 4 of the words of row t / 4 of hist, added
  // by atomics whose result no one waits for (no chain through memory)
  const int grp = threadIdx.x >> 2;
  const unsigned one = 1u << (8 * (threadIdx.x & 3));
  while (true) {
    const int n_win = min(kSampleWin, n_need - r0);
    float gq[kQ];  // this lane's ranks' noise, loaded ahead of the rounds
#pragma unroll
    for (int q = 0; q < kQ; ++q) {
      const int r = 32 * q + lane;
      gq[q] = r < n_win ? g[r0 + r] : 0.f;
    }
    const u64 k_hi = keys.key(vh, ih);
    // the bucket: every eligible key lies in [kmin_all, k_hi - 1] and shares
    // the bits above h
    const u64 top_key = k_hi - 1;
    int h = top_key == kmin_all ? 0 : 64 - __clzll(static_cast<long long>(top_key ^ kmin_all));
    u64 prefix = top_key >> h;
    int above = 0, bucket = n_pos - r0;
    while (above + bucket > n_win + kSampleSlack && h > 0) {
      const int sft = max(h - kSampleDigit, 0);
      const unsigned dmask = (1u << (h - sft)) - 1u;
      if (sft >= keys.b) {
        // the digit lies in the value bits: the bucket is a range of values
        const int vs = h - keys.b;  // value bits below the bucket's prefix
        const unsigned lo = static_cast<unsigned>(prefix << vs);
        const unsigned hi = lo + ((1u << vs) - 1u);
        const float lo_v = __uint_as_float(lo);
        const float hi_v = hi >= 0x7f800000u ? CUDART_INF_F : __uint_as_float(hi);
        const int dsh = sft - keys.b;
        for_each_entry<kThreads, kUnroll>(V, from_work, [&](int i, float x) {
          const bool el = (x > 0.f) & (x >= lo_v) & (x <= hi_v) & ranks_after(x, i, vh, ih);
          const unsigned d = (__float_as_uint(x) >> dsh) & dmask;
          if (el) atomicAdd(&s.hist[grp][(d ^ grp) & 31], one);
        });
      } else {
        for_each_entry<kThreads, kUnroll>(V, from_work, [&](int i, float x) {
          const u64 k = keys.key(x, i);
          const bool el = (x > 0.f) & (k < k_hi) & ((k >> h) == prefix);
          const unsigned d = static_cast<unsigned>(k >> sft) & dmask;
          if (el) atomicAdd(&s.hist[grp][(d ^ grp) & 31], one);
        });
      }
      __syncthreads();
      // lane d of warp w: digit d over threads 32 w .. 32 w + 31 (bytes of 8
      // words), which it clears for the next round
      unsigned part = 0;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int row = 8 * warp + j;
        unsigned& word = s.hist[row][(lane ^ row) & 31];
        part = __dp4a(word, 0x01010101u, part);
        word = 0;
      }
      s.part[warp][lane] = static_cast<int>(part);
      __syncthreads();
      int tot = 0;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) tot += s.part[w][lane];
      int suf = tot;  // the count of digits >= lane
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int o = __shfl_down_sync(kFullMask, suf, off);
        if (lane + off < 32) suf += o;
      }
      const int dsel = 31 - __clz(__ballot_sync(kFullMask, above + suf >= n_win));
      const int past = __shfl_sync(kFullMask, suf, (dsel + 1) & 31);
      above += dsel < 31 ? past : 0;
      bucket = __shfl_sync(kFullMask, tot, dsel);
      prefix = (prefix << (h - sft)) | static_cast<unsigned>(dsel);
      h = sft;
    }
    // the candidates: after (vh, ih), not after the floor key (vf, i_f)
    const u64 floor_key = prefix << h;
    const float vf = keys.value(floor_key);
    const int i_f = keys.index(floor_key);
    const auto is_cand = [&](int i, float x) {
      return (x > 0.f) & ranks_after(x, i, vh, ih) & ((x > vf) | ((x == vf) & (i <= i_f)));
    };
    // this thread's candidates: their count and (V <= 32 kThreads) its passes
    // that hold one, so the compaction visits only those
    const bool by_mask = V <= 32 * kThreads;
    int mine = 0;
    unsigned passes = 0;
    for_each_entry<kThreads, kUnroll>(V, from_work, [&](int i, float x) {
      const bool c = is_cand(i, x);
      mine += c ? 1 : 0;
      passes |= (c && by_mask ? 1u : 0u) << (((i - threadIdx.x) / kThreads) & 31);
    });
    int incl = mine;  // the block scan of the threads' counts
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int o = __shfl_up_sync(kFullMask, incl, off);
      if (lane >= off) incl += o;
    }
    if (lane == 31) s.wsum[warp] = incl;
    __syncthreads();
    int pos = incl - mine, n_cand = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int ws = s.wsum[w];
      pos += w < warp ? ws : 0;
      n_cand += ws;
    }
    if (by_mask) {
      for (; passes != 0; passes &= passes - 1) {
        const int i = threadIdx.x + (__ffs(passes) - 1) * kThreads;
        s.cand_val[pos] = work[i];
        s.cand_idx[pos] = i;
        ++pos;
      }
    } else {
      for_each_entry<kThreads, kUnroll>(V, from_work, [&](int i, float x) {
        const bool c = is_cand(i, x);
        const int at = c ? pos : kSampleCap + 4;  // the others write the spare slot
        s.cand_val[at] = x;
        s.cand_idx[at] = i;
        pos += c ? 1 : 0;
      });
    }
    if (threadIdx.x < 4) s.cand_val[n_cand + threadIdx.x] = 0.f;  // pads to 4: below all
    __syncthreads();
    // each candidate's rank: the candidates before it, larger or equal with
    // a lower id (ties are common: bf16 logits repeat values)
    const int n4 = (n_cand + 3) / 4;
    const float4* v4 = reinterpret_cast<const float4*>(s.cand_val);
    const int4* i4 = reinterpret_cast<const int4*>(s.cand_idx);
    for (int c = threadIdx.x; c < n_cand; c += kThreads) {
      const float x = s.cand_val[c];
      const int i = s.cand_idx[c];
      int r = 0;
#pragma unroll 2
      for (int j = 0; j < n4; ++j) {
        const float4 f = v4[j];
        const int4 d = i4[j];
        r += ranks_after(x, i, f.x, d.x) + ranks_after(x, i, f.y, d.y) +
             ranks_after(x, i, f.z, d.z) + ranks_after(x, i, f.w, d.w);
      }
      if (r < n_win) {
        s.sorted_val[r] = x;
        s.sorted_idx[r] = i;
      }
    }
    if (threadIdx.x < ((n_win + 3) & ~3) - n_win)
      s.sorted_val[n_win + threadIdx.x] = 0.f;  // the last four's tail adds nothing to texcl
    __syncthreads();
    // the finish: texcl rank by rank, four at a time, written down by lane 0
    // in this warp's own array until it passes top_p; lane l holds ranks
    // l + 32 q
    float* tex = s.tex[warp];
    int reached = 0;
    for (; reached < n_win && t <= top_p; reached += 4) {
      const float4 f = reinterpret_cast<const float4*>(s.sorted_val)[reached / 4];
      if (lane == 0) tex[reached] = t;
      t += f.x;
      if (lane == 0) tex[reached + 1] = t;
      t += f.y;
      if (lane == 0) tex[reached + 2] = t;
      t += f.z;
      if (lane == 0) tex[reached + 3] = t;
      t += f.w;
    }
    __syncwarp();
    float ls = -CUDART_INF_F;  // this lane's first best over its ranks
    int lr = 0;
#pragma unroll
    for (int q = 0; q < kQ; ++q) {
      const int r = 32 * q + lane;
      if (r < min(reached, n_win) && tex[r] <= top_p) {
        const float sc = logf(s.sorted_val[r]) + gq[q];
        if (sc > ls) {
          ls = sc;
          lr = r;
        }
      }
    }
    const Best wb = warp_first_best(ls, lr, true);
    if (wb.r >= 0 && wb.s > best) {  // an earlier window's rank wins a tie
      best = wb.s;
      bidx = s.sorted_idx[wb.r];
    }
    if (r0 + n_win == n_need || !(t <= top_p)) return bidx;
    vh = s.sorted_val[n_win - 1];
    ih = s.sorted_idx[n_win - 1];
    r0 += n_win;
  }
}

}  // namespace mm
