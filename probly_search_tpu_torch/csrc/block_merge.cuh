// Block-level back end of the merge kernels (K1 fused_query_full, K5
// merge_topk): one CTA sorts or merges (key, score) lanes in shared memory,
// reduces them to per-doc totals and selects the top k, in one pass each.
//
//   block_radix_sort  an LSD radix sort of the live lanes over the bits the
//                     keys use (`key_bits`, 8 a pass; pads dropped in the
//                     first): per-warp digit counts of contiguous chunks, a
//                     scan, a stable scatter through registers.  About six
//                     barriers a pass and no data-dependent probing, where
//                     a merge network pays a barrier per comparator stage.
//   block_doc_totals  the thread on each doc's tail lane walks the doc's run:
//                     max over each equal-key run, summed in ascending key
//                     order; the total lands on the tail lane only.
//   block_select      one-pass top-k: a byte-wise radix select over the
//                     64-bit word (order-preserving bits of the total,
//                     ~doc), unique per doc, so exactly min(k, docs) lanes
//                     pass the threshold (ties to the lowest doc); 256-bin
//                     shared histograms, usually 3-4 rounds.
//   sort_words_desc   bitonic sort of the <= k selected words.
//
// Exact as the plain version: the same top-k docs, ties to the lowest doc,
// totals summed in ascending key order; no atomics decide a value, so repeat
// runs are bit-equal.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace blockmerge {

constexpr int32_t kInvalidKey = 0x7fffffff;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ bool live_key(int32_t key) { return key >= 0 && key != kInvalidKey; }

// Order-preserving bits of a float (larger float, larger unsigned).
__device__ __forceinline__ uint32_t order_bits(float f) {
  const uint32_t x = __float_as_uint(f);
  return x ^ ((x >> 31) ? 0xffffffffu : 0x80000000u);
}

__device__ __forceinline__ float order_float(uint32_t u) {
  return __uint_as_float(u ^ ((u >> 31) ? 0x80000000u : 0xffffffffu));
}

// Selection word of a doc total: larger total first, then lower doc.  A
// total > -inf gives a word > 0, so 0 marks "no candidate".
__device__ __forceinline__ uint64_t select_word(float total, int32_t doc) {
  return ((uint64_t)order_bits(total) << 32) | (uint64_t)(0xffffffffu - (uint32_t)doc);
}

__device__ __forceinline__ float word_total(uint64_t w) { return order_float((uint32_t)(w >> 32)); }

__device__ __forceinline__ int32_t word_doc(uint64_t w) {
  return (int32_t)(0xffffffffu - (uint32_t)w);
}

__host__ __device__ __forceinline__ int next_pow2(int x) {
  int p = 1;
  while (p < x) p <<= 1;
  return p;
}

// Words of a top-k buffer: block_select may hand write_topk up to 32 words
// for any k, and write_topk pads to a power of two.
__host__ __device__ __forceinline__ int cand_words(int k) {
  const int p = next_pow2(k);
  return p > 32 ? p : 32;
}

// Radix digit of key x in the pass at `shift`, -1 for a pad (dropped).
__device__ __forceinline__ int radix_digit(int32_t x, int shift) {
  return live_key(x) ? (x >> shift) & 255 : -1;
}

// Add one to hist[bin] for every lane of the warp with bin >= 0, one shared
// atomic per distinct bin (totals share their top bytes).  Every lane of
// the warp must call it.
__device__ __forceinline__ void warp_hist_add(unsigned* hist, int bin) {
  const unsigned peers = __match_any_sync(kFull, bin);
  if (bin >= 0 && (int)(threadIdx.x & 31) == __ffs(peers) - 1) atomicAdd(&hist[bin], __popc(peers));
}

// Shared scratch of the block radix sort.
template <int NT>
struct RadixSmem {
  alignas(16) unsigned short wh[NT / 32][256];  // a warp's count of each digit, then its offset in the digit
  int base[256];                    // the digits' totals, then their first positions
  int total;
  // wh once the sort is done: block_select's packed words.
  static constexpr int kWords = NT / 32 * 256 * 2 / 8;
  __device__ uint64_t* words() { return reinterpret_cast<uint64_t*>(&wh[0][0]); }
};

// Lanes each warp owns in a radix pass over n lanes: a contiguous chunk, a
// multiple of 32 (a thread holds ceil(n / NT) of them).
template <int NT>
__host__ __device__ __forceinline__ int radix_chunk(int n) {
  return ((n + NT - 1) / NT) * 32;
}

// Steps 1 and 2 of an LSD pass over [0, n): each warp walks its chunk 32
// lanes at a time, keeping its lanes in registers (kr, vr) with each lane's
// rank among the earlier lanes of its digit in the chunk (dst; -1 for a pad,
// which is dropped), one shared update per distinct digit of 32 lanes; then
// rs.wh[w][d] becomes warp w's offset within digit d and rs.base[d] the
// digit's total.
template <int NT, int MAXS>
__device__ void radix_rank(const int32_t* ks, const float* vs, int n, int shift,
                           RadixSmem<NT>& rs, int32_t* kr, float* vr, int* dst) {
  constexpr int NW = NT / 32;
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  for (int q = tid; q < NW * 256; q += NT) (&rs.wh[0][0])[q] = 0;
  __syncthreads();
  const int CH = radix_chunk<NT>(n), lo = w * CH, hi = min(n, lo + CH);
#pragma unroll
  for (int s = 0; s < MAXS; ++s) {
    dst[s] = -1;
    const int b = lo + s * 32;
    if (b < hi) {  // warp-uniform
      const int i = b + lane;
      const bool in = i < hi;
      const int32_t x = in ? ks[i] : -1;
      kr[s] = x;
      vr[s] = in ? vs[i] : 0.0f;
      const int d = in ? radix_digit(x, shift) : -1;
      const unsigned peers = __match_any_sync(kFull, d);
      const int rank = __popc(peers & ((1u << lane) - 1));
      if (d >= 0) dst[s] = rs.wh[w][d] + rank;
      __syncwarp();
      if (d >= 0 && rank == 0) rs.wh[w][d] += __popc(peers);
      __syncwarp();
    }
  }
  __syncthreads();
  for (int d = tid; d < 256; d += NT) {
    int run = 0;
    for (int q = 0; q < NW; ++q) {
      const int c = rs.wh[q][d];
      rs.wh[q][d] = run;
      run += c;
    }
    rs.base[d] = run;
  }
  __syncthreads();
}

// Warp 0: exclusive scan of 256 ints in place; returns the sum (lane 0..31).
__device__ __forceinline__ int warp_scan256(int* v) {
  const int lane = threadIdx.x & 31;
  int c[8], s = 0;
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    c[q] = v[8 * lane + q];
    s += c[q];
  }
  int incl = s;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int t = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += t;
  }
  int run = incl - s;
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    v[8 * lane + q] = run;
    run += c[q];
  }
  return __shfl_sync(kFull, incl, 31);
}

// Step 3: each lane's destination, base[d] (the digit's first position) +
// the warp's offset in d + the lane's rank: a stable pass.
template <int NT, int MAXS>
__device__ __forceinline__ void radix_place(const int* base, const RadixSmem<NT>& rs, int shift,
                                            const int32_t* kr, int* dst) {
  const int w = threadIdx.x >> 5;
#pragma unroll
  for (int s = 0; s < MAXS; ++s) {
    if (dst[s] >= 0) {
      const int d = (kr[s] >> shift) & 255;
      dst[s] += base[d] + rs.wh[w][d];
    }
  }
}

// Sort [0, n) ascending by key with an LSD radix sort over the low
// `key_bits` bits (every live key lies below 2^key_bits), 8 bits a pass,
// dropping the pad lanes in the first pass.  Each pass scatters in place:
// the lanes wait in registers until the block has computed every
// destination.  Returns the number of live lanes, now [0, n_live).  Needs
// ceil(n / NT) <= MAXS.
template <int NT, int MAXS>
__device__ int block_radix_sort(int32_t* ks, float* vs, int n, int key_bits, RadixSmem<NT>& rs) {
  int32_t kr[MAXS];
  float vr[MAXS];
  int dst[MAXS];
  for (int shift = 0; shift < key_bits; shift += 8) {
    radix_rank<NT, MAXS>(ks, vs, n, shift, rs, kr, vr, dst);
    if (threadIdx.x < 32) {
      const int total = warp_scan256(rs.base);
      if (threadIdx.x == 0) rs.total = total;
    }
    __syncthreads();
    n = rs.total;
    radix_place<NT, MAXS>(rs.base, rs, shift, kr, dst);
#pragma unroll
    for (int s = 0; s < MAXS; ++s) {
      if (dst[s] >= 0) {
        ks[dst[s]] = kr[s];
        vs[dst[s]] = vr[s];
      }
    }
    __syncthreads();
  }
  return n;
}

// Doc total ending at tail lane i of sorted keys (head found by walking back
// over lanes of the same doc): max over each equal-key run, summed in
// ascending key order.  `kat` / `vat` read lane j.
template <class KeyAt, class ValAt>
__device__ __forceinline__ float doc_total(int i, int32_t doc, int qb, KeyAt kat, ValAt vat,
                                           int& h) {
  h = i;
  while (h > 0 && (kat(h - 1) >> qb) == doc) --h;
  float total = 0.0f;
  int32_t run_key = kat(h);
  float run_max = vat(h);
  for (int j = h + 1; j <= i; ++j) {
    const int32_t kj = kat(j);
    const float vj = vat(j);
    if (kj == run_key) {
      run_max = fmaxf(run_max, vj);
    } else {
      total += run_max;
      run_key = kj;
      run_max = vj;
    }
  }
  return total + run_max;
}

// Tail lane: a live key whose next lane (within [0, n)) holds another doc.
__device__ __forceinline__ bool is_tail(const int32_t* ks, int i, int n, int qb, int32_t key) {
  if (!live_key(key)) return false;
  return i + 1 >= n || (ks[i + 1] >> qb) != (key >> qb);
}

// Per-doc totals on sorted lanes [0, n): each tail lane's score becomes its
// doc's total (-inf when `excl` and not > 0); the doc's other lanes, which
// only the tail's owner reads, and the pad lanes become -inf.  Returns the
// largest selection word of the calling thread's totals (0: none), for
// block_select's floor.
template <int NT>
__device__ uint64_t block_doc_totals(const int32_t* ks, float* vs, int n, int qb, int excl) {
  uint64_t top = 0;
  for (int i = threadIdx.x; i < n; i += NT) {
    const int32_t key = ks[i];
    if (!live_key(key)) {
      vs[i] = -INFINITY;
      continue;
    }
    if (!is_tail(ks, i, n, qb, key)) continue;
    int h;
    const float t = doc_total(
        i, key >> qb, qb, [&](int j) { return ks[j]; }, [&](int j) { return vs[j]; }, h);
    for (int j = h; j < i; ++j) vs[j] = -INFINITY;
    const float v = (!excl || t > 0.0f) ? t : -INFINITY;
    vs[i] = v;
    if (v > -INFINITY) {
      const uint64_t w = select_word(v, key >> qb);
      top = w > top ? w : top;
    }
  }
  __syncthreads();
  return top;
}

struct SelectSmem {
  unsigned hist[2][256];  // this round's histogram, the next round's (zeroed)
  unsigned long long wmax[32];  // each warp's largest word
  unsigned long long prefix;
  int need, shift, done, count, fill, packed;
};

// Warp 0 of a block: given a histogram of 256 byte bins and `need` (>= 1,
// <= total), the bin holding the need-th largest word, and the count of
// words in higher bins.
__device__ __forceinline__ void pick_bin(const unsigned* hist, int need, int& bin, int& above) {
  const int lane = threadIdx.x & 31;
  unsigned c[8];
  unsigned s = 0;
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    c[q] = hist[255 - 8 * lane - q];
    s += c[q];
  }
  unsigned incl = s;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned t = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += t;
  }
  const unsigned excl = incl - s;
  const unsigned hit = __ballot_sync(kFull, excl < (unsigned)need && (unsigned)need <= incl);
  const int src = __ffs(hit) - 1;
  int b = 0, cum = 0;
  if (lane == src) {
    cum = (int)excl;
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      if (b == 0 && cum + (int)c[q] >= need) b = 256 + 255 - 8 * lane - q;
      if (b == 0) cum += (int)c[q];
    }
  }
  bin = __shfl_sync(kFull, b, src) - 256;
  above = __shfl_sync(kFull, cum, src);
}

// One warp: sort the lanes' words descending (every lane must call it).
__device__ __forceinline__ uint64_t warp_sort_desc(uint64_t v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int size = 2; size <= 32; size <<= 1) {
#pragma unroll
    for (int d = size >> 1; d > 0; d >>= 1) {
      const uint64_t o = __shfl_xor_sync(kFull, v, d);
      const bool desc = (lane & size) == 0 || size == 32;
      const bool lower = (lane & d) == 0;
      if (lower == desc ? o > v : o < v) v = o;
    }
  }
  return v;
}

// Histogram sum (warp 0).
__device__ __forceinline__ int hist_total(const unsigned* hist) {
  const int lane = threadIdx.x & 31;
  unsigned s = 0;
  for (int q = lane; q < 256; q += 32) s += hist[q];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(kFull, s, o);
  return (int)s;
}

// Top-k select over the lanes of [0, n) whose value is a doc total (> -inf
// after block_doc_totals; `top` is the calling thread's largest word, as
// block_doc_totals returned it).  Writes m words, unordered, to cand[0 .. m)
// and returns m: min(k, docs) words, or up to 32 words that hold the top k
// (write_topk orders them and keeps k).  `wbuf` (wcap words, free shared
// memory: the radix sort's scratch) holds the packed words.  All threads of
// the block must call it.
//
// For k <= warps the words below a floor are dropped first: the k-th largest
// of the warps' largest words.  At least k words reach it, so the top k lie
// at or above it; the rest are typically a few more than k, and when at most
// 32 remain they are the result without a radix round.
template <int NT>
__device__ int block_select(const int32_t* ks, const float* vs, int n, int qb, int k,
                            uint64_t top, uint64_t* cand, SelectSmem& sm, uint64_t* wbuf,
                            int wcap) {
  constexpr int NW = NT / 32;
  const int tid = threadIdx.x, lane = tid & 31;
  if (k <= NW) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const uint64_t u = __shfl_xor_sync(kFull, top, o);
      top = u > top ? u : top;
    }
    if (lane == 0) sm.wmax[tid >> 5] = top;
  }
  if (tid == 0) {
    sm.prefix = 0;
    sm.need = k;
    sm.shift = 56;
    sm.done = 0;
    sm.count = 0;
    sm.fill = 0;
    sm.packed = 0;
  }
  for (int b = tid; b < 256; b += NT) sm.hist[0][b] = 0;
  __syncthreads();
  // Every warp sorts the warps' largest words itself (no barrier).
  const uint64_t floor =
      k <= NW ? __shfl_sync(kFull, warp_sort_desc(lane < NW ? sm.wmax[lane] : 0), k - 1) : 0;
  auto word = [&](int i) -> uint64_t {
    const float t = vs[i];
    const uint64_t w = t > -INFINITY ? select_word(t, ks[i] >> qb) : 0;
    return w >= floor ? w : 0;
  };
  // Round 0 reads the lanes and packs the words (one per doc) into wbuf;
  // when they all fit, the later rounds and the collection read wbuf only.
  for (int round = 0; round < 8; ++round) {
    unsigned* hist = sm.hist[round & 1];
    const int shift = 56 - 8 * round;
    const unsigned long long hi = round ? sm.prefix >> (shift + 8) : 0;
    const bool packed = round > 0 && sm.packed <= wcap;
    const int len = packed ? sm.packed : n;
    for (int base = 0; base < len; base += NT) {
      const int i = base + tid;
      uint64_t w = 0;
      if (packed) {
        if (i < len) w = wbuf[i];
      } else {
        if (i < n) w = word(i);
        if (round == 0) {
          const unsigned vm = __ballot_sync(kFull, w != 0);
          int slot = 0;
          if (lane == 0 && vm) slot = atomicAdd(&sm.packed, __popc(vm));
          slot = __shfl_sync(kFull, slot, 0) + __popc(vm & ((1u << lane) - 1));
          if (w && slot < wcap) wbuf[slot] = w;
        }
      }
      const bool in = w && (round == 0 || (w >> (shift + 8)) == hi);
      warp_hist_add(hist, in ? (int)((w >> shift) & 255) : -1);
    }
    for (int b = tid; b < 256; b += NT) sm.hist[(round + 1) & 1][b] = 0;
    __syncthreads();
    if (round == 0 && sm.packed <= 32) {  // the packed words hold the top k
      const int m = sm.packed;
      if (tid < m) cand[tid] = wbuf[tid];
      __syncthreads();
      return m;
    }
    if (tid < 32) {
      int need = sm.need;
      if (round == 0) {
        const int total = hist_total(hist);
        need = min(need, total);
        if (tid == 0) sm.count = need;
      }
      if (need == 0) {
        if (tid == 0) sm.done = 1;
      } else {
        int bin, above;
        pick_bin(hist, need, bin, above);
        if (tid == 0) {
          sm.prefix |= (unsigned long long)bin << shift;
          sm.need = need - above;
          sm.shift = shift;
          sm.done = (int)hist[bin] == need - above;
        }
      }
    }
    __syncthreads();
    if (sm.done) break;
  }
  const int m = sm.count;
  if (m > 0) {
    const int shift = sm.shift;
    const unsigned long long thr = sm.prefix >> shift;
    const bool packed = sm.packed <= wcap;
    const int len = packed ? sm.packed : n;
    for (int i = tid; i < len; i += NT) {
      const uint64_t w = packed ? wbuf[i] : word(i);
      if (w && (w >> shift) >= thr) cand[atomicAdd(&sm.fill, 1)] = w;
    }
  }
  __syncthreads();
  return m;
}

// Sort words[0, p) descending (p a power of two), all threads of the block.
template <int NT>
__device__ void sort_words_desc(uint64_t* w, int p) {
  for (int m = 2; m <= p; m <<= 1) {
    for (int d = m >> 1; d > 0; d >>= 1) {
      for (int t = threadIdx.x; t < p / 2; t += NT) {
        const int i = ((t & ~(d - 1)) << 1) | (t & (d - 1));
        const int j = i + d;
        const bool desc = (i & m) == 0;
        const uint64_t a = w[i], b = w[j];
        if (desc ? a < b : a > b) {
          w[i] = b;
          w[j] = a;
        }
      }
      __syncthreads();
    }
  }
}

// Pad words[m, p) with 0, sort descending, write the k results of a row.
// Up to 32 words one warp sorts them in registers (no block barriers).
template <int NT>
__device__ void write_topk(uint64_t* w, int m, int k, float* out_s, int32_t* out_d) {
  const int p = next_pow2(m > 0 ? m : 1);
  if (p <= 32) {
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      const uint64_t v = warp_sort_desc(lane < m ? w[lane] : 0);
      if (lane < k) {
        out_s[lane] = lane < m ? word_total(v) : -INFINITY;
        out_d[lane] = lane < m ? word_doc(v) : -1;
      }
    }
    for (int i = 32 + threadIdx.x; i < k; i += NT) {
      out_s[i] = -INFINITY;
      out_d[i] = -1;
    }
    return;
  }
  for (int i = m + threadIdx.x; i < p; i += NT) w[i] = 0;
  __syncthreads();
  sort_words_desc<NT>(w, p);
  for (int i = threadIdx.x; i < k; i += NT) {
    const bool hit = i < m;
    out_s[i] = hit ? word_total(w[i]) : -INFINITY;
    out_d[i] = hit ? word_doc(w[i]) : -1;
  }
}

}  // namespace blockmerge
