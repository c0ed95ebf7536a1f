// Fused zero-to-one query kernel for Hopper (sm_90a): gather, ordered sort,
// per-field first-valid reduction, pool sums, max over fields, top-k.
//
// Replaces the Pallas TPU kernel of probly_search_tpu/ops/pallas_z2o.py
// (_z2o_kernel / _z2o_kernel_body, launched by fused_z2o_topk), the fast
// zero-to-one program for queries whose expansion nodes are not shared.  For
// each query row of a class with L = NC * C lanes:
//
//   1. gather rec[:, c_start : c_start + C] for every live chunk;
//   2. k1 = doc << 5 | alive << 4 | qterm on payload lanes, -1 on leading
//      pads, INT32_MAX on trailing pads; k2 = rank << 14 | lane;
//   3. per field f: contrib_f = min(s / tf_f, 1) * tf_f / max(flen_f, qlen),
//      or -1 where the lane is not live or tf_f == 0;
//   4. order the lanes by (k1, k2);
//   5. per field, keep the first valid contribution of each (doc, alive,
//      qterm) group, i.e. the oracle's best entry per (doc, field, qterm):
//      rank orders a group by entry score descending, lane by enumeration;
//   6. sum those per doc in qterm order, take the max over fields, then
//      max(., 0), and keep only docs whose key says alive;
//   7. top-k, ties to the lowest doc.
//
// What bounds it on this card: the gather reads (2 + 2F) int32 rows per
// payload lane, scattered over the index by the chunk starts; everything
// after it stays in shared memory.  The design, one CTA per query row (256
// threads up to 2,048 lanes, so four rows share an SM; 512 beyond), dead
// rows emitting the empty sentinel at once:
//
//   gather  the row's chunk tables are read once (into shared memory up to
//           64 chunks); each thread takes 4 consecutive lanes of a chunk and
//           loads them as one 16-B vector per record row, all 2 + 2F loads
//           in flight before the first is used (chunk starts are multiples
//           of 128 and rec's rows are padded to 128 int32, so the vectors
//           are aligned).  That keeps up to 80 KB of loads in flight per
//           CTA, more than a shared-memory ring could hold beside the row's
//           lanes (at L = 8,192 and F = 4 the lanes take 196,608 B and
//           leave ~24 KB).  Pad lanes and dead chunks read nothing.
//   order   no 64-bit key: the chunks are laid out in ascending (rank, chunk)
//           order, lane p of a chunk at position(chunk) * C + p, and a
//           stable LSD radix sort by k1 alone (block_merge.cuh, over the
//           index's key_bits) leaves equal k1 in (rank, chunk, p) order,
//           which is the k2 order: a doc appears at most once per chunk.
//           Pads and the lanes of latently dead docs (all of a doc's postings
//           share its liveness, and a dead doc never scores) are dropped in
//           the first pass.  The sort carries each lane's slot; the F
//           contribution arrays stay where the gather wrote them.
//   reduce  the owner of a doc's tail lane walks the doc's run (at most NC
//           lanes) and leaves the doc's score on the tail lane.
//   top-k   on (score, ~doc) words, unique per doc, so ties go to the lowest
//           doc.  For k <= 32 each warp keeps its 32 largest words in
//           registers as the reduction produces them (a warp-wide bitonic
//           merge, skipped when no new word beats the list's k-th), and one
//           warp merges the warps' lists: no pass over the lanes and no
//           rounds, whatever the ties (z2o scores tie often, and a radix
//           select then runs all 8 rounds).  Past 32, block_select and
//           write_topk, the words in device scratch past what shared memory
//           holds.
//
// Shared memory is sized to the class (z2o_launch in ops/fused_z2o.py), so
// narrow classes run several CTAs per SM.  Built without --use_fast_math, so
// divisions stay IEEE-rounded and contributions equal the JAX engine's bit
// for bit; only the per-doc sums are taken in another order.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "block_merge.cuh"
#include "device_scope.cuh"

namespace {

using blockmerge::kFull;
using blockmerge::kInvalidKey;
constexpr int kQtBits = 4;
constexpr int kDocShift = kQtBits + 1;  // k1 = doc << 5 | alive << 4 | qterm
constexpr int kMaxFields = 4;
constexpr int kTableChunks = 64;  // chunk tables held in shared memory up to this NC
constexpr int kListK = 32;        // k up to which the warps' lists give the top k

struct Z2oArgs {
  const int32_t* rec;      // [R, rec_stride] transposed posting records
  int64_t rec_stride;      // P + C padded; a multiple of 4 (16-B rows)
  const int32_t* c_start;  // [B, NC] chunk start column in rec
  const int32_t* c_skip;   // [B, NC] payload begins at this lane of the chunk
  const int32_t* c_len;    // [B, NC] payload length (0: dead chunk)
  const int32_t* c_qterm;  // [B, NC] dense query-term index
  const float* c_score;    // [B, NC] entry score s of the chunk's job
  const int32_t* c_rank;   // [B, NC] per-query dense rank of s (descending)
  const float* qlen;       // [B] query_terms_len, empty tokens included
  int NC, C, F, k;
  int key_bits;            // every live k1 lies below 2^key_bits
  uint64_t* cand;          // [B, cand_words(k)] top-k words in device memory, or
                           // null: in shared memory (k > kListK only)
};

// One row's chunk tables: in shared memory up to kTableChunks chunks, else
// the row's slice of device memory.
struct Tables {
  const int32_t *start, *skip, *len, *qterm, *rank;
  const float* score;
};

struct TableSmem {
  int32_t start[kTableChunks], skip[kTableChunks], len[kTableChunks], qterm[kTableChunks],
      rank[kTableChunks];
  float score[kTableChunks];
};

// Bytes of the chunk-position table (int16 a chunk), rounded up to 16.
__host__ __device__ __forceinline__ int pos_bytes(int NC) { return (2 * NC + 15) & ~15; }

// Dynamic shared memory of one row: ks int32[L], vs f32[L], cs f32[F][L],
// the chunk positions, and the top-k words of a k past kListK when they sit
// there (`words`).
__host__ __device__ __forceinline__ long long z2o_smem(int NC, int C, int F, int k, bool words) {
  const long long L = (long long)NC * C;
  const bool held = words && k > kListK;
  return (8 + 4LL * F) * L + pos_bytes(NC) + (held ? 8LL * blockmerge::cand_words(k) : 0);
}

template <int V>
struct Vec;
template <>
struct Vec<4> {
  using T = int4;
  __device__ static T load(const int32_t* p) { return __ldg(reinterpret_cast<const int4*>(p)); }
  __device__ static int32_t at(const T& v, int q) {
    return q == 0 ? v.x : q == 1 ? v.y : q == 2 ? v.z : v.w;
  }
};
template <>
struct Vec<1> {
  using T = int32_t;
  __device__ static T load(const int32_t* p) { return __ldg(p); }
  __device__ static int32_t at(T v, int) { return v; }
};

// Gather: V consecutive lanes a thread (V = 4 when C is a multiple of 4),
// lane p of chunk c into slot pos[c] * C + p: k1 into ks (kInvalidKey on pads
// and dead docs), the slot's own index into vs, contributions into cs.
template <int NT, int V>
__device__ __forceinline__ void gather(const Z2oArgs& a, const Tables& tb, const short* pos,
                                       int32_t* ks, float* vs, float* cs) {
  using VT = typename Vec<V>::T;
  const int C = a.C, F = a.F, L = a.NC * C;
  const int64_t s = a.rec_stride;
  const int cshift = __ffs(C) - 1;  // C is a power of two
  const float ql = a.qlen[blockIdx.x];
  for (int g = threadIdx.x * V; g < L; g += NT * V) {
    const int c = g >> cshift, p = g & (C - 1);
    const int skip = tb.skip[c], len = tb.len[c];
    const int slot = pos[c] * C + p;
    if (p + V <= skip || p >= skip + len) {  // pads only: read nothing
#pragma unroll
      for (int q = 0; q < V; ++q) ks[slot + q] = kInvalidKey;
      continue;
    }
    const int32_t* r = a.rec + tb.start[c] + p;
    const VT doc = Vec<V>::load(r);
    const VT alive = Vec<V>::load(r + (1 + 2 * F) * s);
    VT tf[kMaxFields], fl[kMaxFields];
#pragma unroll
    for (int f = 0; f < kMaxFields; ++f) {
      if (f < F) {
        tf[f] = Vec<V>::load(r + (1 + f) * s);
        fl[f] = Vec<V>::load(r + (1 + F + f) * s);
      }
    }
    const int qterm = tb.qterm[c];
    const float sc = tb.score[c];
#pragma unroll
    for (int q = 0; q < V; ++q) {
      const int lane = p + q;
      const bool live = lane >= skip && lane < skip + len && Vec<V>::at(alive, q) > 0;
      ks[slot + q] = live ? (Vec<V>::at(doc, q) << kDocShift) | (1 << kQtBits) | qterm : kInvalidKey;
      vs[slot + q] = __int_as_float(slot + q);
#pragma unroll
      for (int f = 0; f < kMaxFields; ++f) {
        if (f < F) {
          const float tfv = (float)Vec<V>::at(tf[f], q);
          const float flen = __int_as_float(Vec<V>::at(fl[f], q));
          cs[(int64_t)f * L + slot + q] =
              tfv > 0.0f ? fminf(sc / tfv, 1.0f) * tfv / fmaxf(flen, ql) : -1.0f;
        }
      }
    }
  }
}

// Warp-wide: the 32 largest words of two descending lists, descending
// (lane j holds the j-th): the elementwise max of a and b reversed is a
// bitonic sequence holding them, then a bitonic merge.
__device__ __forceinline__ uint64_t warp_list_merge(uint64_t a, uint64_t b) {
  const int lane = threadIdx.x & 31;
  const uint64_t r = __shfl_sync(kFull, b, 31 - lane);
  uint64_t v = a > r ? a : r;
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    const uint64_t o = __shfl_xor_sync(kFull, v, d);
    v = (lane & d) == 0 ? (o > v ? o : v) : (o < v ? o : v);
  }
  return v;
}

// Warp-wide: add the words w (one a lane, any order; 0 = none) to the
// warp's descending list l, unless none beats its kk-th largest word.
__device__ __forceinline__ uint64_t warp_list_add(uint64_t l, uint64_t w, int kk) {
  if (!__any_sync(kFull, w > __shfl_sync(kFull, l, kk - 1))) return l;
  return warp_list_merge(l, blockmerge::warp_sort_desc(w));
}

// Per doc run of the n sorted live lanes: the owner of a doc's tail lane
// reads the run (every field: the first valid contribution of each equal-k1
// group, summed in ascending qterm order; the max over fields, then
// max(., 0)), leaves the score on the tail lane and -inf on the run's other
// lanes, which only it reads.  Each warp walks 32 consecutive lanes at a
// time and adds its docs' words to its list of the 32 largest; returns the
// calling lane's entry of its warp's list.
template <int NT>
__device__ __forceinline__ uint64_t doc_scores(const Z2oArgs& a, const int32_t* ks, float* vs,
                                               const float* cs, int n) {
  const int L = a.NC * a.C;
  const int lane = threadIdx.x & 31;
  const int kk = a.k < kListK ? a.k : kListK;
  uint64_t list = 0;
  for (int b = threadIdx.x - lane; b < n; b += NT) {  // warp-uniform
    const int i = b + lane;
    uint64_t w = 0;
    const int32_t doc = i < n ? ks[i] >> kDocShift : -1;
    if (i < n && (i + 1 >= n || (ks[i + 1] >> kDocShift) != doc)) {  // a tail
      int h = i;
      while (h > 0 && (ks[h - 1] >> kDocShift) == doc) --h;
      float best = -INFINITY;
      for (int f = 0; f < a.F; ++f) {
        const float* c = cs + (int64_t)f * L;
        float total = 0.0f;
        int32_t grp = -1;
        bool taken = false;
        for (int j = h; j <= i; ++j) {
          const int32_t kj = ks[j];
          if (kj != grp) {
            grp = kj;
            taken = false;
          }
          if (!taken) {
            const float v = c[__float_as_int(vs[j])];
            if (v >= 0.0f) {
              total += v;
              taken = true;
            }
          }
        }
        best = fmaxf(best, total);
      }
      const float score = fmaxf(best, 0.0f);
      for (int j = h; j < i; ++j) vs[j] = -INFINITY;
      vs[i] = score;
      w = blockmerge::select_word(score, doc);
    }
    list = warp_list_add(list, w, kk);
  }
  __syncthreads();
  return list;
}

// k <= kListK: one warp merges the warps' lists (staged in `buf`, NT words)
// and writes the k results, -inf / -1 past the docs.
template <int NT>
__device__ __forceinline__ void lists_topk(uint64_t list, int k, uint64_t* buf, float* os,
                                           int32_t* od) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  buf[threadIdx.x] = list;
  __syncthreads();
  if (warp == 0) {
    uint64_t v = list;
    for (int j = 1; j < NT / 32; ++j) {
      const uint64_t b = buf[j * 32 + lane];
      if (__shfl_sync(kFull, b, 0) > __shfl_sync(kFull, v, k - 1)) v = warp_list_merge(v, b);
    }
    if (lane < k) {
      os[lane] = v ? blockmerge::word_total(v) : -INFINITY;
      od[lane] = v ? blockmerge::word_doc(v) : -1;
    }
  }
}

// One query row a CTA of NT threads.  CLOCK (tools/torch_stage_probe.py
// only) writes each block's cycles per stage (gather, merge, per-doc
// reduction, top-k, write) to clk[row][5].
template <int NT, int MAXS, bool CLOCK>
__device__ __forceinline__ void z2o_body(const Z2oArgs& a, float* __restrict__ out_s,
                                         int32_t* __restrict__ out_d, long long* clk) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ blockmerge::SelectSmem sel;
  __shared__ blockmerge::RadixSmem<NT> rs;
  __shared__ TableSmem tsm;
  long long stamp[6];
  if (CLOCK) stamp[0] = clock64();

  const int row = blockIdx.x;
  const int tid = threadIdx.x;
  const int NC = a.NC, C = a.C, L = NC * C;
  const int64_t t0 = (int64_t)row * NC;
  int32_t* ks = reinterpret_cast<int32_t*>(smem);
  float* vs = reinterpret_cast<float*>(ks + L);
  float* cs = vs + L;
  short* pos = reinterpret_cast<short*>(cs + (int64_t)a.F * L);
  float* os = out_s + (int64_t)row * a.k;
  int32_t* od = out_d + (int64_t)row * a.k;

  // The row's tables (one read of device memory), and the dead-row skip: a
  // row with no live chunk emits the empty sentinel.
  const bool in_smem = NC <= kTableChunks;
  Tables tb;
  if (in_smem) {
    tb = {tsm.start, tsm.skip, tsm.len, tsm.qterm, tsm.rank, tsm.score};
  } else {
    tb = {a.c_start + t0, a.c_skip + t0, a.c_len + t0, a.c_qterm + t0, a.c_rank + t0,
          a.c_score + t0};
  }
  int my_live = 0;
  for (int c = tid; c < NC; c += NT) {
    const int len = a.c_len[t0 + c];
    my_live |= len > 0;
    if (in_smem) {
      tsm.start[c] = a.c_start[t0 + c];
      tsm.skip[c] = a.c_skip[t0 + c];
      tsm.len[c] = len;
      tsm.qterm[c] = a.c_qterm[t0 + c];
      tsm.rank[c] = a.c_rank[t0 + c];
      tsm.score[c] = a.c_score[t0 + c];
    }
  }
  if (!__syncthreads_or(my_live)) {
    for (int i = tid; i < a.k; i += NT) {
      os[i] = -INFINITY;
      od[i] = -1;
    }
    return;
  }
  // Chunk positions: ascending (rank, chunk).
  for (int c = tid; c < NC; c += NT) {
    const int32_t r = tb.rank[c];
    int p = 0;
    for (int d = 0; d < NC; ++d) {
      const int32_t rd = tb.rank[d];
      p += rd < r || (rd == r && d < c);
    }
    pos[c] = (short)p;
  }
  __syncthreads();
  if ((C & 3) == 0)
    gather<NT, 4>(a, tb, pos, ks, vs, cs);
  else
    gather<NT, 1>(a, tb, pos, ks, vs, cs);
  __syncthreads();
  if (CLOCK) stamp[1] = clock64();

  const int n = blockmerge::block_radix_sort<NT, MAXS>(ks, vs, L, a.key_bits, rs);
  if (CLOCK) stamp[2] = clock64();
  const uint64_t list = doc_scores<NT>(a, ks, vs, cs, n);
  if (CLOCK) stamp[3] = clock64();
  if (a.k <= kListK) {
    lists_topk<NT>(list, a.k, rs.words(), os, od);
    if (CLOCK) stamp[4] = clock64();
  } else {
    uint64_t* cand = a.cand ? a.cand + (int64_t)row * blockmerge::cand_words(a.k)
                            : reinterpret_cast<uint64_t*>(reinterpret_cast<unsigned char*>(pos) +
                                                          pos_bytes(NC));
    const int m = blockmerge::block_select<NT>(ks, vs, n, kDocShift, a.k, list, cand, sel,
                                               rs.words(), rs.kWords);
    if (CLOCK) stamp[4] = clock64();
    blockmerge::write_topk<NT>(cand, m, a.k, os, od);
  }
  if (CLOCK) {
    __syncthreads();
    stamp[5] = clock64();
    if (tid == 0)
      for (int q = 0; q < 5; ++q) clk[(int64_t)row * 5 + q] = stamp[q + 1] - stamp[q];
  }
}

template <int NT, int MAXS, int MINB>
__global__ void __launch_bounds__(NT, MINB)
    fused_z2o_kernel(Z2oArgs a, float* __restrict__ out_s, int32_t* __restrict__ out_d) {
  z2o_body<NT, MAXS, false>(a, out_s, out_d, nullptr);
}

// The variants by L: threads per block, lanes a thread holds in a radix pass
// (ceil(L / threads)), and the blocks per SM the registers are held to.  256
// threads up to 2,048 lanes, so four rows share an SM; 512 beyond.
#define Z2O_VARIANTS(X) X(256, 8, 4) X(512, 8, 2) X(512, 16, 2)

// Index of the variant for L lanes (L <= 8,192).
int z2o_variant(int L) { return L <= 2048 ? 0 : L <= 4096 ? 1 : 2; }

Z2oArgs make_z2o_args(const int32_t* rec, long long rec_stride, const int32_t* c_start,
                      const int32_t* c_skip, const int32_t* c_len, const int32_t* c_qterm,
                      const float* c_score, const int32_t* c_rank, const float* qlen, int NC,
                      int C, int F, int k, int key_bits, void* cand) {
  Z2oArgs a;
  a.rec = rec;
  a.rec_stride = rec_stride;
  a.c_start = c_start;
  a.c_skip = c_skip;
  a.c_len = c_len;
  a.c_qterm = c_qterm;
  a.c_score = c_score;
  a.c_rank = c_rank;
  a.qlen = qlen;
  a.NC = NC;
  a.C = C;
  a.F = F;
  a.k = k;
  a.key_bits = key_bits;
  a.cand = (uint64_t*)cand;
  return a;
}

// True for shapes the kernel takes with a dynamic shared memory of `smem`
// bytes that holds the call's layout (`words`: the top-k words there).
bool z2o_ok(int NC, int C, int F, int k, int key_bits, long long smem, bool words) {
  const long long L = (long long)NC * C;
  return F >= 1 && F <= kMaxFields && NC >= 1 && C >= 1 && (C & (C - 1)) == 0 && L <= 8192 &&
         k >= 1 && k <= L && key_bits >= 1 && key_bits <= 31 &&
         smem >= z2o_smem(NC, C, F, k, words);
}

}  // namespace

extern "C" {

// Once per device: lift the kernel's shared-memory cap to what a block may
// use beside its static shared memory; returns those dynamic bytes (< 0:
// error).
int fused_z2o_init(int device) {
  const probly::DeviceScope scope(device);
  if (scope.error() != cudaSuccess) return -1;
  int optin = 0;
  if (cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device) !=
      cudaSuccess)
    return -1;
  int avail = optin;
#define STATIC(NT, M, MB)                                                                  \
  {                                                                                        \
    cudaFuncAttributes fa;                                                                 \
    if (cudaFuncGetAttributes(&fa, fused_z2o_kernel<NT, M, MB>) != cudaSuccess) return -1; \
    const int left = optin - (int)fa.sharedSizeBytes;                                      \
    avail = left < avail ? left : avail;                                                   \
  }
  Z2O_VARIANTS(STATIC)
#undef STATIC
#define ALLOW(NT, M, MB)                                                                 \
  if (cudaFuncSetAttribute(fused_z2o_kernel<NT, M, MB>,                                  \
                           cudaFuncAttributeMaxDynamicSharedMemorySize, avail) != cudaSuccess) \
    return -1;
  Z2O_VARIANTS(ALLOW)
#undef ALLOW
  return avail;
}

// Launches on ``stream`` of CUDA device ``device``, one CTA per row of B, and
// returns cudaGetLastError() (0 = ok).  The device is selected for the call
// only (device_scope.cuh): the caller's current device is left as it was.
// ``smem`` is the call's dynamic shared memory (z2o_launch), within what
// fused_z2o_init allowed; ``cand`` is null, or [B, cand_words(k)] words of
// device memory for a k whose words do not fit beside the row.  Returns
// cudaErrorInvalidValue for shapes the kernel does not take (the wrapper
// checks them first).
int fused_z2o(int device, const int32_t* rec, long long rec_stride, const int32_t* c_start,
              const int32_t* c_skip, const int32_t* c_len, const int32_t* c_qterm,
              const float* c_score, const int32_t* c_rank, const float* qlen, int B, int NC,
              int C, int F, int k, int key_bits, long long smem, void* cand, float* out_s,
              int32_t* out_d, void* stream) {
  if (B == 0) return 0;
  if (!z2o_ok(NC, C, F, k, key_bits, smem, cand == nullptr)) return (int)cudaErrorInvalidValue;
  const probly::DeviceScope scope(device);
  if (scope.error() != cudaSuccess) return (int)scope.error();
  const Z2oArgs a = make_z2o_args(rec, rec_stride, c_start, c_skip, c_len, c_qterm, c_score,
                                  c_rank, qlen, NC, C, F, k, key_bits, cand);
  cudaStream_t st = (cudaStream_t)stream;
  const int want = z2o_variant(NC * C);
  int v = 0;
#define LAUNCH(NT, M, MB) \
  if (v++ == want) fused_z2o_kernel<NT, M, MB><<<B, NT, (size_t)smem, st>>>(a, out_s, out_d);
  Z2O_VARIANTS(LAUNCH)
#undef LAUNCH
  return (int)cudaGetLastError();
}

}  // extern "C"
