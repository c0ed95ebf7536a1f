// Standalone merge kernel (K5) for Hopper (sm_90a): sort + segmented max and
// sum + top-k of [B, L] (key, score) lanes.
//
// Replaces the Pallas TPU kernel of probly_search_tpu/ops/pallas_merge.py
// (merge_scores_topk_pallas, body merge_body): the reference's
// max_score_merger rule over lanes keyed doc << qterm_bits | qterm,
//
//   sort the row by key                 (run = 0: a full sort; run > 0: the
//                                        row arrives as ascending runs of
//                                        `run` lanes)
//   max over each run of equal keys     ("max within a query term")
//   sum of those maxima per doc         ("sum across query terms", in
//                                        ascending qterm order)
//   top-k doc totals, ties to the lowest doc.
//
// live = key != INT32_MAX && key >= 0: run = 0 rows pad with INT32_MAX only;
// run > 0 rows carry -1 leading pads, INT32_MAX trailing pads and -inf
// scores on latently dead docs (which poison the doc's total).  excl drops
// totals that are not > 0.
//
// What bounds it on this card: the bytes of the row (8 B a lane, read once)
// and, past one block's shared memory, the passes over device memory that a
// sort needs.  Two paths, chosen by shape alone (B, L, k and the card's
// shared-memory limit; ops/fused_merge.py merge_plan):
//
//   block    L <= 16,384: one CTA per row, one launch.  The row sits in
//            shared memory; the block back end (block_merge.cuh) radix-sorts
//            its live lanes over `key_bits`, totals the docs and selects the
//            top k in one pass.
//   radix    longer rows: an LSD radix sort of the live lanes over the
//            `key_bits` bits that live keys use (3 passes of 8 bits at 24),
//            each pass a histogram (with the digit totals), a scan (one block
//            per digit) and a stable scatter kernel; then
//            one kernel totals the docs, compacts the candidates and builds
//            the first histogram of a radix select on the same 64-bit words;
//            7 rounds of a count kernel (each block replays the earlier
//            rounds' picks from their histograms and returns at once when the
//            threshold is found), a compaction of the k winners and one block
//            that orders them.
// No path calls a library sort or top-k; no path is chosen because another
// failed.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "block_merge.cuh"
#include "device_scope.cuh"

using namespace blockmerge;

namespace {

constexpr int kThreads = 1024;          // block path
constexpr int kSpan = 16;               // lanes a thread holds in a radix pass
constexpr int kRadixThreads = 256;
// Lanes per block of the radix passes: short rows take small tiles (more
// blocks in flight), long rows large ones (fewer per-block counts to scan).
__host__ __device__ __forceinline__ int radix_tile(int L) { return L <= (1 << 20) ? 1024 : 4096; }
constexpr int kRadixGrid = 1056;        // blocks per row of the grid-stride kernels
constexpr int kMaxPasses = 4;           // 8-bit digits of a 31-bit key

size_t align256(size_t x) { return (x + 255) & ~(size_t)255; }

// --------------------------------------------------------------------------
// block path

__global__ void __launch_bounds__(kThreads)
    merge_block_kernel(const int32_t* __restrict__ key, const float* __restrict__ score, int L,
                       int k, int qb, int key_bits, int excl, float* __restrict__ out_s,
                       int32_t* __restrict__ out_d) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ SelectSmem sel;
  __shared__ RadixSmem<kThreads> rs;
  int32_t* ks = reinterpret_cast<int32_t*>(smem);
  float* vs = reinterpret_cast<float*>(ks + L);
  uint64_t* cand = reinterpret_cast<uint64_t*>(vs + L);
  const int64_t row = blockIdx.x;
#pragma unroll 8
  for (int i = threadIdx.x; i < L; i += kThreads) {
    ks[i] = key[row * L + i];
    vs[i] = score[row * L + i];
  }
  __syncthreads();
  const int n = block_radix_sort<kThreads, kSpan>(ks, vs, L, key_bits, rs);
  const uint64_t top = block_doc_totals<kThreads>(ks, vs, n, qb, excl);
  const int m = block_select<kThreads>(ks, vs, n, qb, k, top, cand, sel, rs.words(), rs.kWords);
  write_topk<kThreads>(cand, m, k, out_s + row * k, out_d + row * k);
}

// --------------------------------------------------------------------------
// radix path.  Per row b: bh int32[256][nblk] digit counts (then offsets),
// ints[4] = (live lanes, candidates, winners collected, -), sel uint32[8][256].

__global__ void __launch_bounds__(kRadixThreads)
    radix_hist_kernel(const int32_t* __restrict__ kin, int L, const int* __restrict__ ints,
                      int shift, int nblk, int filter, int* __restrict__ bh,
                      int* __restrict__ dtot) {
  __shared__ int hist[256];
  const int b = blockIdx.y, blk = blockIdx.x, tid = threadIdx.x;
  const int n = filter ? L : ints[b * 4];
  hist[tid] = 0;
  __syncthreads();
  const int tile = radix_tile(L);
  const int lo = blk * tile, hi = min(n, lo + tile);
  const int32_t* k = kin + (int64_t)b * L;
  for (int i = lo + tid; i < hi; i += kRadixThreads) {
    const int32_t x = k[i];
    if (!filter || live_key(x)) atomicAdd(&hist[(x >> shift) & 255], 1);
  }
  __syncthreads();
  bh[((int64_t)b * 256 + tid) * nblk + blk] = hist[tid];
  if (hist[tid]) atomicAdd(&dtot[b * 256 + tid], hist[tid]);
}

// Grid (256, B): block d turns digit d's per-block counts into scatter
// offsets, the digit's base (the counts of the lower digits, from the
// per-pass digit totals) plus an exclusive scan over the blocks.  Pass 0
// also records the live lanes and clears the row's select state.
__global__ void __launch_bounds__(kRadixThreads)
    radix_scan_kernel(int* __restrict__ bh, int nblk, const int* __restrict__ dtot,
                      int* __restrict__ ints, unsigned* __restrict__ sel, int first_pass) {
  constexpr int kWarps = kRadixThreads / 32;
  __shared__ int warp_sum[kWarps];
  __shared__ int base;
  const int d = blockIdx.x, b = blockIdx.y, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int* dt = dtot + b * 256;
  if (warp == 0) {
    int s = 0;
    for (int q = lane; q < d; q += 32) s += dt[q];
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(kFull, s, o);
    if (lane == 0) base = s;
  }
  int* h = bh + ((int64_t)b * 256 + d) * nblk;
  const int per = (nblk + kRadixThreads - 1) / kRadixThreads;
  const int lo = min(nblk, tid * per), hi = min(nblk, lo + per);
  int s = 0;
  for (int i = lo; i < hi; ++i) s += h[i];
  int incl = s;
  for (int o = 1; o < 32; o <<= 1) {
    const int t = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += t;
  }
  if (lane == 31) warp_sum[warp] = incl;
  __syncthreads();
  int run = base + incl - s;
  for (int w = 0; w < warp; ++w) run += warp_sum[w];
  for (int i = lo; i < hi; ++i) {
    const int c = h[i];
    h[i] = run;
    run += c;
  }
  if (first_pass) {
    if (d == 255 && tid == 0) ints[b * 4] = base + dt[255];
    if (d == 0) {
      if (tid < 3) ints[b * 4 + 1 + tid] = 0;
      for (int i = tid; i < 8 * 256; i += kRadixThreads) sel[(int64_t)b * 8 * 256 + i] = 0;
    }
  }
}

// Stable scatter of one block's lanes by digit: sub-tiles of 256 lanes in
// lane order, ranks within a warp by __match_any_sync, across warps by a
// per-digit prefix over the warps' counts.
__global__ void __launch_bounds__(kRadixThreads)
    radix_scatter_kernel(const int32_t* __restrict__ kin, const float* __restrict__ vin, int L,
                         const int* __restrict__ ints, int shift, int nblk, int filter,
                         const int* __restrict__ bh, int32_t* __restrict__ kout,
                         float* __restrict__ vout) {
  constexpr int kWarps = kRadixThreads / 32;
  __shared__ int base[256];
  __shared__ int wcnt[kWarps][256];
  const int b = blockIdx.y, blk = blockIdx.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int n = filter ? L : ints[b * 4];
  const int64_t row = (int64_t)b * L;
  base[tid] = bh[((int64_t)b * 256 + tid) * nblk + blk];
  const int tile = radix_tile(L);
  const int lo = blk * tile, hi = min(n, lo + tile);
  const unsigned lt = (1u << lane) - 1;
  for (int sub = lo; sub < hi; sub += kRadixThreads) {
#pragma unroll
    for (int w = 0; w < kWarps; ++w) wcnt[w][tid] = 0;
    __syncthreads();
    const int i = sub + tid;
    int32_t x = 0;
    float v = 0.0f;
    bool ok = i < hi;
    if (ok) {
      x = kin[row + i];
      v = vin[row + i];
      ok = !filter || live_key(x);
    }
    const int d = ok ? (x >> shift) & 255 : 256;
    const unsigned peers = __match_any_sync(kFull, d);
    const int rank = __popc(peers & lt);
    if (ok && rank == 0) wcnt[warp][d] = __popc(peers);
    __syncthreads();
    {
      int run = base[tid];
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const int c = wcnt[w][tid];
        wcnt[w][tid] = run;
        run += c;
      }
      base[tid] = run;
    }
    __syncthreads();
    if (ok) {
      const int p = wcnt[warp][d] + rank;
      kout[row + p] = x;
      vout[row + p] = v;
    }
    __syncthreads();
  }
}

// Doc totals of the sorted live lanes; each valid total's word goes to the
// candidate list and the first select histogram (top byte).
__global__ void __launch_bounds__(kRadixThreads)
    radix_totals_kernel(const int32_t* __restrict__ ks, const float* __restrict__ vs, int L,
                        int qb, int excl, int* __restrict__ ints, uint64_t* __restrict__ cand,
                        unsigned* __restrict__ sel) {
  __shared__ unsigned hist[256];
  const int b = blockIdx.y, tid = threadIdx.x;
  hist[tid] = 0;
  __syncthreads();
  const int n = ints[b * 4];
  const int32_t* k = ks + (int64_t)b * L;
  const float* v = vs + (int64_t)b * L;
  for (int i0 = blockIdx.x * kRadixThreads; i0 < n; i0 += gridDim.x * kRadixThreads) {
    const int i = i0 + tid;
    int bin = -1;
    if (i < n) {
      const int32_t x = k[i];
      if (is_tail(k, i, n, qb, x)) {
        int h;
        const float t = doc_total(
            i, x >> qb, qb, [&](int j) { return k[j]; }, [&](int j) { return v[j]; }, h);
        if (t > -INFINITY && (!excl || t > 0.0f)) {
          const uint64_t w = select_word(t, x >> qb);
          cand[(int64_t)b * L + atomicAdd(&ints[b * 4 + 1], 1)] = w;
          bin = (int)(w >> 56);
        }
      }
    }
    warp_hist_add(hist, bin);
  }
  __syncthreads();
  if (hist[tid]) atomicAdd(&sel[(int64_t)b * 8 * 256 + tid], hist[tid]);
}

// A row's select state: the threshold prefix of the rounds picked so far,
// the words still needed below it, the last picked round's shift, done
// (the threshold found), and m = min(k, candidates).
struct SelState {
  unsigned long long prefix;
  int need, shift, done, count;
};

// Warp 0 of a block: replay the picks of rounds [0, rounds) from the row's
// histograms (sel[round][256]) into `st`.  Every lane runs every shuffle.
__device__ void replay(const unsigned* sel, int rounds, int k, SelState& st) {
  const int total = hist_total(sel);
  int need = min(k, total);
  unsigned long long prefix = 0;
  int shift = 56, done = need == 0;
  for (int q = 0; q < rounds && !done; ++q) {
    const unsigned* h = sel + q * 256;
    int bin, above;
    pick_bin(h, need, bin, above);
    shift = 56 - 8 * q;
    prefix |= (unsigned long long)bin << shift;
    need -= above;
    done = (int)h[bin] == need;
  }
  if ((threadIdx.x & 31) == 0) {
    st.prefix = prefix;
    st.need = need;
    st.shift = shift;
    st.done = done;
    st.count = min(k, total);
  }
}

// Round `round`'s histogram: the next byte of the candidates that match the
// prefix picked from the earlier rounds (each block replays those picks).
__global__ void __launch_bounds__(kRadixThreads)
    radix_count_kernel(const uint64_t* __restrict__ cand, int L, const int* __restrict__ ints,
                       unsigned* __restrict__ sel, int k, int round) {
  __shared__ unsigned hist[256];
  __shared__ SelState st;
  const int b = blockIdx.y, tid = threadIdx.x;
  unsigned* s = sel + (int64_t)b * 8 * 256;
  hist[tid] = 0;
  if (tid < 32) replay(s, round, k, st);
  __syncthreads();
  if (st.done) return;
  const int shift = 56 - 8 * round;
  const unsigned long long hi = st.prefix >> (shift + 8);
  const int n = ints[b * 4 + 1];
  const uint64_t* c = cand + (int64_t)b * L;
  for (int i0 = blockIdx.x * kRadixThreads; i0 < n; i0 += gridDim.x * kRadixThreads) {
    const int i = i0 + tid;
    const uint64_t w = i < n ? c[i] : 0;
    warp_hist_add(hist, i < n && (w >> (shift + 8)) == hi ? (int)((w >> shift) & 255) : -1);
  }
  __syncthreads();
  if (hist[tid]) atomicAdd(&s[round * 256 + tid], hist[tid]);
}

// The min(k, candidates) words at or above the threshold, unordered.
__global__ void __launch_bounds__(kRadixThreads)
    radix_collect_kernel(const uint64_t* __restrict__ cand, int L, int* __restrict__ ints,
                         const unsigned* __restrict__ sel, int k, int kpad,
                         uint64_t* __restrict__ outc) {
  __shared__ SelState st;
  const int b = blockIdx.y, tid = threadIdx.x;
  if (tid < 32) replay(sel + (int64_t)b * 8 * 256, 8, k, st);
  __syncthreads();
  if (st.count == 0) return;
  const unsigned long long thr = st.prefix >> st.shift;
  const int n = ints[b * 4 + 1];
  const uint64_t* c = cand + (int64_t)b * L;
  for (int i = blockIdx.x * kRadixThreads + tid; i < n; i += gridDim.x * kRadixThreads) {
    const uint64_t w = c[i];
    if ((w >> st.shift) >= thr) outc[(int64_t)b * kpad + atomicAdd(&ints[b * 4 + 2], 1)] = w;
  }
}

__global__ void __launch_bounds__(kThreads)
    radix_finish_kernel(const uint64_t* __restrict__ outc, const int* __restrict__ ints, int k,
                        int kpad, float* __restrict__ out_s, int32_t* __restrict__ out_d) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* w = reinterpret_cast<uint64_t*>(smem);
  const int64_t b = blockIdx.x;
  const int m = min(k, ints[b * 4 + 2]);
  for (int i = threadIdx.x; i < m; i += kThreads) w[i] = outc[b * kpad + i];
  __syncthreads();
  write_topk<kThreads>(w, m, k, out_s + b * k, out_d + b * k);
}

// Scratch of the radix path.
struct RadixWs {
  int32_t* keys[2];
  float* vals[2];
  uint64_t* cand;
  int* bh;
  int* dtot;
  unsigned* sel;
  int* ints;
  uint64_t* outc;
};

// The radix path's scratch laid out from `ws` (ops/fused_merge.py
// merge_plan sizes it the same way); returns the bytes it needs.
size_t radix_ws(void* ws, int B, int L, int kpad, int nblk, RadixWs* w) {
  char* const base = (char*)ws;
  size_t off = 0;
  auto take = [&](size_t bytes) {
    char* q = base + off;
    off += align256(bytes);
    return q;
  };
  const size_t lanes = (size_t)B * L;
  for (int i = 0; i < 2; ++i) {
    w->keys[i] = (int32_t*)take(lanes * 4);
    w->vals[i] = (float*)take(lanes * 4);
  }
  w->cand = (uint64_t*)take(lanes * 8);
  w->bh = (int*)take((size_t)B * 256 * nblk * 4);
  w->dtot = (int*)take((size_t)B * kMaxPasses * 256 * 4);
  w->sel = (unsigned*)take((size_t)B * 8 * 256 * 4);
  w->ints = (int*)take((size_t)B * 16);
  w->outc = (uint64_t*)take((size_t)B * kpad * 8);
  return off;
}

int launch_radix(const int32_t* key, const float* score, int B, int L, int k, int qb, int excl,
                 int key_bits, void* ws, long long ws_bytes, float* out_s, int32_t* out_d,
                 cudaStream_t st) {
  const int nblk = (L + radix_tile(L) - 1) / radix_tile(L);
  const int kpad = next_pow2(k);
  RadixWs w;
  if (radix_ws(ws, B, L, kpad, nblk, &w) > (size_t)ws_bytes) return (int)cudaErrorInvalidValue;
  const dim3 pass_grid(nblk, B);
  const int passes = (key_bits + 7) / 8;
  const int32_t* kin = key;
  const float* vin = score;
  int cur = 0;
  cudaError_t e = cudaMemsetAsync(w.dtot, 0, (size_t)B * kMaxPasses * 256 * 4, st);
  if (e != cudaSuccess) return (int)e;
  for (int p = 0; p < passes; ++p) {
    const int first = p == 0;
    int* dtot = w.dtot + (size_t)p * B * 256;
    radix_hist_kernel<<<pass_grid, kRadixThreads, 0, st>>>(kin, L, w.ints, 8 * p, nblk, first,
                                                           w.bh, dtot);
    radix_scan_kernel<<<dim3(256, B), kRadixThreads, 0, st>>>(w.bh, nblk, dtot, w.ints, w.sel,
                                                              first);
    radix_scatter_kernel<<<pass_grid, kRadixThreads, 0, st>>>(
        kin, vin, L, w.ints, 8 * p, nblk, first, w.bh, w.keys[cur], w.vals[cur]);
    kin = w.keys[cur];
    vin = w.vals[cur];
    cur ^= 1;
  }
  const dim3 grid(min((L + kRadixThreads - 1) / kRadixThreads, kRadixGrid), B);
  radix_totals_kernel<<<grid, kRadixThreads, 0, st>>>(kin, vin, L, qb, excl, w.ints, w.cand,
                                                      w.sel);
  for (int round = 1; round < 8; ++round)
    radix_count_kernel<<<grid, kRadixThreads, 0, st>>>(w.cand, L, w.ints, w.sel, k, round);
  radix_collect_kernel<<<grid, kRadixThreads, 0, st>>>(w.cand, L, w.ints, w.sel, k, kpad,
                                                       w.outc);
  radix_finish_kernel<<<B, kThreads, (size_t)kpad * 8, st>>>(w.outc, w.ints, k, kpad, out_s,
                                                              out_d);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Once per device: lift the block kernel's shared-memory cap to the card's
// opt-in maximum (less its static shared memory); returns the dynamic bytes
// a block may use (< 0: error).
int merge_topk_init(int device) {
  const probly::DeviceScope scope(device);
  if (scope.error() != cudaSuccess) return -1;
  int smem_max = 0;
  if (cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, device) !=
      cudaSuccess)
    return -1;
  const int avail = smem_max - (int)(sizeof(SelectSmem) + sizeof(RadixSmem<kThreads>) + 64);
  if (cudaFuncSetAttribute(merge_block_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           avail) != cudaSuccess)
    return -1;
  return avail;
}

// K5 on `stream` of CUDA device `device`: key int32[B, L], score f32[B, L]
// -> out_s f32[B, k], out_d int32[B, k], along the path merge_plan chose
// (0 block, with `smem` bytes of dynamic shared memory; 1 radix over
// `key_bits`, in `ws`, `ws_bytes` bytes of scratch).  Returns the first CUDA
// error (0 = ok); cudaErrorInvalidValue when the scratch is too small.
int merge_topk(int device, const int32_t* key, const float* score, int B, int L, int k,
               int qterm_bits, int excl, int key_bits, int path, long long smem, void* ws,
               long long ws_bytes, float* out_s, int32_t* out_d, void* stream) {
  if (B == 0) return 0;
  const probly::DeviceScope scope(device);
  if (scope.error() != cudaSuccess) return (int)scope.error();
  cudaStream_t st = (cudaStream_t)stream;
  if (path == 0) {
    merge_block_kernel<<<B, kThreads, (size_t)smem, st>>>(key, score, L, k, qterm_bits,
                                                          key_bits, excl, out_s, out_d);
    return (int)cudaGetLastError();
  }
  return launch_radix(key, score, B, L, k, qterm_bits, excl, key_bits, ws, ws_bytes, out_s, out_d,
                      st);
}

}  // extern "C"
