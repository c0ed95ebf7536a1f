// Standalone merge kernel (K5) for Hopper (sm_90a): sort + segmented max and
// sum + top-k of [B, L] (key, score) lanes.
//
// Replaces the Pallas TPU kernel of probly_search_tpu/ops/pallas_merge.py
// (merge_scores_topk_pallas, body merge_body): the reference's
// max_score_merger rule over lanes keyed doc << qterm_bits | qterm,
//
//   sort the row by key                 (run = 0: a full sort; run > 0: the
//                                        row arrives as ascending runs of
//                                        `run` lanes and only the merge
//                                        levels from `run` up are done)
//   max over each run of equal keys     ("max within a query term")
//   sum of those maxima per doc         ("sum across query terms", in
//                                        ascending qterm order)
//   top-k doc totals, ties to the lowest doc.
//
// live = key != INT32_MAX && key >= 0: run = 0 rows pad with INT32_MAX only;
// run > 0 rows carry -1 leading pads, INT32_MAX trailing pads and -inf
// scores on latently dead docs (which poison the doc's total).  excl drops
// totals that are not > 0.  The Pallas `max_seg` bound only shortens its
// scan ladder; this kernel walks each doc's run, so it needs none.
//
// One call launches several kernels, because a row of up to 2^24 lanes does
// not fit one block's shared memory:
//   1. sort_tile:   tiles of kTile lanes sorted in shared memory (every
//                   network level whose blocks fit a tile);
//   2. per level past the tile: one global launch per comparator distance
//      of at least a tile (stage), then sort_tile again for the distances
//      that fit a tile;
//   3. doc_total:   the thread on each doc's last lane walks the doc's run
//                   and leaves its total there (-inf on every other lane);
//   4. topk_seg:    segments of kSeg lanes reduce to k candidates each (k
//                   rounds of a block arg-max in shared memory), repeated
//                   until one segment is left, whose k winners are the row's
//                   result.
// The network is the bitonic sorter in its all-ascending form (each level a
// "flip" stage pairing i with the mirror lane, then half-cleaners), run on a
// virtual power-of-two lane space whose tail [L, Lp) holds phantom +inf
// keys: a pair whose high lane is a phantom never swaps, so skipping it is
// exactly the virtual network on the real lanes, for any L.  The network is
// not stable; equal keys only meet in the max, and distinct keys of a doc
// are summed in key order, so the result does not depend on it.
//
// What bounds it on this card: memory traffic of the sort.  Each global
// stage reads and writes the row's 8 B per lane once; a row of 2^23 lanes
// takes 10 sort_tile passes and 55 global stages.  The bound reckoned for
// it (chip_smoke.py) is the function's own traffic: each input lane read
// once and the [B, k] result written once.  The design keeps every stage
// with a distance below the tile in shared memory, so global stages are
// only the log2(L / kTile) distances of each long level.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int32_t kInvalidKey = 0x7fffffff;
constexpr int32_t kNoLane = 0x7fffffff;
constexpr int kTile = 8192;          // lanes per block in sort_tile
constexpr int kTileThreads = 1024;
constexpr int kStageThreads = 256;
constexpr int kSegThreads = 512;

__device__ __forceinline__ void cmpx(int32_t* ks, float* vs, int64_t i, int64_t j) {
  const int32_t ki = ks[i], kj = ks[j];
  if (ki > kj) {
    ks[i] = kj;
    ks[j] = ki;
    const float v = vs[i];
    vs[i] = vs[j];
    vs[j] = v;
  }
}

// Lanes (i, j) of pair t in a flip stage of level m (blocks of 2m lanes,
// i paired with its mirror) or a half-cleaner of distance d.
__device__ __forceinline__ void flip_pair(int t, int m, int& i, int& j) {
  const int base = (t & ~(m - 1)) << 1, o = t & (m - 1);
  i = base + o;
  j = base + 2 * m - 1 - o;
}

__device__ __forceinline__ void half_pair(int t, int d, int& i, int& j) {
  i = ((t & ~(d - 1)) << 1) | (t & (d - 1));
  j = i + d;
}

// Grid (tiles, B).  Loads tile `blockIdx.x` of row `blockIdx.y` from
// (kin, vin), runs half-cleaners d_top .. 1 (when d_top > 0), then levels
// m_lo <= m < m_hi, and stores the tile to (kout, vout), which may be
// (kin, vin).  All pairs lie in the tile; pairs whose high lane is at or
// past L are skipped.
__global__ void __launch_bounds__(kTileThreads)
    sort_tile_kernel(const int32_t* kin, const float* vin, int32_t* kout, float* vout, int L,
                     int tile, int d_top, int m_lo, int m_hi) {
  extern __shared__ int32_t smem[];
  int32_t* ks = smem;
  float* vs = reinterpret_cast<float*>(smem + tile);
  const int64_t row = (int64_t)blockIdx.y * L;
  const int t0 = blockIdx.x * tile;
  const int n = min(tile, L - t0);  // real lanes of this tile
  for (int p = threadIdx.x; p < n; p += blockDim.x) {
    ks[p] = kin[row + t0 + p];
    vs[p] = vin[row + t0 + p];
  }
  __syncthreads();
  const int half = tile >> 1;
  for (int d = d_top; d >= 1; d >>= 1) {
    for (int t = threadIdx.x; t < half; t += blockDim.x) {
      int i, j;
      half_pair(t, d, i, j);
      if (j < n) cmpx(ks, vs, i, j);
    }
    __syncthreads();
  }
  for (int m = m_lo; m < m_hi; m <<= 1) {
    for (int t = threadIdx.x; t < half; t += blockDim.x) {
      int i, j;
      flip_pair(t, m, i, j);
      if (j < n) cmpx(ks, vs, i, j);
    }
    __syncthreads();
    for (int d = m >> 1; d >= 1; d >>= 1) {
      for (int t = threadIdx.x; t < half; t += blockDim.x) {
        int i, j;
        half_pair(t, d, i, j);
        if (j < n) cmpx(ks, vs, i, j);
      }
      __syncthreads();
    }
  }
  for (int p = threadIdx.x; p < n; p += blockDim.x) {
    kout[row + t0 + p] = ks[p];
    vout[row + t0 + p] = vs[p];
  }
}

// One comparator stage in device memory: grid (ceil(Lp / 2 / threads), B);
// flip stage of level m when `flip`, else the half-cleaner of distance d.
__global__ void __launch_bounds__(kStageThreads)
    stage_kernel(int32_t* __restrict__ ks, float* __restrict__ vs, int L, int half,
                 int m, int d, int flip) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= half) return;
  int i, j;
  if (flip)
    flip_pair(t, m, i, j);
  else
    half_pair(t, d, i, j);
  if (j < L) {
    const int64_t row = (int64_t)blockIdx.y * L;
    cmpx(ks + row, vs + row, i, j);
  }
}

// Doc totals on the sorted row: grid (ceil(L / threads), B).
__global__ void __launch_bounds__(kStageThreads)
    doc_total_kernel(const int32_t* __restrict__ ks, const float* __restrict__ vs,
                     float* __restrict__ tot, int L, int qb, int excl) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= L) return;
  const int64_t row = (int64_t)blockIdx.y * L;
  const int32_t* k = ks + row;
  const float* v = vs + row;
  const int32_t key = k[i];
  float out = -INFINITY;
  const int32_t doc = key >> qb;
  if (key >= 0 && key != kInvalidKey && !(i + 1 < L && (k[i + 1] >> qb) == doc)) {
    int h = i;
    while (h > 0 && (k[h - 1] >> qb) == doc) --h;
    float total = 0.0f;
    int32_t run_key = k[h];
    float run_max = v[h];
    for (int j = h + 1; j <= i; ++j) {
      const int32_t kj = k[j];
      const float vj = v[j];
      if (kj == run_key) {
        run_max = fmaxf(run_max, vj);
      } else {
        total += run_max;
        run_key = kj;
        run_max = vj;
      }
    }
    total += run_max;
    if (!excl || total > 0.0f) out = total;
  }
  tot[row + i] = out;
}

// (value, lane, slot) arg-max: the larger value, ties to the lower lane.
struct Best {
  float v;
  int lane, slot;
};

__device__ __forceinline__ void better(Best& b, float v, int lane, int slot) {
  if (v > b.v || (v == b.v && lane < b.lane)) {
    b.v = v;
    b.lane = lane;
    b.slot = slot;
  }
}

__device__ __forceinline__ void warp_best(Best& b) {
  for (int off = 16; off > 0; off >>= 1) {
    const float v = __shfl_down_sync(0xffffffffu, b.v, off);
    const int lane = __shfl_down_sync(0xffffffffu, b.lane, off);
    const int slot = __shfl_down_sync(0xffffffffu, b.slot, off);
    better(b, v, lane, slot);
  }
}

// Grid (nseg, B).  Segment s of row r holds entries [s * seg, (s+1) * seg)
// of the row's n candidates (values `val`, lanes `lane`, or the entry's own
// position when `lane` is null).  Writes its k best as candidates
// [B, nseg, k] (cv, ci), or, when `out_s` is set (one segment), the row's
// result: the score and the doc of the winning lane of the sorted keys.
__global__ void __launch_bounds__(kSegThreads)
    topk_seg_kernel(const float* __restrict__ val, const int32_t* __restrict__ lane,
                    int n, int seg, int k, float* __restrict__ cv,
                    int32_t* __restrict__ ci, const int32_t* __restrict__ ks, int L,
                    int qb, float* __restrict__ out_s, int32_t* __restrict__ out_d) {
  extern __shared__ int32_t smem[];
  float* sv = reinterpret_cast<float*>(smem);
  int32_t* si = smem + seg;
  __shared__ Best red[kSegThreads / 32];
  __shared__ int done;

  const int s = blockIdx.x, r = blockIdx.y, nseg = gridDim.x;
  const int tid = threadIdx.x;
  const int64_t src = (int64_t)r * n + (int64_t)s * seg;
  const int m = min(seg, n - s * seg);
  for (int p = tid; p < seg; p += blockDim.x) {
    if (p < m) {
      sv[p] = val[src + p];
      si[p] = lane ? lane[src + p] : s * seg + p;
    } else {
      sv[p] = -INFINITY;
      si[p] = kNoLane;
    }
  }
  __syncthreads();

  const int w = tid & 31, warp = tid >> 5, nwarps = blockDim.x >> 5;
  const int64_t dst = ((int64_t)r * nseg + s) * k;
  for (int q = 0; q < k; ++q) {
    Best b{-INFINITY, kNoLane, -1};
    for (int p = tid; p < seg; p += blockDim.x) better(b, sv[p], si[p], p);
    warp_best(b);
    if (w == 0) red[warp] = b;
    __syncthreads();
    if (warp == 0) {
      b = w < nwarps ? red[w] : Best{-INFINITY, kNoLane, -1};
      warp_best(b);
      if (w == 0) {
        const bool found = b.v > -INFINITY;
        const int last = found ? q + 1 : k;
        for (int o = q; o < last; ++o) {
          if (out_s) {
            out_s[(int64_t)r * k + o] = found ? b.v : -INFINITY;
            out_d[(int64_t)r * k + o] = found ? ks[(int64_t)r * L + b.lane] >> qb : -1;
          } else {
            cv[dst + o] = found ? b.v : -INFINITY;
            ci[dst + o] = found ? b.lane : kNoLane;
          }
        }
        if (found) sv[b.slot] = -INFINITY;
        done = !found;
      }
    }
    __syncthreads();
    if (done) break;
  }
}

size_t align256(size_t x) { return (x + 255) & ~(size_t)255; }

int seg_lanes(int k) { return k <= 2048 ? 8192 : 16384; }

int64_t ceil_div(int64_t a, int64_t b) { return (a + b - 1) / b; }

// Candidates per row after the first and the second top-k pass.
void cand_sizes(int L, int k, int64_t& n1, int64_t& n2) {
  const int seg = seg_lanes(k);
  n1 = ceil_div(L, seg) * k;
  n2 = ceil_div(n1, seg) * k;
}

}  // namespace

extern "C" {

// Bytes of scratch one merge_topk call needs.
long long merge_topk_workspace(int B, int L, int k) {
  int64_t n1, n2;
  cand_sizes(L, k, n1, n2);
  const size_t lanes = (size_t)B * L;
  return (long long)(3 * align256(lanes * 4) + 2 * align256((size_t)B * n1 * 4) +
                     2 * align256((size_t)B * n2 * 4));
}

// K5 on `stream` of CUDA device `device`: key int32[B, L], score f32[B, L]
// -> out_s f32[B, k], out_d int32[B, k].  `ws` holds merge_topk_workspace
// bytes.  Returns the first CUDA error (0 = ok).
int merge_topk(int device, const int32_t* key, const float* score, int B, int L,
               int k, int qterm_bits, int run, int excl, void* ws, float* out_s,
               int32_t* out_d, void* stream) {
  if (B == 0) return 0;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t st = (cudaStream_t)stream;
  int64_t n1, n2;
  cand_sizes(L, k, n1, n2);
  char* p = (char*)ws;
  const size_t lanes = (size_t)B * L;
  int32_t* ks = (int32_t*)p;
  p += align256(lanes * 4);
  float* vs = (float*)p;
  p += align256(lanes * 4);
  float* tot = (float*)p;
  p += align256(lanes * 4);
  float* cv[2];
  int32_t* ci[2];
  cv[0] = (float*)p;
  p += align256((size_t)B * n1 * 4);
  ci[0] = (int32_t*)p;
  p += align256((size_t)B * n1 * 4);
  cv[1] = (float*)p;
  p += align256((size_t)B * n2 * 4);
  ci[1] = (int32_t*)p;

  // 1-2. Sort.  Levels start at `run` (1 for a full sort).
  int Lp = 1;
  while (Lp < L) Lp <<= 1;
  const int tile = Lp < kTile ? Lp : kTile;
  const int ntiles = (int)ceil_div(L, tile);
  const int m0 = run > 0 ? run : 1;
  const size_t tile_smem = (size_t)tile * 8;
  e = cudaFuncSetAttribute(sort_tile_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)tile_smem);
  if (e != cudaSuccess) return (int)e;
  const int tile_threads = tile / 2 < kTileThreads ? (tile / 2 < 32 ? 32 : tile / 2) : kTileThreads;
  sort_tile_kernel<<<dim3(ntiles, B), tile_threads, tile_smem, st>>>(
      key, score, ks, vs, L, tile, 0, m0, tile);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  const int half = Lp / 2;
  const dim3 stage_grid((unsigned)ceil_div(half, kStageThreads), B);
  for (int m = m0 > tile ? m0 : tile; m < Lp; m <<= 1) {
    stage_kernel<<<stage_grid, kStageThreads, 0, st>>>(ks, vs, L, half, m, 0, 1);
    for (int d = m >> 1; d >= tile; d >>= 1)
      stage_kernel<<<stage_grid, kStageThreads, 0, st>>>(ks, vs, L, half, m, d, 0);
    sort_tile_kernel<<<dim3(ntiles, B), tile_threads, tile_smem, st>>>(
        ks, vs, ks, vs, L, tile, tile >> 1, 0, 0);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  }

  // 3. Doc totals.
  doc_total_kernel<<<dim3((unsigned)ceil_div(L, kStageThreads), B), kStageThreads, 0, st>>>(
      ks, vs, tot, L, qterm_bits, excl);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;

  // 4. Top-k passes.
  const int seg = seg_lanes(k);
  const size_t seg_smem = (size_t)seg * 8;
  e = cudaFuncSetAttribute(topk_seg_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)seg_smem);
  if (e != cudaSuccess) return (int)e;
  const float* val = tot;
  const int32_t* lane = nullptr;
  int64_t n = L;
  for (int pass = 0; n > seg; ++pass) {
    const int nseg = (int)ceil_div(n, seg);
    const int b = pass & 1;
    topk_seg_kernel<<<dim3(nseg, B), kSegThreads, seg_smem, st>>>(
        val, lane, (int)n, seg, k, cv[b], ci[b], ks, L, qterm_bits, nullptr, nullptr);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    val = cv[b];
    lane = ci[b];
    n = (int64_t)nseg * k;
  }
  topk_seg_kernel<<<dim3(1, B), kSegThreads, seg_smem, st>>>(
      val, lane, (int)n, seg, k, nullptr, nullptr, ks, L, qterm_bits, out_s, out_d);
  return (int)cudaGetLastError();
}

}  // extern "C"
