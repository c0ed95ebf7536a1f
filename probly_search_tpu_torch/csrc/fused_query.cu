// Fused BM25 query kernel for Hopper (sm_90a): gather, score, merge, top-k.
//
// Replaces the Pallas TPU kernel of probly_search_tpu/ops/pallas_query.py
// (_query_kernel / _query_kernel_body, launched by fused_query_topk) and its
// merge stage, probly_search_tpu/ops/pallas_merge.py (merge_body with
// _oddeven_merge_runs_inplace and _segmented_scan_inplace).  Two entry
// points share the gather + score stage:
//
//   fused_query_full   phase "full":  one CTA per query row; the row's
//                      NC * C scored lanes live in dynamic shared memory,
//                      are merged, reduced per doc and top-k selected there;
//                      only [B, k] results go back to device memory.
//   fused_query_lanes  phase "lanes": one CTA per (row, chunk); writes the
//                      [B, NC * C] key and score lanes to device memory for
//                      classes too wide for one CTA's shared memory (the
//                      merge then runs in torch).
//
// What bounds it on this card: the gather.  Each payload lane reads R int32
// rows of the transposed posting record array rec[R, P + C] (16 B per lane at
// R = 4, one field), scattered over the index by the chunk starts; the merge
// and top-k touch shared memory only.  The design reads every row of rec
// coalesced along the lanes (neighbouring threads, neighbouring postings),
// reads nothing for pad lanes and dead chunks, skips rows that have no live
// chunk, and keeps every intermediate out of device memory in the full phase.
//
// Semantics follow the JAX kernel exactly:
//   score = scale * sum_f boost_f * (k1 + 1) tf / (tf + k1 (1 - b + b flen/avg))
//   excl:  scores <= 0 clamp to 0, doc totals that are not > 0 are dropped
//   latently dead docs (liveness row 0) score -inf, which poisons their total
//   key = doc << qterm_bits | qterm; leading pads -1, trailing pads INT32_MAX
//   top-k ties go to the lowest doc.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int32_t kInvalidKey = 0x7fffffff;
constexpr int kFullThreads = 512;
constexpr int kLanesThreads = 256;

struct QueryArgs {
  const int32_t* rec;     // [R, rec_stride] transposed posting records
  int64_t rec_stride;     // P + C
  const int32_t* c_start; // [B, NC] chunk start column in rec
  const int32_t* c_skip;  // [B, NC] payload begins at this lane of the chunk
  const int32_t* c_len;   // [B, NC] payload length (0: dead chunk)
  const int32_t* c_qterm; // [B, NC] dense query-term index
  const float* c_scale;   // [B, NC] idf * expansion boost (host before_each)
  const float* scalars;   // [2F] field_avg, fields_boost
  int NC, C, F, k, qterm_bits, excl;
  float k1, b;
};

// Key and score of lane p of chunk t (flat [B, NC] table index).
__device__ __forceinline__ void lane_key_score(const QueryArgs& a, int64_t t,
                                               int skip, int len, int p,
                                               int32_t& key, float& score) {
  if (p < skip || p >= skip + len) {
    key = p < skip ? -1 : kInvalidKey;
    score = 0.0f;
    return;
  }
  const int64_t s = a.rec_stride;
  const int32_t* r = a.rec + (int64_t)a.c_start[t] + p;
  const int32_t doc = r[0];
  const int32_t alive = r[(int64_t)(1 + 2 * a.F) * s];
  float base = 0.0f;
  for (int f = 0; f < a.F; ++f) {
    const float tf = (float)r[(int64_t)(1 + f) * s];
    const float flen = __int_as_float(r[(int64_t)(1 + a.F + f) * s]);
    const float avg = a.scalars[f];
    const float boost = a.scalars[a.F + f];
    const float denom = a.k1 * ((1.0f - a.b) + a.b * (flen / avg)) + tf;
    const float tf_norm = tf > 0.0f ? ((a.k1 + 1.0f) * tf) / denom : 0.0f;
    base = f == 0 ? tf_norm * boost : base + tf_norm * boost;
  }
  float sc = base * a.c_scale[t];
  if (a.excl) sc = sc > 0.0f ? sc : 0.0f;
  if (alive <= 0) sc = -INFINITY;
  key = (doc << a.qterm_bits) | a.c_qterm[t];
  score = sc;
}

__device__ __forceinline__ void compare_exchange(int32_t* ks, float* vs, int i, int j) {
  const int32_t ki = ks[i], kj = ks[j];
  if (ki > kj) {
    ks[i] = kj;
    ks[j] = ki;
    const float v = vs[i];
    vs[i] = vs[j];
    vs[j] = v;
  }
}

// (value, lane) arg-max with ties to the lower lane.
__device__ __forceinline__ void better(float& bv, int& bi, float v, int i) {
  if (v > bv || (v == bv && i < bi)) {
    bv = v;
    bi = i;
  }
}

__device__ __forceinline__ void warp_argmax(float& bv, int& bi) {
  for (int off = 16; off > 0; off >>= 1) {
    const float v = __shfl_down_sync(0xffffffffu, bv, off);
    const int i = __shfl_down_sync(0xffffffffu, bi, off);
    better(bv, bi, v, i);
  }
}

// Full phase.  Dynamic shared memory: ks int32[L], vs f32[L], L = NC * C.
__global__ void __launch_bounds__(kFullThreads)
    fused_query_full_kernel(QueryArgs a, float* __restrict__ out_s,
                            int32_t* __restrict__ out_d) {
  extern __shared__ int32_t smem[];
  __shared__ float red_v[kFullThreads / 32];
  __shared__ int red_i[kFullThreads / 32];
  __shared__ int done;

  const int row = blockIdx.x;
  const int tid = threadIdx.x;
  const int L = a.NC * a.C;
  const int64_t t0 = (int64_t)row * a.NC;
  int32_t* ks = smem;
  float* vs = reinterpret_cast<float*>(smem + L);

  // Dead-row skip: a row with no live chunk (class padding) emits the empty
  // sentinel and does no gather or merge.
  int my_live = 0;
  for (int c = tid; c < a.NC; c += blockDim.x) my_live |= a.c_len[t0 + c] > 0;
  if (!__syncthreads_or(my_live)) {
    for (int i = tid; i < a.k; i += blockDim.x) {
      out_s[(int64_t)row * a.k + i] = -INFINITY;
      out_d[(int64_t)row * a.k + i] = -1;
    }
    return;
  }

  // Gather + score into shared memory, chunk by chunk.
  for (int c = 0; c < a.NC; ++c) {
    const int64_t t = t0 + c;
    const int skip = a.c_skip[t], len = a.c_len[t];
    for (int p = tid; p < a.C; p += blockDim.x) {
      int32_t key;
      float score;
      lane_key_score(a, t, skip, len, p, key, score);
      ks[c * a.C + p] = key;
      vs[c * a.C + p] = score;
    }
  }
  __syncthreads();

  // Merge the NC ascending runs of C lanes (C a power of two): bitonic merge
  // levels on a virtual power-of-two lane space whose tail [L, Lp) holds
  // phantom +inf keys.  A pair whose high lane is a phantom never swaps, so
  // skipping such pairs is exactly the virtual network on the real lanes.
  int Lp = a.C;
  while (Lp < L) Lp <<= 1;
  const int half = Lp >> 1;
  for (int m = a.C; m < Lp; m <<= 1) {
    for (int t = tid; t < half; t += blockDim.x) {  // flip stage
      const int base = (t & ~(m - 1)) << 1, o = t & (m - 1);
      const int j = base + 2 * m - 1 - o;
      if (j < L) compare_exchange(ks, vs, base + o, j);
    }
    __syncthreads();
    for (int d = m >> 1; d >= 1; d >>= 1) {  // half-cleaners
      for (int t = tid; t < half; t += blockDim.x) {
        const int i = ((t & ~(d - 1)) << 1) | (t & (d - 1));
        if (i + d < L) compare_exchange(ks, vs, i, i + d);
      }
      __syncthreads();
    }
  }

  // Per doc run of the sorted row: max over each (doc, qterm) key run, summed
  // over the doc's runs in ascending qterm order.  The thread that owns a
  // doc's tail lane owns the whole run (at most NC lanes: a doc appears at
  // most once per chunk) and leaves the doc total on the tail lane, -inf on
  // the others; pad lanes become -inf.  Runs are disjoint, so this is done in
  // place without races.
  const int qb = a.qterm_bits;
  for (int i = tid; i < L; i += blockDim.x) {
    const int32_t key = ks[i];
    if (key < 0 || key == kInvalidKey) {
      vs[i] = -INFINITY;
      continue;
    }
    const int32_t doc = key >> qb;
    if (i + 1 < L && (ks[i + 1] >> qb) == doc) continue;  // not the tail
    int h = i;
    while (h > 0 && (ks[h - 1] >> qb) == doc) --h;
    float total = 0.0f;
    int32_t run_key = ks[h];
    float run_max = vs[h];
    for (int j = h + 1; j <= i; ++j) {
      const int32_t kj = ks[j];
      const float vj = vs[j];
      if (kj == run_key) {
        run_max = fmaxf(run_max, vj);
      } else {
        total += run_max;
        run_key = kj;
        run_max = vj;
      }
      vs[j - 1] = -INFINITY;
    }
    total += run_max;
    vs[i] = (!a.excl || total > 0.0f) ? total : -INFINITY;
  }
  __syncthreads();

  // Top-k: k rounds of a block arg-max (ties to the lowest lane, which is the
  // lowest doc since lanes are key-sorted and each doc has one tail lane).
  const int lane = tid & 31, warp = tid >> 5, nwarps = blockDim.x >> 5;
  for (int r = 0; r < a.k; ++r) {
    float bv = -INFINITY;
    int bi = 0x7fffffff;
    for (int i = tid; i < L; i += blockDim.x) better(bv, bi, vs[i], i);
    warp_argmax(bv, bi);
    if (lane == 0) {
      red_v[warp] = bv;
      red_i[warp] = bi;
    }
    __syncthreads();
    if (warp == 0) {
      bv = lane < nwarps ? red_v[lane] : -INFINITY;
      bi = lane < nwarps ? red_i[lane] : 0x7fffffff;
      warp_argmax(bv, bi);
      if (lane == 0) {
        const int64_t o = (int64_t)row * a.k + r;
        if (bv > -INFINITY) {
          out_s[o] = bv;
          out_d[o] = ks[bi] >> qb;
          vs[bi] = -INFINITY;
          done = 0;
        } else {
          for (int q = r; q < a.k; ++q) {
            out_s[(int64_t)row * a.k + q] = -INFINITY;
            out_d[(int64_t)row * a.k + q] = -1;
          }
          done = 1;
        }
      }
    }
    __syncthreads();
    if (done) break;
  }
}

// Lanes phase: grid (NC, B), one chunk of one row per CTA.
__global__ void __launch_bounds__(kLanesThreads)
    fused_query_lanes_kernel(QueryArgs a, float* __restrict__ out_s,
                             int32_t* __restrict__ out_k) {
  const int c = blockIdx.x, row = blockIdx.y;
  const int64_t t = (int64_t)row * a.NC + c;
  const int skip = a.c_skip[t], len = a.c_len[t];
  const int64_t o = (int64_t)row * a.NC * a.C + (int64_t)c * a.C;
  for (int p = threadIdx.x; p < a.C; p += blockDim.x) {
    int32_t key;
    float score;
    lane_key_score(a, t, skip, len, p, key, score);
    out_k[o + p] = key;
    out_s[o + p] = score;
  }
}

QueryArgs make_args(const int32_t* rec, long long rec_stride,
                    const int32_t* c_start, const int32_t* c_skip,
                    const int32_t* c_len, const int32_t* c_qterm,
                    const float* c_scale, const float* scalars, int NC, int C,
                    int F, int k, int qterm_bits, float k1, float b, int excl) {
  QueryArgs a;
  a.rec = rec;
  a.rec_stride = rec_stride;
  a.c_start = c_start;
  a.c_skip = c_skip;
  a.c_len = c_len;
  a.c_qterm = c_qterm;
  a.c_scale = c_scale;
  a.scalars = scalars;
  a.NC = NC;
  a.C = C;
  a.F = F;
  a.k = k;
  a.qterm_bits = qterm_bits;
  a.excl = excl;
  a.k1 = k1;
  a.b = b;
  return a;
}

}  // namespace

extern "C" {

// Each entry launches on ``stream`` of CUDA device ``device`` and returns
// cudaGetLastError() (0 = ok).  The device is set here because this library
// carries its own CUDA runtime, whose current device the caller's runtime
// does not set.
int fused_query_full(int device, const int32_t* rec, long long rec_stride,
                     const int32_t* c_start, const int32_t* c_skip,
                     const int32_t* c_len, const int32_t* c_qterm,
                     const float* c_scale, const float* scalars, int B, int NC,
                     int C, int F, int k, int qterm_bits, float k1, float b,
                     int excl, float* out_s, int32_t* out_d, void* stream) {
  if (B == 0) return 0;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const size_t smem = (size_t)NC * C * (sizeof(int32_t) + sizeof(float));
  e = cudaFuncSetAttribute(
      fused_query_full_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  QueryArgs a = make_args(rec, rec_stride, c_start, c_skip, c_len, c_qterm,
                          c_scale, scalars, NC, C, F, k, qterm_bits, k1, b, excl);
  fused_query_full_kernel<<<B, kFullThreads, smem, (cudaStream_t)stream>>>(
      a, out_s, out_d);
  return (int)cudaGetLastError();
}

int fused_query_lanes(int device, const int32_t* rec, long long rec_stride,
                      const int32_t* c_start, const int32_t* c_skip,
                      const int32_t* c_len, const int32_t* c_qterm,
                      const float* c_scale, const float* scalars, int B, int NC,
                      int C, int F, int qterm_bits, float k1, float b, int excl,
                      float* out_s, int32_t* out_k, void* stream) {
  if (B == 0 || NC == 0) return 0;
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  QueryArgs a = make_args(rec, rec_stride, c_start, c_skip, c_len, c_qterm,
                          c_scale, scalars, NC, C, F, 0, qterm_bits, k1, b, excl);
  fused_query_lanes_kernel<<<dim3(NC, B), kLanesThreads, 0,
                             (cudaStream_t)stream>>>(a, out_s, out_k);
  return (int)cudaGetLastError();
}

const char* fused_query_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Largest dynamic shared memory one block of the full phase may use.
int fused_query_max_smem(int device) {
  int v = 0;
  if (cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess)
    return -1;
  return v;
}

}  // extern "C"
