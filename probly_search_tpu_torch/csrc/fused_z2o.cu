// Fused zero-to-one query kernel for Hopper (sm_90a): gather, two-key merge,
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
//   4. merge the NC ascending C-runs under the lexicographic order (k1, k2);
//   5. per field, keep the first valid contribution of each (doc, alive,
//      qterm) group, i.e. the oracle's best entry per (doc, field, qterm):
//      rank orders a group by entry score descending, lane by enumeration;
//   6. sum those per doc in qterm order, take the max over fields, then
//      max(., 0), and keep only docs whose key says alive;
//   7. top-k, ties to the lowest doc (= lowest lane of the sorted row).
//
// What bounds it on this card: the gather reads (2 + 2F) int32 rows per
// payload lane, scattered over the index by the chunk starts; everything
// after it stays in shared memory.  The design: one CTA per query row (only
// the first b_out rows of a class are launched); the row's merge keys
// ((k1, k2) packed into one int64) and its F contribution arrays live in
// dynamic shared memory, (8 + 4F) * L bytes, at most 196,608 B at L = 8192,
// F = 4; loads are coalesced along the C lanes of a chunk and dead chunks and
// pad lanes read nothing.  The merge is bitonic merge levels over the C-runs
// with a phantom (INT32_MAX, INT32_MAX) tail for L that is not a power of
// two; swaps carry the key and F contributions.  The group and doc
// reductions need no scan ladder: the thread that owns a doc's tail lane
// walks back over the doc's run (at most NC lanes: a doc appears at most once
// per chunk).  Built without --use_fast_math, so divisions stay IEEE-rounded
// and contributions equal the JAX engine's bit for bit; only the per-doc
// sums are taken in another order.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int32_t kMaxKey = 0x7fffffff;
constexpr int kThreads = 512;
constexpr int kQtBits = 4;
constexpr int kMaxFields = 4;

struct Z2oArgs {
  const int32_t* rec;      // [R, rec_stride] transposed posting records
  int64_t rec_stride;      // P + C
  const int32_t* c_start;  // [B, NC] chunk start column in rec
  const int32_t* c_skip;   // [B, NC] payload begins at this lane of the chunk
  const int32_t* c_len;    // [B, NC] payload length (0: dead chunk)
  const int32_t* c_qterm;  // [B, NC] dense query-term index
  const float* c_score;    // [B, NC] entry score s of the chunk's job
  const int32_t* c_rank;   // [B, NC] per-query dense rank of s (descending)
  const float* qlen;       // [B] query_terms_len, empty tokens included
  int NC, C, F, k;
};

__device__ __forceinline__ bool key_valid(int32_t k1) {
  return k1 >= 0 && k1 != kMaxKey;
}

__device__ __forceinline__ void compare_exchange(int64_t* ks, float* cs, int L,
                                                 int F, int i, int j) {
  const int64_t ki = ks[i], kj = ks[j];
  if (ki > kj) {
    ks[i] = kj;
    ks[j] = ki;
    for (int f = 0; f < F; ++f) {
      float* c = cs + (int64_t)f * L;
      const float v = c[i];
      c[i] = c[j];
      c[j] = v;
    }
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

// Dynamic shared memory: ks int64[L] (k1 << 32 | k2), cs f32[F][L].
__global__ void __launch_bounds__(kThreads)
    fused_z2o_kernel(Z2oArgs a, float* __restrict__ out_s,
                     int32_t* __restrict__ out_d) {
  extern __shared__ int64_t smem64[];
  __shared__ float red_v[kThreads / 32];
  __shared__ int red_i[kThreads / 32];
  __shared__ int done;

  const int row = blockIdx.x;
  const int tid = threadIdx.x;
  const int F = a.F, C = a.C;
  const int L = a.NC * C;
  const int64_t t0 = (int64_t)row * a.NC;
  int64_t* ks = smem64;
  float* cs = reinterpret_cast<float*>(smem64 + L);

  // Dead-row skip: a row with no live chunk emits the empty sentinel.
  int my_live = 0;
  for (int c = tid; c < a.NC; c += blockDim.x) my_live |= a.c_len[t0 + c] > 0;
  if (!__syncthreads_or(my_live)) {
    for (int i = tid; i < a.k; i += blockDim.x) {
      out_s[(int64_t)row * a.k + i] = -INFINITY;
      out_d[(int64_t)row * a.k + i] = -1;
    }
    return;
  }

  // Gather: lane keys and per-field contributions.  Consecutive threads take
  // consecutive lanes of a chunk (coalesced reads of each rec row); pad lanes
  // and dead chunks read nothing from rec.
  const float ql = a.qlen[row];
  const int64_t s = a.rec_stride;
  const int cshift = __ffs(C) - 1;  // C is a power of two
  for (int lane = tid; lane < L; lane += blockDim.x) {
    const int64_t t = t0 + (lane >> cshift);
    const int p = lane & (C - 1);
    const int skip = a.c_skip[t], len = a.c_len[t];
    int32_t k1;
    if (p < skip || p >= skip + len) {
      k1 = p < skip ? -1 : kMaxKey;
      for (int f = 0; f < F; ++f) cs[(int64_t)f * L + lane] = -1.0f;
    } else {
      const int32_t* r = a.rec + (int64_t)a.c_start[t] + p;
      const int32_t doc = r[0];
      const int32_t alive = r[(int64_t)(1 + 2 * F) * s];
      const float sc = a.c_score[t];
      k1 = (doc << (kQtBits + 1)) | (alive << kQtBits) | a.c_qterm[t];
      for (int f = 0; f < F; ++f) {
        const float tf = (float)r[(int64_t)(1 + f) * s];
        const float flen = __int_as_float(r[(int64_t)(1 + F + f) * s]);
        float v = -1.0f;
        if (alive > 0 && tf > 0.0f) v = fminf(sc / tf, 1.0f) * tf / fmaxf(flen, ql);
        cs[(int64_t)f * L + lane] = v;
      }
    }
    // Signed k1 in the high word, k2 = rank << 14 | lane >= 0 in the low
    // word: int64 order is the lexicographic (k1, k2) order.
    const uint32_t k2 = (uint32_t)((a.c_rank[t] << 14) | lane);
    ks[lane] = (int64_t)(((uint64_t)(uint32_t)k1 << 32) | k2);
  }
  __syncthreads();

  // Merge the NC ascending runs of C lanes (C a power of two): bitonic merge
  // levels on a virtual power-of-two lane space whose tail [L, Lp) holds
  // phantom maximal keys; a pair whose high lane is a phantom never swaps.
  int Lp = C;
  while (Lp < L) Lp <<= 1;
  const int half = Lp >> 1;
  for (int m = C; m < Lp; m <<= 1) {
    for (int t = tid; t < half; t += blockDim.x) {  // flip stage
      const int base = (t & ~(m - 1)) << 1, o = t & (m - 1);
      const int j = base + 2 * m - 1 - o;
      if (j < L) compare_exchange(ks, cs, L, F, base + o, j);
    }
    __syncthreads();
    for (int d = m >> 1; d >= 1; d >>= 1) {  // half-cleaners
      for (int t = tid; t < half; t += blockDim.x) {
        const int i = ((t & ~(d - 1)) << 1) | (t & (d - 1));
        if (i + d < L) compare_exchange(ks, cs, L, F, i, i + d);
      }
      __syncthreads();
    }
  }

  // Per doc run of the sorted row.  The owner of a doc's tail lane reads the
  // run (every field), then leaves the doc score on the tail lane of cs[0]
  // and -inf on the run's other lanes; pad lanes become -inf.  Runs are
  // disjoint and each is read before it is written, so this is done in place.
  for (int i = tid; i < L; i += blockDim.x) {
    const int32_t k1 = (int32_t)(ks[i] >> 32);
    if (!key_valid(k1)) {
      cs[i] = -INFINITY;
      continue;
    }
    const int32_t doc = k1 >> (kQtBits + 1);
    if (i + 1 < L) {
      const int32_t kn = (int32_t)(ks[i + 1] >> 32);
      if (key_valid(kn) && (kn >> (kQtBits + 1)) == doc) continue;  // not the tail
    }
    int h = i;
    while (h > 0) {
      const int32_t kp = (int32_t)(ks[h - 1] >> 32);
      if (!key_valid(kp) || (kp >> (kQtBits + 1)) != doc) break;
      --h;
    }
    // Per field: the first valid contribution of each (doc, alive, qterm)
    // group, summed over the doc's groups in ascending qterm order.
    float best = -INFINITY;
    for (int f = 0; f < F; ++f) {
      const float* c = cs + (int64_t)f * L;
      float total = 0.0f;
      int32_t grp = -1;
      bool taken = false;
      for (int j = h; j <= i; ++j) {
        const int32_t kj = (int32_t)(ks[j] >> 32);
        if (kj != grp) {
          grp = kj;
          taken = false;
        }
        if (!taken && c[j] >= 0.0f) {
          total += c[j];
          taken = true;
        }
      }
      best = fmaxf(best, total);
    }
    const bool alive = (k1 >> kQtBits) & 1;
    for (int j = h; j < i; ++j) cs[j] = -INFINITY;
    cs[i] = alive ? fmaxf(best, 0.0f) : -INFINITY;
  }
  __syncthreads();

  // Top-k: k rounds of a block arg-max (ties to the lowest lane, which is the
  // lowest doc since lanes are key-sorted and each doc has one tail lane).
  const int lane = tid & 31, warp = tid >> 5, nwarps = blockDim.x >> 5;
  for (int r = 0; r < a.k; ++r) {
    float bv = -INFINITY;
    int bi = 0x7fffffff;
    for (int i = tid; i < L; i += blockDim.x) better(bv, bi, cs[i], i);
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
          out_d[o] = (int32_t)(ks[bi] >> 32) >> (kQtBits + 1);
          cs[bi] = -INFINITY;
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

}  // namespace

extern "C" {

// Dynamic shared memory one row of the kernel needs.
long long fused_z2o_smem_bytes(int NC, int C, int F) {
  return (long long)NC * C * (sizeof(int64_t) + (long long)F * sizeof(float));
}

// Launches on ``stream`` of CUDA device ``device``, one CTA per row of B, and
// returns cudaGetLastError() (0 = ok).  The device is set here because this
// library carries its own CUDA runtime, whose current device the caller's
// runtime does not set.  Returns cudaErrorInvalidValue for shapes the kernel
// does not take (the wrapper checks them first).
int fused_z2o(int device, const int32_t* rec, long long rec_stride,
              const int32_t* c_start, const int32_t* c_skip,
              const int32_t* c_len, const int32_t* c_qterm,
              const float* c_score, const int32_t* c_rank, const float* qlen,
              int B, int NC, int C, int F, int k, float* out_s, int32_t* out_d,
              void* stream) {
  if (B == 0) return 0;
  if (F < 1 || F > kMaxFields || k < 1 || NC < 1 || C < 1 || (C & (C - 1)))
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const size_t smem = (size_t)fused_z2o_smem_bytes(NC, C, F);
  e = cudaFuncSetAttribute(fused_z2o_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e != cudaSuccess) return (int)e;
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
  fused_z2o_kernel<<<B, kThreads, smem, (cudaStream_t)stream>>>(a, out_s, out_d);
  return (int)cudaGetLastError();
}

}  // extern "C"
