// Fused BM25 query kernel for Hopper (sm_90a): gather, score, merge, top-k.
//
// Replaces the Pallas TPU kernel of probly_search_tpu/ops/pallas_query.py
// (_query_kernel / _query_kernel_body, launched by fused_query_topk) and its
// merge stage, probly_search_tpu/ops/pallas_merge.py (merge_body with
// _oddeven_merge_runs_inplace and _segmented_scan_inplace).  Two entry
// points share the scoring of a lane:
//
//   fused_query_full   phase "full":  one CTA per query row; the row's
//                      NC * C scored lanes live in dynamic shared memory,
//                      are merged, reduced per doc and top-k selected there
//                      (block_merge.cuh); only [B, k] results go back to
//                      device memory.
//   fused_query_lanes  phase "lanes": one CTA per (row, chunk); writes the
//                      [B, NC * C] key and score lanes to device memory for
//                      classes too wide for one CTA's shared memory (the
//                      merge kernel K5 then merges them), with 16-B loads
//                      and stores.
//
// What bounds it on this card: the gather.  Each payload lane reads R int32
// rows of the transposed posting record array rec[R, P + C] (16 B per lane at
// R = 4, one field), scattered over the index by the chunk starts.  Every
// chunk starts at a multiple of 128 lanes and rec's rows are padded to a
// multiple of 128 int32 (index/device.py), so a chunk's payload is one
// 16-B-aligned run per record row: the full phase stages it into shared
// memory with cp.async, up to three chunks ahead of the chunk being scored,
// reads nothing for pad lanes and dead chunks, and skips rows that have no
// live chunk.  The sort, doc totals and top-k then touch shared memory only
// (an LSD radix sort of the live lanes, a one-pass radix select),
// and the block's shared memory is sized to the class's L, so narrow classes
// run several CTAs per SM.
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

#include "block_merge.cuh"
#include "device_scope.cuh"

namespace {

using blockmerge::kInvalidKey;
constexpr int kLanesThreads = 256;

struct QueryArgs {
  const int32_t* rec;     // [R, rec_stride] transposed posting records
  int64_t rec_stride;     // >= P + C; a multiple of 4 (16-B rows)
  const int32_t* c_start; // [B, NC] chunk start column in rec
  const int32_t* c_skip;  // [B, NC] payload begins at this lane of the chunk
  const int32_t* c_len;   // [B, NC] payload length (0: dead chunk)
  const int32_t* c_qterm; // [B, NC] dense query-term index
  const float* c_scale;   // [B, NC] idf * expansion boost (host before_each)
  const float* scalars;   // [2F] field_avg, fields_boost
  int NC, C, F, k, qterm_bits, excl;
  int ring;               // chunks of record rows staged at once (1 to 4)
  int key_bits;           // every live key lies below 2^key_bits
  uint64_t* cand;         // [B, cand_words(k)] top-k words in device memory, or null:
                          // in shared memory
  float k1, b;
};

// One field's term of a lane's BM25 base score, added to `base` (the first
// field's term starts it).
__device__ __forceinline__ float bm25_field(const QueryArgs& a, const float* scalars, int f,
                                            float tf, float flen, float base) {
  const float avg = scalars[f];
  const float boost = scalars[a.F + f];
  const float denom = a.k1 * ((1.0f - a.b) + a.b * (flen / avg)) + tf;
  const float tf_norm = tf > 0.0f ? ((a.k1 + 1.0f) * tf) / denom : 0.0f;
  return f == 0 ? tf_norm * boost : base + tf_norm * boost;
}

// A payload lane's score from its base: the job's scale, `excl`, and -inf
// on a latently dead doc.
__device__ __forceinline__ float bm25_finish(const QueryArgs& a, float base, float scale,
                                             int32_t alive) {
  float sc = base * scale;
  if (a.excl) sc = sc > 0.0f ? sc : 0.0f;
  if (alive <= 0) sc = -INFINITY;
  return sc;
}

// Key and score of lane p of a chunk whose payload is [skip, skip + len),
// scale and query term `scale`, `qterm`; `r` points at record row 0 of the
// lane, `s` is the record row stride, `scalars` = (field_avg, fields_boost).
__device__ __forceinline__ void lane_key_score(const QueryArgs& a, float scale, int qterm,
                                               const float* scalars, int skip, int len, int p,
                                               const int32_t* r, int64_t s, int32_t& key,
                                               float& score) {
  if (p < skip || p >= skip + len) {
    key = p < skip ? -1 : kInvalidKey;
    score = 0.0f;
    return;
  }
  const int32_t doc = r[0];
  const int32_t alive = r[(int64_t)(1 + 2 * a.F) * s];
  float base = 0.0f;
  for (int f = 0; f < a.F; ++f) {
    const float tf = (float)r[(int64_t)(1 + f) * s];
    const float flen = __int_as_float(r[(int64_t)(1 + a.F + f) * s]);
    base = bm25_field(a, scalars, f, tf, flen, base);
  }
  key = (doc << a.qterm_bits) | qterm;
  score = bm25_finish(a, base, scale, alive);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// V consecutive int32 of device memory into registers (V = 4: one 16-B
// load, `p` 16-B aligned), and V values out the same way.
template <int V>
__device__ __forceinline__ void load_lanes(const int32_t* p, int32_t* v) {
  if constexpr (V == 4) {
    const int4 x = __ldg(reinterpret_cast<const int4*>(p));
    v[0] = x.x;
    v[1] = x.y;
    v[2] = x.z;
    v[3] = x.w;
  } else {
#pragma unroll
    for (int q = 0; q < V; ++q) v[q] = __ldg(p + q);
  }
}

template <int V>
__device__ __forceinline__ void store_lanes(int32_t* p, const int32_t* v) {
  if constexpr (V == 4) {
    *reinterpret_cast<int4*>(p) = make_int4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int q = 0; q < V; ++q) p[q] = v[q];
  }
}

template <int V>
__device__ __forceinline__ void store_lanes(float* p, const float* v) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int q = 0; q < V; ++q) p[q] = v[q];
  }
}

// Full phase, one CTA of NT threads per query row.  Dynamic shared memory
// (full_smem_bytes in ops/fused_query.py): ks int32[L], vs f32[L], L = NC *
// C; a ring of a.ring chunks of the 2 + 2F record rows, int32[ring][R'][C];
// the top-k words uint64[cand_words(k)] (none when a.cand holds them in
// device memory, for k past fused_query.MAX_K); the row's chunk tables
// (start, skip, len, qterm int32[NC], scale f32[NC]) and the 2F scalars,
// loaded once so that no step of the chunk loop waits on device memory for
// them.  CLOCK (tools/torch_stage_probe.py only) writes each block's cycles
// per stage (gather, sort, totals, select, write) to clk[row][5].
template <int NT, int MAXS, bool CLOCK>
__device__ __forceinline__ void full_phase(const QueryArgs& a, float* __restrict__ out_s,
                                           int32_t* __restrict__ out_d, long long* clk) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ blockmerge::SelectSmem sel;
  __shared__ blockmerge::RadixSmem<NT> rs;
  long long stamp[6];
  if (CLOCK) stamp[0] = clock64();

  const int row = blockIdx.x;
  const int tid = threadIdx.x;
  const int C = a.C, NC = a.NC, L = NC * C, RR = 2 + 2 * a.F;
  const int64_t t0 = (int64_t)row * NC;
  const int kw = blockmerge::cand_words(a.k);
  int32_t* ks = reinterpret_cast<int32_t*>(smem);
  float* vs = reinterpret_cast<float*>(ks + L);
  int32_t* ring = reinterpret_cast<int32_t*>(vs + L);
  uint64_t* cand = reinterpret_cast<uint64_t*>(ring + a.ring * RR * C);
  int32_t* c_start = reinterpret_cast<int32_t*>(a.cand ? cand : cand + kw);
  if (a.cand) cand = a.cand + (int64_t)row * kw;
  int32_t* c_skip = c_start + NC;
  int32_t* c_len = c_skip + NC;
  int32_t* c_qterm = c_len + NC;
  float* c_scale = reinterpret_cast<float*>(c_qterm + NC);
  float* scalars = c_scale + NC;

  // The row's tables; a row with no live chunk (class padding) emits the
  // empty sentinel and does no gather or merge.
  int my_live = 0;
  for (int c = tid; c < NC; c += NT) {
    const int64_t t = t0 + c;
    c_start[c] = a.c_start[t];
    c_skip[c] = a.c_skip[t];
    c_len[c] = a.c_len[t];
    c_qterm[c] = a.c_qterm[t];
    c_scale[c] = a.c_scale[t];
    my_live |= c_len[c] > 0;
  }
  for (int f = tid; f < 2 * a.F; f += NT) scalars[f] = a.scalars[f];
  if (!__syncthreads_or(my_live)) {
    for (int i = tid; i < a.k; i += NT) {
      out_s[(int64_t)row * a.k + i] = -INFINITY;
      out_d[(int64_t)row * a.k + i] = -1;
    }
    return;
  }

  // Gather: the 16-B segments of a chunk's payload, every record row, copied
  // asynchronously into ring slot c % ring (nothing for a dead chunk); one
  // commit group per chunk, ring - 1 chunks ahead of the one being scored.
  auto issue = [&](int c) {
    if (c < NC && c_len[c] > 0) {
      const int skip = c_skip[c];
      const int s0 = skip >> 2, ns = ((skip + c_len[c] + 3) >> 2) - s0;
      const int32_t* src = a.rec + c_start[c];
      int32_t* dst = ring + (c % a.ring) * RR * C;
      for (int q = tid; q < RR * ns; q += NT) {
        const int r = q / ns, sg = 4 * (s0 + q % ns);
        cp_async16(dst + r * C + sg, src + r * a.rec_stride + sg);
      }
    }
    cp_async_commit();
  };
  auto score_chunk = [&](int c) {
    const int skip = c_skip[c], len = c_len[c], qterm = c_qterm[c];
    const float scale = c_scale[c];
    const int32_t* g = ring + (c % a.ring) * RR * C;
    for (int p = tid; p < C; p += NT) {
      int32_t key;
      float score;
      lane_key_score(a, scale, qterm, scalars, skip, len, p, g + p, C, key, score);
      ks[c * C + p] = key;
      vs[c * C + p] = score;
    }
  };
  if (a.ring >= NC) {  // every chunk in flight at once: one wait, one barrier
    for (int c = 0; c < NC; ++c) issue(c);
    cp_async_wait<0>();
    __syncthreads();
    for (int c = 0; c < NC; ++c) score_chunk(c);
    __syncthreads();
  } else {
    for (int c = 0; c < a.ring - 1; ++c) issue(c);
    for (int c = 0; c < NC; ++c) {
      issue(c + a.ring - 1);
      if (a.ring >= 4)
        cp_async_wait<3>();
      else if (a.ring == 3)
        cp_async_wait<2>();
      else if (a.ring == 2)
        cp_async_wait<1>();
      else
        cp_async_wait<0>();
      __syncthreads();
      score_chunk(c);
      __syncthreads();
    }
  }
  if (CLOCK) stamp[1] = clock64();

  // Sort the live lanes, total each doc on its tail lane, select the top k
  // (block_merge.cuh).
  const int n = blockmerge::block_radix_sort<NT, MAXS>(ks, vs, L, a.key_bits, rs);
  if (CLOCK) stamp[2] = clock64();
  const uint64_t top = blockmerge::block_doc_totals<NT>(ks, vs, n, a.qterm_bits, a.excl);
  if (CLOCK) stamp[3] = clock64();
  const int m = blockmerge::block_select<NT>(ks, vs, n, a.qterm_bits, a.k, top, cand, sel,
                                             rs.words(), rs.kWords);
  if (CLOCK) stamp[4] = clock64();
  blockmerge::write_topk<NT>(cand, m, a.k, out_s + (int64_t)row * a.k,
                             out_d + (int64_t)row * a.k);
  if (CLOCK) {
    __syncthreads();
    stamp[5] = clock64();
    if (tid == 0)
      for (int q = 0; q < 5; ++q) clk[(int64_t)row * 5 + q] = stamp[q + 1] - stamp[q];
  }
}

template <int NT, int MAXS, int MINB>
__global__ void __launch_bounds__(NT, MINB)
    fused_query_full_kernel(QueryArgs a, float* __restrict__ out_s,
                            int32_t* __restrict__ out_d) {
  full_phase<NT, MAXS, false>(a, out_s, out_d, nullptr);
}

// Lanes phase: grid (NC, B), one chunk of one row per CTA.  A thread takes V
// consecutive lanes (V = 4 when C is a multiple of 4: one 16-B load per
// record row, one 16-B store per output; chunk starts are multiples of 128
// and rec's rows 16-B aligned), all record rows of its lanes in flight before
// the first is used.  Pad lanes and dead chunks read nothing from rec and
// write their sentinels.
template <int V>
__global__ void __launch_bounds__(kLanesThreads)
    fused_query_lanes_kernel(QueryArgs a, float* __restrict__ out_s,
                             int32_t* __restrict__ out_k) {
  const int c = blockIdx.x, row = blockIdx.y;
  const int64_t t = (int64_t)row * a.NC + c;
  const int skip = a.c_skip[t], len = a.c_len[t];
  const int64_t s = a.rec_stride, o = t * a.C;
  for (int p = threadIdx.x * V; p < a.C; p += kLanesThreads * V) {
    int32_t key[V];
    float score[V];
    if (p + V <= skip || p >= skip + len) {  // pads only: read nothing
#pragma unroll
      for (int q = 0; q < V; ++q) {
        key[q] = p + q < skip ? -1 : kInvalidKey;
        score[q] = 0.0f;
      }
    } else {
      const int32_t* r = a.rec + a.c_start[t] + p;
      int32_t doc[V], alive[V];
      load_lanes<V>(r, doc);
      load_lanes<V>(r + (1 + 2 * a.F) * s, alive);
      float base[V] = {};
#pragma unroll 2
      for (int f = 0; f < a.F; ++f) {
        int32_t tf[V], fl[V];
        load_lanes<V>(r + (1 + f) * s, tf);
        load_lanes<V>(r + (1 + a.F + f) * s, fl);
#pragma unroll
        for (int q = 0; q < V; ++q)
          base[q] = bm25_field(a, a.scalars, f, (float)tf[q], __int_as_float(fl[q]), base[q]);
      }
      const int qterm = a.c_qterm[t];
      const float scale = a.c_scale[t];
#pragma unroll
      for (int q = 0; q < V; ++q) {
        const int lane = p + q;
        if (lane < skip || lane >= skip + len) {
          key[q] = lane < skip ? -1 : kInvalidKey;
          score[q] = 0.0f;
        } else {
          key[q] = (doc[q] << a.qterm_bits) | qterm;
          score[q] = bm25_finish(a, base[q], scale, alive[q]);
        }
      }
    }
    store_lanes<V>(out_k + o + p, key);
    store_lanes<V>(out_s + o + p, score);
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
  a.ring = 1;
  a.key_bits = 31;
  a.cand = nullptr;
  return a;
}

// The full-phase variants by L: threads per block, lanes a thread holds in a
// radix pass (ceil(L / threads)), and the blocks per SM the registers are
// held to.  512 threads up to 8,192 lanes, so two or three blocks share an
// SM and hide each other's barrier latency; 1,024 threads (one block an SM)
// for the widest classes.
#define FULL_VARIANTS(X) X(512, 4, 3) X(512, 8, 2) X(512, 16, 2) X(1024, 16, 1)

template <int NT, int MAXS, int MINB>
cudaError_t launch_full(const QueryArgs& a, int B, size_t smem, float* out_s, int32_t* out_d,
                        cudaStream_t st) {
  fused_query_full_kernel<NT, MAXS, MINB><<<B, NT, smem, st>>>(a, out_s, out_d);
  return cudaGetLastError();
}

// Index of the variant for L lanes.
int full_variant(int L) { return L <= 2048 ? 0 : L <= 4096 ? 1 : L <= 8192 ? 2 : 3; }

}  // namespace

extern "C" {

// Once per device: lift the full phase's shared-memory cap to the card's
// opt-in maximum; returns the dynamic bytes a block may use (< 0: error).
int fused_query_init(int device) {
  const probly::DeviceScope scope(device);
  if (scope.error() != cudaSuccess) return -1;
  int v = 0;
  if (cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin, device) != cudaSuccess)
    return -1;
  const int avail =
      v - (int)(sizeof(blockmerge::SelectSmem) + sizeof(blockmerge::RadixSmem<1024>) + 64);
#define ALLOW(NT, M, B)                                                                  \
  if (cudaFuncSetAttribute(fused_query_full_kernel<NT, M, B>,                            \
                           cudaFuncAttributeMaxDynamicSharedMemorySize, avail) != cudaSuccess) \
    return -1;
  FULL_VARIANTS(ALLOW)
#undef ALLOW
  return avail;
}

// Each entry launches on ``stream`` of CUDA device ``device`` and returns
// cudaGetLastError() (0 = ok).  The device is selected for the call only
// (device_scope.cuh): the caller's current device is left as it was.
// ``ring`` and ``smem`` are the full phase's staging depth and dynamic shared
// memory (full_launch), within what fused_query_init allowed; ``cand`` is
// null, or [B, cand_words(k)] words of device memory for a k whose words do
// not fit shared memory.
int fused_query_full(int device, const int32_t* rec, long long rec_stride,
                     const int32_t* c_start, const int32_t* c_skip,
                     const int32_t* c_len, const int32_t* c_qterm,
                     const float* c_scale, const float* scalars, int B_rows, int NC,
                     int C, int F, int k, int qterm_bits, float k1, float b,
                     int excl, int key_bits, int ring, long long smem, void* cand,
                     float* out_s, int32_t* out_d, void* stream) {
  if (B_rows == 0) return 0;
  const probly::DeviceScope scope(device);
  cudaError_t e = scope.error();
  if (e != cudaSuccess) return (int)e;
  QueryArgs a = make_args(rec, rec_stride, c_start, c_skip, c_len, c_qterm,
                          c_scale, scalars, NC, C, F, k, qterm_bits, k1, b, excl);
  a.ring = ring;
  a.key_bits = key_bits;
  a.cand = (uint64_t*)cand;
  cudaStream_t st = (cudaStream_t)stream;
  int v = 0;
  const int want = full_variant(NC * C);
#define LAUNCH(NT, M, B) \
  if (v++ == want) e = launch_full<NT, M, B>(a, B_rows, (size_t)smem, out_s, out_d, st);
  FULL_VARIANTS(LAUNCH)
#undef LAUNCH
  return (int)e;
}

int fused_query_lanes(int device, const int32_t* rec, long long rec_stride,
                      const int32_t* c_start, const int32_t* c_skip,
                      const int32_t* c_len, const int32_t* c_qterm,
                      const float* c_scale, const float* scalars, int B, int NC,
                      int C, int F, int qterm_bits, float k1, float b, int excl,
                      float* out_s, int32_t* out_k, void* stream) {
  if (B == 0 || NC == 0) return 0;
  if (C < 1 || (C & (C - 1))) return (int)cudaErrorInvalidValue;
  const probly::DeviceScope scope(device);
  if (scope.error() != cudaSuccess) return (int)scope.error();
  QueryArgs a = make_args(rec, rec_stride, c_start, c_skip, c_len, c_qterm,
                          c_scale, scalars, NC, C, F, 0, qterm_bits, k1, b, excl);
  const dim3 grid(NC, B);
  if ((C & 3) == 0)
    fused_query_lanes_kernel<4><<<grid, kLanesThreads, 0, (cudaStream_t)stream>>>(a, out_s, out_k);
  else
    fused_query_lanes_kernel<1><<<grid, kLanesThreads, 0, (cudaStream_t)stream>>>(a, out_s, out_k);
  return (int)cudaGetLastError();
}

const char* fused_query_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Resident full-phase blocks per SM at L lanes and `smem` bytes (-1: error).
int fused_query_occupancy(int device, int L, long long smem) {
  const probly::DeviceScope scope(device);
  if (scope.error() != cudaSuccess) return -1;
  int n = -1, v = 0;
  const int want = full_variant(L);
#define OCC(NT, M, B)                                                                       \
  if (v++ == want &&                                                                        \
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, fused_query_full_kernel<NT, M, B>, NT, \
                                                    (size_t)smem) != cudaSuccess)          \
    n = -1;
  FULL_VARIANTS(OCC)
#undef OCC
  return n;
}

// Largest dynamic shared memory one block may opt into (-1: error).
int fused_query_max_smem(int device) {
  int v = 0;
  if (cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess)
    return -1;
  return v;
}

}  // extern "C"
