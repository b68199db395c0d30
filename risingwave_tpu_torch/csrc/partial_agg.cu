// Kernel K22c: the stateless partial aggregation of a chunk (sm_90a).
//
// Replaces risingwave_tpu/stream/partial_agg.py `PartialAggExecutor.apply`
// (:103), phase 1 of the two-phase aggregation: the reference sorts the
// chunk by its 64-bit key hash, splits segments on full key equality and on
// a change of validity, reduces each aggregate per segment
// (`jax.ops.segment_sum` / `segment_min` / `segment_max`) and broadcasts
// the result back to the segment's rows; only a segment's first row stays
// valid.  The hash (kernel A) and the stable sort (`torch.sort` of the hash
// with its sign bit flipped: unsigned order, invalid rows keyed ~0 last)
// run before this kernel, which takes the sort's permutation.  Two
// launches:
//   1. pagg_mark_kernel  one thread per sorted position i (row perm[i]):
//                        gathers the row's key leaves into the sorted
//                        output, sets is_new[i] when its key differs from
//                        row perm[i-1]'s in any leaf (NULL == NULL, every
//                        byte of a string and its length, IEEE == with
//                        subnormals as zero on floats) or its validity
//                        does, and valid_out[i] = is_new[i] && valid;
//   2. pagg_walk_kernel  one warp per segment leader reduces its segment,
//                        per aggregate: the signed count (a NULL argument
//                        contributes 0), the sum of value * sign (int64 for
//                        integers, the float type for floats), min or max
//                        with NULLs as the identity, and the non-NULL
//                        count; then writes the result to every row of the
//                        segment (NULL where no row was non-NULL, for a
//                        nullable partial).  The order-free ones (counts,
//                        integer sums and min/max) fold 32 rows a step and
//                        combine by shuffles; a float sum, and float
//                        min/max, are one lane's serial walk in sorted
//                        order, as the reference's scatter adds them.
//
// Bound: bytes.  Every row's key and argument leaves are read and its
// sorted key and partials written once; the reduction is a few operations
// a row.  A segment is one warp's, so the hot key of a skewed chunk (q7's
// one window: 8192 rows a lane) is 256 steps of one warp; the first
// version, one thread a segment, took 4 ms a call there (PERF.md).
#include <cfloat>
#include <cstdint>
#include <cuda_runtime.h>

#include "rw_common.cuh"

#define PAGG_MAX_AGGS 16
#define PAGG_COUNT 0
#define PAGG_SUM 1
#define PAGG_MIN 2
#define PAGG_MAX 3
#define PAGG_I64 0
#define PAGG_I32 1
#define PAGG_I16 2
#define PAGG_F32 3
#define PAGG_F64 4

struct RwPartialAggs {
  int n;
  int kind[PAGG_MAX_AGGS];
  int dtype[PAGG_MAX_AGGS];       // of the argument (unused for count)
  const void* arg[PAGG_MAX_AGGS];  // nullptr: count(*)
  const uint8_t* arg_null[PAGG_MAX_AGGS];
  void* out[PAGG_MAX_AGGS];
  uint8_t* out_null[PAGG_MAX_AGGS];  // nullptr: the partial is not nullable
};

// Grouping equality of input rows a and b over every key leaf.
__device__ __forceinline__ bool pagg_keys_equal(const RwCols& c, int64_t a,
                                                int64_t b) {
  for (int k = 0; k < c.n; ++k) {
    bool eq;
    if (c.kind[k] == RW_KIND_F32) {
      const float* p = static_cast<const float*>(c.in_data[k]);
      eq = rw_daz(p[a]) == rw_daz(p[b]);
    } else if (c.kind[k] == RW_KIND_F64) {
      const double* p = static_cast<const double*>(c.in_data[k]);
      eq = rw_daz(p[a]) == rw_daz(p[b]);
    } else {
      const int w = c.width[k];
      const uint8_t* pa = static_cast<const uint8_t*>(c.in_data[k]) + a * w;
      const uint8_t* pb = static_cast<const uint8_t*>(c.in_data[k]) + b * w;
      eq = true;
      for (int j = 0; j < w && eq; ++j) eq = pa[j] == pb[j];
    }
    if (c.in_null[k] != nullptr) {
      const bool an = c.in_null[k][a] != 0, bn = c.in_null[k][b] != 0;
      eq = (an && bn) || (!an && !bn && eq);
    }
    if (!eq) return false;
  }
  return true;
}

__global__ void pagg_mark_kernel(RwCols keys, int64_t cap,
                                 const int64_t* __restrict__ perm,
                                 const uint8_t* __restrict__ valid,
                                 uint8_t* __restrict__ is_new,
                                 uint8_t* __restrict__ valid_out) {
  const int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (i >= cap) return;
  const int64_t p = perm[i];
  rw_store_row(keys, i, p);
  bool fresh = i == 0;
  if (!fresh) {
    const int64_t q = perm[i - 1];
    fresh = valid[p] != valid[q] || !pagg_keys_equal(keys, p, q);
  }
  is_new[i] = fresh;
  valid_out[i] = fresh && valid[p] != 0;
}

template <typename T>
__device__ __forceinline__ T pagg_load(const void* base, int64_t i) {
  return static_cast<const T*>(base)[i];
}

__device__ __forceinline__ int64_t pagg_int(const RwPartialAggs& a, int k,
                                            int64_t p) {
  switch (a.dtype[k]) {
    case PAGG_I32: return pagg_load<int32_t>(a.arg[k], p);
    case PAGG_I16: return pagg_load<int16_t>(a.arg[k], p);
    default: return pagg_load<int64_t>(a.arg[k], p);
  }
}

__device__ __forceinline__ float pagg_inf(float) {
  return __int_as_float(0x7F800000);
}
__device__ __forceinline__ double pagg_inf(double) {
  return __longlong_as_double(0x7FF0000000000000LL);
}

// Walk rows [i, end) of one segment for aggregate k; returns end.
template <typename T>
__device__ int64_t pagg_walk_float(const RwPartialAggs& a, int k, int64_t i,
                                   int64_t cap, const int64_t* perm,
                                   const int32_t* signs, const uint8_t* is_new,
                                   T* out, int64_t* nn_out) {
  const bool sum = a.kind[k] == PAGG_SUM;
  const T inf = pagg_inf(static_cast<T>(0));
  const T ident = a.kind[k] == PAGG_MIN ? inf : -inf;
  T acc = sum ? static_cast<T>(0) : ident;
  int64_t nn = 0, j = i;
  for (; j < cap && (j == i || !is_new[j]); ++j) {
    const int64_t p = perm[j];
    const bool null = a.arg_null[k] != nullptr && a.arg_null[k][p] != 0;
    const int32_t eff = null ? 0 : signs[p];
    nn += eff < 0 ? -eff : eff;
    const T v = pagg_load<T>(a.arg[k], p);
    if (sum) {
      acc = acc + (null ? static_cast<T>(0) : v) * static_cast<T>(eff);
    } else {
      const T m = null ? ident : v;
      if (a.kind[k] == PAGG_MIN ? m < acc : m > acc) acc = m;
    }
  }
  *out = acc;
  *nn_out = nn;
  return j;
}

// Warp sum, wrapping as the int64 sums do.
__device__ __forceinline__ int64_t pagg_wsum(int64_t v) {
  unsigned long long u = static_cast<unsigned long long>(v);
  for (int o = 16; o > 0; o >>= 1) u += __shfl_xor_sync(0xFFFFFFFFu, u, o);
  return static_cast<int64_t>(u);
}

__device__ __forceinline__ int64_t pagg_wext(int64_t v, bool is_min) {
  for (int o = 16; o > 0; o >>= 1) {
    const int64_t w = __shfl_xor_sync(0xFFFFFFFFu, v, o);
    v = is_min ? (w < v ? w : v) : (w > v ? w : v);
  }
  return v;
}

// One warp per sorted position; the warps of segment leaders work.  The
// segment's end is found 32 rows at a time (a ballot of is_new).  Counts,
// integer sums (wrapping int64) and integer min/max are order-free: each
// lane folds every 32nd row and a shuffle tree combines the lanes.  Float
// sums, and float min/max (the sign of a zero depends on the order), are
// one lane's serial walk in sorted order.  Every lane then writes every
// 32nd row of the segment.
__global__ void pagg_walk_kernel(RwPartialAggs a, int64_t cap,
                                 const int64_t* __restrict__ perm,
                                 const int32_t* __restrict__ signs,
                                 const uint8_t* __restrict__ is_new) {
  const int lane = threadIdx.x & 31;
  const int64_t i =
      (blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x) >> 5;
  if (i >= cap || !is_new[i]) return;  // uniform over the warp
  int64_t end = i + 1;
  for (;; end += 32) {
    const int64_t j = end + lane;
    const unsigned stop =
        __ballot_sync(0xFFFFFFFFu, j >= cap || (j < cap && is_new[j]));
    if (stop != 0u) {
      end += __ffs(stop) - 1;
      break;
    }
  }
  if (end > cap) end = cap;
  for (int k = 0; k < a.n; ++k) {
    const int kind = a.kind[k];
    const bool fl = a.dtype[k] == PAGG_F32 || a.dtype[k] == PAGG_F64;
    int64_t nn = 0;
    if (kind != PAGG_COUNT && fl) {
      double rd = 0.0;
      float rf = 0.0f;
      if (lane == 0) {
        if (a.dtype[k] == PAGG_F32) {
          pagg_walk_float<float>(a, k, i, cap, perm, signs, is_new, &rf, &nn);
        } else {
          pagg_walk_float<double>(a, k, i, cap, perm, signs, is_new, &rd, &nn);
        }
      }
      nn = __shfl_sync(0xFFFFFFFFu, nn, 0);
      rd = __shfl_sync(0xFFFFFFFFu, rd, 0);
      rf = __shfl_sync(0xFFFFFFFFu, rf, 0);
      for (int64_t j = i + lane; j < end; j += 32) {
        if (a.dtype[k] == PAGG_F32) {
          static_cast<float*>(a.out[k])[j] = rf;
        } else {
          static_cast<double*>(a.out[k])[j] = rd;
        }
      }
    } else {
      // integers: the sum in int64 (wrapping), min/max in the argument's
      // type with its extreme as the identity
      int64_t lo = INT64_MIN, hi = INT64_MAX;
      if (a.dtype[k] == PAGG_I32) { lo = INT32_MIN; hi = INT32_MAX; }
      if (a.dtype[k] == PAGG_I16) { lo = INT16_MIN; hi = INT16_MAX; }
      const bool is_min = kind == PAGG_MIN;
      const int64_t ident = is_min ? hi : lo;
      int64_t acc = kind == PAGG_MIN || kind == PAGG_MAX ? ident : 0;
      for (int64_t j = i + lane; j < end; j += 32) {
        const int64_t p = perm[j];
        const bool null = a.arg_null[k] != nullptr && a.arg_null[k][p] != 0;
        const int32_t eff = null ? 0 : signs[p];
        nn += eff < 0 ? -eff : eff;
        if (kind == PAGG_COUNT) {
          acc += eff;
        } else {
          const int64_t v = null ? 0 : pagg_int(a, k, p);
          if (kind == PAGG_SUM) {
            acc = static_cast<int64_t>(
                static_cast<uint64_t>(acc) +
                static_cast<uint64_t>(v) *
                    static_cast<uint64_t>(static_cast<int64_t>(eff)));
          } else {
            const int64_t m = null ? ident : v;
            if (is_min ? m < acc : m > acc) acc = m;
          }
        }
      }
      nn = pagg_wsum(nn);
      acc = kind == PAGG_COUNT || kind == PAGG_SUM ? pagg_wsum(acc)
                                                   : pagg_wext(acc, is_min);
      for (int64_t j = i + lane; j < end; j += 32) {
        if (kind == PAGG_COUNT || kind == PAGG_SUM ||
            a.dtype[k] == PAGG_I64) {
          static_cast<int64_t*>(a.out[k])[j] = acc;
        } else if (a.dtype[k] == PAGG_I32) {
          static_cast<int32_t*>(a.out[k])[j] = static_cast<int32_t>(acc);
        } else {
          static_cast<int16_t*>(a.out[k])[j] = static_cast<int16_t>(acc);
        }
      }
    }
    if (a.out_null[k] != nullptr) {
      for (int64_t j = i + lane; j < end; j += 32) a.out_null[k][j] = nn == 0;
    }
  }
}

// scratch: cap bytes (is_new)
extern "C" int rw_partial_agg(RwCols keys, RwPartialAggs aggs, long long cap,
                              const void* perm, const void* valid,
                              const void* signs, void* scratch,
                              void* valid_out, void* stream) {
  if (cap > 0) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int threads = 256;
    const unsigned blocks = static_cast<unsigned>((cap + threads - 1) / threads);
    uint8_t* is_new = static_cast<uint8_t*>(scratch);
    pagg_mark_kernel<<<blocks, threads, 0, st>>>(
        keys, cap, static_cast<const int64_t*>(perm),
        static_cast<const uint8_t*>(valid), is_new,
        static_cast<uint8_t*>(valid_out));
    const unsigned warp_blocks =
        static_cast<unsigned>((cap * 32 + threads - 1) / threads);
    pagg_walk_kernel<<<warp_blocks, threads, 0, st>>>(
        aggs, cap, static_cast<const int64_t*>(perm),
        static_cast<const int32_t*>(signs), is_new);
  }
  return static_cast<int>(cudaGetLastError());
}
