// Kernel K21: the dynamic filter (sm_90a).
//
// Replaces risingwave_tpu/stream/dynamic_filter.py `DynamicFilterExecutor`
// `_apply_left` (:92) and `_apply_right` (:106): a stream filtered by a
// comparison against a scalar that moves, the band join behind `HAVING
// COUNT(*) >= (SELECT ...)`.  The left side's rows live in a row pool
// (K16, `topn_pool`); the scalar is the right side's 1-row changelog.  The
// threshold and its `has_threshold` flag stay on the card: the host never
// reads them.
//
//   rw_dyn_filter_left   (K16 has applied the chunk to the pool) one
//                        thread per chunk row: the row passes while it
//                        clears the CURRENT threshold, valid & cmp(v, thr)
//                        & has_threshold;
//   rw_dyn_filter_right  two launches:
//     scalar  one block over the right chunk: the last visible insert-side
//             row gives the new threshold (`has_new`); a chunk with deletes
//             and no insert empties the scalar (`rhs_emptied`: nothing
//             passes, every passing row retracts).  It saves the OLD
//             threshold and flag in scratch and writes the new ones into
//             the state;
//     band    one thread per pool slot: `was` against the old threshold
//             and flag, `now` against the new ones; a valid slot that
//             starts passing is an Insert, one that stops a Delete.  It
//             writes the band chunk's ops and valid planes; the band's rows
//             are the pool's own stores.
// The filter column and the scalar share one physical type: int64 (also
// NUMERIC and TIMESTAMP), int32 or float64 (compared with subnormals as
// zero, as the reference's compares run with denormals-are-zero).
//
// Bound: bytes, counted from the rows the work needs.  The band pass reads
// each slot's flag and writes its band flag (2 B a slot), reads the value
// of the live slots alone (8 B each) and writes the ops of the band rows
// (the ops of the other slots are never read); the left pass reads each
// row's flag and writes its mask (2 B a row) and reads the value of the
// valid rows alone; the scalar pass reads the right chunk's flags and the
// visible rows' ops and values.  Both passes load a value only behind its
// flag.
#include <cfloat>
#include <cstdint>
#include <cuda_runtime.h>

enum { DF_GT = 0, DF_GE = 1, DF_LT = 2, DF_LE = 3, DF_EQ = 4 };
enum { DF_I64 = 0, DF_I32 = 1, DF_F64 = 2 };
// the changelog ops of risingwave_tpu_torch/common/chunk.py
enum { DF_OP_INSERT = 0, DF_OP_DELETE = 1, DF_OP_UPDATE_INSERT = 3 };

struct DynFilterArgs {
  const void* value;     // [n] the filter column (chunk or pool)
  const uint8_t* valid;  // [n] chunk valid (left) or pool valid (right)
  void* thr;             // [1] the threshold, in the filter's type
  uint8_t* has;          // [1] has_threshold
  uint8_t* out_valid;    // [n] left: passing rows; right: band rows
  int8_t* out_ops;       // [n] right: Insert / Delete
  const void* rhs;       // [m] right chunk's column 0
  const int8_t* rhs_ops; // [m]
  const uint8_t* rhs_valid;  // [m]
  long long* old_thr;    // [1] scratch: the threshold before the chunk
  uint8_t* old_has;      // [1] scratch
  int dtype;
  int cmp;
  int n;
  int m;
};

template <typename T>
__device__ __forceinline__ T df_load(const void* p, long long i) {
  return static_cast<const T*>(p)[i];
}

__device__ __forceinline__ double df_daz(double x) {
  return fabs(x) < DBL_MIN ? 0.0 : x;
}

template <typename T>
__device__ __forceinline__ bool df_cmp(int cmp, T v, T t) {
  switch (cmp) {
    case DF_GT: return v > t;
    case DF_GE: return v >= t;
    case DF_LT: return v < t;
    case DF_LE: return v <= t;
    default: return v == t;
  }
}

template <>
__device__ __forceinline__ bool df_cmp<double>(int cmp, double v, double t) {
  v = df_daz(v);
  t = df_daz(t);
  switch (cmp) {
    case DF_GT: return v > t;
    case DF_GE: return v >= t;
    case DF_LT: return v < t;
    case DF_LE: return v <= t;
    default: return v == t;
  }
}

template <typename T>
__global__ void dyn_left_kernel(DynFilterArgs a) {
  const long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                      threadIdx.x;
  if (i >= a.n) return;
  bool pass = false;
  if (a.valid[i] && *a.has) {
    pass = df_cmp<T>(a.cmp, df_load<T>(a.value, i),
                     *static_cast<const T*>(a.thr));
  }
  a.out_valid[i] = pass ? 1 : 0;
}

template <typename T>
__global__ void __launch_bounds__(1024) dyn_scalar_kernel(DynFilterArgs a) {
  __shared__ int sh_last[1024];
  __shared__ int sh_del[1024];
  const int t = threadIdx.x;
  int last = -1, any_del = 0;
  for (int i = t; i < a.m; i += blockDim.x) {
    if (!a.rhs_valid[i]) continue;
    const int8_t op = a.rhs_ops[i];
    if (op == DF_OP_INSERT || op == DF_OP_UPDATE_INSERT) {
      last = i > last ? i : last;
    } else {
      any_del = 1;
    }
  }
  sh_last[t] = last;
  sh_del[t] = any_del;
  __syncthreads();
  for (int off = blockDim.x / 2; off > 0; off >>= 1) {
    if (t < off) {
      sh_last[t] = max(sh_last[t], sh_last[t + off]);
      sh_del[t] |= sh_del[t + off];
    }
    __syncthreads();
  }
  if (t == 0) {
    T* thr = static_cast<T*>(a.thr);
    const T old = *thr;
    const bool old_has = *a.has != 0;
    *reinterpret_cast<T*>(a.old_thr) = old;
    *a.old_has = old_has ? 1 : 0;
    const bool has_new = sh_last[0] >= 0;
    const bool emptied = sh_del[0] && !has_new;
    if (has_new) *thr = df_load<T>(a.rhs, sh_last[0]);
    *a.has = ((old_has || has_new) && !emptied) ? 1 : 0;
  }
}

template <typename T>
__global__ void dyn_band_kernel(DynFilterArgs a) {
  const long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                      threadIdx.x;
  if (i >= a.n) return;
  bool ins = false, del = false;
  if (a.valid[i]) {
    const T v = df_load<T>(a.value, i);
    const bool was = *a.old_has &&
                     df_cmp<T>(a.cmp, v,
                               *reinterpret_cast<const T*>(a.old_thr));
    const bool now = *a.has &&
                     df_cmp<T>(a.cmp, v, *static_cast<const T*>(a.thr));
    ins = now && !was;
    del = was && !now;
  }
  a.out_ops[i] = ins ? DF_OP_INSERT : DF_OP_DELETE;
  a.out_valid[i] = (ins || del) ? 1 : 0;
}

template <typename T>
static void launch_left(const DynFilterArgs& a, cudaStream_t s) {
  const int threads = 256;
  dyn_left_kernel<T><<<(a.n + threads - 1) / threads, threads, 0, s>>>(a);
}

template <typename T>
static void launch_right(const DynFilterArgs& a, cudaStream_t s) {
  dyn_scalar_kernel<T><<<1, 1024, 0, s>>>(a);
  if (a.n > 0) {
    const int threads = 256;
    dyn_band_kernel<T><<<(a.n + threads - 1) / threads, threads, 0, s>>>(a);
  }
}

extern "C" int rw_dyn_filter_left(DynFilterArgs args, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (args.n > 0) {
    switch (args.dtype) {
      case DF_I64: launch_left<long long>(args, s); break;
      case DF_I32: launch_left<int>(args, s); break;
      default: launch_left<double>(args, s); break;
    }
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int rw_dyn_filter_right(DynFilterArgs args, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (args.dtype) {
    case DF_I64: launch_right<long long>(args, s); break;
    case DF_I32: launch_right<int>(args, s); break;
    default: launch_right<double>(args, s); break;
  }
  return static_cast<int>(cudaGetLastError());
}
