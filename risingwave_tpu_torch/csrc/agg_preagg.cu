// Kernel K5: chunk-local pre-aggregation of hash-sorted rows (sm_90a).
//
// Replaces the accelerator branch of risingwave_tpu/stream/hash_agg.py
// `HashAggExecutor.apply` (hash_agg.py:394-436, per-prim segment reduce
// :613-641, row count :639-642) with the segment primitives of
// risingwave_tpu/common/compact.py:46-110.  The wrapper sorts the chunk
// by key hash (torch.sort, stable, on h ^ 2^63 so the signed order is the
// unsigned one; invalid rows carry INT64_MAX and sort last).  Given the
// sorted keys and the permutation, this kernel, in ONE block:
//   1. gathers the key columns into sorted order, restores the sorted
//      hashes and marks segment starts: the hash differs OR any key column
//      differs (NULL == NULL, payload ignored under a null), so colliding
//      distinct keys stay apart.  A string key arrives as two leaves under
//      its null plane, its [n, w] bytes and its int32 lengths, and both
//      compare byte for byte, the padding past the length included, as
//      the reference's `_keys_equal` compares a StrCol;
//   2. reduces, per segment, the valid-row count, the changelog signs and
//      every primitive's lifted contribution (add / min / max, read
//      through the permutation in chunk order), and writes the segment's
//      result at its END row and the identity elsewhere;
//   3. marks the representatives: END rows that are valid.
// Each segmented reduction is a per-thread sequential pass over a
// contiguous range of rows, a block-wide inclusive segmented scan of the
// per-thread (has-start, partial) pairs in shared memory, and a second
// pass that applies the carry.  Only the representatives then probe the
// table (kernel B) and scatter (kernel C), so a chunk whose rows all fall
// on one key costs one atomic per primitive instead of one per row.
//
// Integer results are exact (int64 sums wrap like the reference's
// cumsum differences).  float64 sums are reduced in another order than
// the plain version's cumsum difference and may differ in the last bits.
//
// Bound: bytes (per row: sorted key 8 B, perm 8 B, key columns, valid 1 B,
// sign 4 B, 8 B per primitive read; sorted keys, hash 8 B, rep 1 B and
// 8 B per reduced quantity written).  One block is far below the card's
// bandwidth, but at 8192 rows the whole call is a few microseconds, below
// the launch and sort overhead around it.
#include <type_traits>

#include "rw_common.cuh"

#define PA_MAX_PRIMS 8

enum { PA_ADD = 0, PA_MIN = 1, PA_MAX = 2 };
enum { PA_I64 = 0, PA_I32 = 1, PA_F64 = 2 };

struct PreaggArgs {
  RwCols keys;                // in_data: chunk keys; st_data: sorted out
  const long long* sort_key;  // [n] sorted: h ^ 2^63, INT64_MAX if invalid
  const long long* perm;      // [n] chunk row of each sorted row
  const uint8_t* valid;       // [n] chunk order
  const int* signs;           // [n] chunk order
  uint8_t* starts;            // [n] scratch: segment-start flags
  long long* s_hash;          // [n] out: sorted hashes
  uint8_t* rep;               // [n] out: representative rows
  long long* seg_rows;        // [n] out: valid rows per segment (at END)
  long long* seg_signs;       // [n] out: sign sum per segment (at END)
  int n_prims;
  int mode[PA_MAX_PRIMS];
  int dtype[PA_MAX_PRIMS];
  const void* value[PA_MAX_PRIMS];  // [n] chunk order lifted contributions
  void* seg[PA_MAX_PRIMS];          // [n] out: segment result at END rows
  long long init_i[PA_MAX_PRIMS];
  double init_f[PA_MAX_PRIMS];
  int n;
};

static constexpr int PA_THREADS = 1024;

// Row a and row b of one input column are equal (byte-wise).
__device__ __forceinline__ bool rows_equal(const void* base, int w,
                                           long long a, long long b) {
  const uint8_t* pa = static_cast<const uint8_t*>(base) + a * w;
  const uint8_t* pb = static_cast<const uint8_t*>(base) + b * w;
  switch (w) {
    case 1: return *pa == *pb;
    case 2: return *reinterpret_cast<const uint16_t*>(pa) ==
                   *reinterpret_cast<const uint16_t*>(pb);
    case 4: return *reinterpret_cast<const uint32_t*>(pa) ==
                   *reinterpret_cast<const uint32_t*>(pb);
    case 8: return *reinterpret_cast<const uint64_t*>(pa) ==
                   *reinterpret_cast<const uint64_t*>(pb);
    default:
      for (int j = 0; j < w; ++j) {
        if (pa[j] != pb[j]) return false;
      }
      return true;
  }
}

__device__ __forceinline__ bool is_start(const PreaggArgs& a, int i) {
  if (i == 0 || a.sort_key[i] != a.sort_key[i - 1]) return true;
  const long long p = a.perm[i], q = a.perm[i - 1];
  for (int k = 0; k < a.keys.n; ++k) {
    bool eq;
    if (a.keys.in_null[k] != nullptr) {
      const bool pn = a.keys.in_null[k][p] != 0;
      const bool qn = a.keys.in_null[k][q] != 0;
      eq = (pn && qn) ||
           (!pn && !qn && rows_equal(a.keys.in_data[k], a.keys.width[k], p, q));
    } else {
      eq = rows_equal(a.keys.in_data[k], a.keys.width[k], p, q);
    }
    if (!eq) return true;
  }
  return false;
}

template <typename T>
__device__ __forceinline__ T combine(int mode, T x, T y);

template <>
__device__ __forceinline__ long long combine<long long>(int mode, long long x,
                                                        long long y) {
  if (mode == PA_ADD) {  // wrapping, like the reference's int64 cumsum
    return static_cast<long long>(static_cast<unsigned long long>(x) +
                                  static_cast<unsigned long long>(y));
  }
  if (mode == PA_MIN) return x < y ? x : y;
  return x > y ? x : y;
}

template <>
__device__ __forceinline__ double combine<double>(int mode, double x,
                                                  double y) {
  if (mode == PA_ADD) return x + y;
  if (mode == PA_MIN) return fmin(x, y);
  return fmax(x, y);
}

// One quantity to reduce: where its per-row input lives (chunk order,
// read through perm) and where its result goes (sorted order).
struct Quantity {
  const void* src;
  int src_kind;  // 0: uint8 flag, 1: int32, 2: int64, 3: float64
  void* dst;
  int dst_kind;  // 1: int32, 2: int64, 3: float64
  int mode;
};

__device__ __forceinline__ long long load_i(const Quantity& q, long long p) {
  switch (q.src_kind) {
    case 0: return static_cast<const uint8_t*>(q.src)[p] != 0 ? 1 : 0;
    case 1: return static_cast<const int*>(q.src)[p];
    default: return static_cast<const long long*>(q.src)[p];
  }
}

__device__ __forceinline__ void store_i(const Quantity& q, int i,
                                        long long v) {
  if (q.dst_kind == 1) {
    static_cast<int*>(q.dst)[i] = static_cast<int>(v);
  } else {
    static_cast<long long*>(q.dst)[i] = v;
  }
}

// Segmented reduction of one quantity over the block (see the header).
template <typename T>
__device__ void segmented_reduce(const PreaggArgs& a, const Quantity& q,
                                 T ident, int lo, int hi, T* sh_v,
                                 uint8_t* sh_f) {
  const int t = threadIdx.x;
  T acc = ident;
  bool has_start = false;
  for (int i = lo; i < hi; ++i) {
    if (a.starts[i]) {
      acc = ident;
      has_start = true;
    }
    T v;
    if constexpr (std::is_same<T, double>::value) {
      v = static_cast<const double*>(q.src)[a.perm[i]];
    } else {
      v = static_cast<T>(load_i(q, a.perm[i]));
    }
    acc = combine<T>(q.mode, acc, v);
  }
  sh_v[t] = acc;
  sh_f[t] = has_start;
  __syncthreads();
  for (int off = 1; off < static_cast<int>(blockDim.x); off <<= 1) {
    T v = sh_v[t];
    uint8_t f = sh_f[t];
    if (t >= off) {
      if (!f) v = combine<T>(q.mode, sh_v[t - off], v);
      f = f | sh_f[t - off];
    }
    __syncthreads();
    sh_v[t] = v;
    sh_f[t] = f;
    __syncthreads();
  }
  T run = t > 0 ? sh_v[t - 1] : ident;
  __syncthreads();  // the shared arrays are reused by the next quantity
  for (int i = lo; i < hi; ++i) {
    if (a.starts[i]) run = ident;
    T v;
    if constexpr (std::is_same<T, double>::value) {
      v = static_cast<const double*>(q.src)[a.perm[i]];
    } else {
      v = static_cast<T>(load_i(q, a.perm[i]));
    }
    run = combine<T>(q.mode, run, v);
    const bool end = (i == a.n - 1) || a.starts[i + 1];
    const T out = end ? run : ident;
    if constexpr (std::is_same<T, double>::value) {
      static_cast<double*>(q.dst)[i] = out;
    } else {
      store_i(q, i, static_cast<long long>(out));
    }
  }
}

__global__ void __launch_bounds__(PA_THREADS) preagg_kernel(PreaggArgs a) {
  __shared__ long long sh_i[PA_THREADS];
  __shared__ double sh_d[PA_THREADS];
  __shared__ uint8_t sh_f[PA_THREADS];
  const int n = a.n;
  const int per = (n + blockDim.x - 1) / blockDim.x;
  const int lo = min(n, static_cast<int>(threadIdx.x) * per);
  const int hi = min(n, lo + per);

  // 1. gather the keys, restore the hashes, mark the segment starts
  for (int i = lo; i < hi; ++i) {
    rw_store_row(a.keys, i, a.perm[i]);
    a.s_hash[i] = static_cast<long long>(
        static_cast<unsigned long long>(a.sort_key[i]) ^ (1ull << 63));
    a.starts[i] = is_start(a, i) ? 1 : 0;
  }
  __syncthreads();
  for (int i = lo; i < hi; ++i) {
    const bool end = (i == n - 1) || a.starts[i + 1];
    a.rep[i] = (end && a.valid[a.perm[i]] != 0) ? 1 : 0;
  }

  // 2. segmented reductions, one quantity at a time
  Quantity rows{a.valid, 0, a.seg_rows, 2, PA_ADD};
  segmented_reduce<long long>(a, rows, 0, lo, hi, sh_i, sh_f);
  Quantity sgn{a.signs, 1, a.seg_signs, 2, PA_ADD};
  segmented_reduce<long long>(a, sgn, 0, lo, hi, sh_i, sh_f);
  for (int p = 0; p < a.n_prims; ++p) {
    if (a.dtype[p] == PA_F64) {
      Quantity q{a.value[p], 3, a.seg[p], 3, a.mode[p]};
      segmented_reduce<double>(a, q, a.init_f[p], lo, hi, sh_d, sh_f);
    } else {
      const int kind = a.dtype[p] == PA_I32 ? 1 : 2;
      Quantity q{a.value[p], kind, a.seg[p], kind, a.mode[p]};
      segmented_reduce<long long>(a, q, a.init_i[p], lo, hi, sh_i, sh_f);
    }
  }
}

extern "C" int rw_agg_preagg(PreaggArgs args, void* stream) {
  if (args.n > 0) {
    preagg_kernel<<<1, PA_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        args);
  }
  return static_cast<int>(cudaGetLastError());
}
