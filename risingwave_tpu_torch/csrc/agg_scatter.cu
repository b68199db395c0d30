// Kernel C: hash-agg state update of a chunk (sm_90a).
//
// Replaces the per-row branch of risingwave_tpu/stream/hash_agg.py
// `HashAggExecutor.apply` (hash_agg.py:437-444, scatters at :633-644): after
// the probe (kernel B) has resolved every row to a slot,
//   1. reset_kernel: each row that claimed a fresh slot resets that slot's
//      primitive states to their identity and its row count to 0 (a slot
//      reclaimed after state cleaning must not keep stale state);
//   2. scatter_kernel: each row with a live slot atomically adds / mins /
//      maxes its lifted contribution into every primitive state, adds its
//      sign into the row count and marks the slot dirty.  Sentinel slots
//      (== size: invalid or overflowed rows) are dropped.
// The lifted contributions (`AggSpec.lift`) are computed by the wrapper.
// Integer results are exact whatever order the atomics land in; float64
// sums use atomicAdd(double*) and are not bit-reproducible.
//
// Bound: bytes (per row: slot 4 B, sign 8 B, 8 B per primitive; per touched
// slot: a read-modify-write).  Fed row by row (the CPU's branch), a chunk
// whose rows share one key serialises its atomics on one address; on the
// card the pre-aggregation (kernel K5, agg_preagg.cu) feeds it one
// representative per key with the key's partials instead.
#include "rw_common.cuh"

#define RW_MAX_PRIMS 8

enum { RW_ADD = 0, RW_MIN = 1, RW_MAX = 2 };
enum { RW_I64 = 0, RW_I32 = 1, RW_F64 = 2 };

struct AggArgs {
  int n_prims;
  int mode[RW_MAX_PRIMS];
  int dtype[RW_MAX_PRIMS];
  void* state[RW_MAX_PRIMS];          // [size] per primitive
  const void* value[RW_MAX_PRIMS];    // [cap] lifted contribution
  long long init_i[RW_MAX_PRIMS];     // identity (integer states)
  double init_f[RW_MAX_PRIMS];        // identity (float states)
  const int32_t* slots;               // [cap]
  const uint8_t* inserted;            // [cap]
  const long long* signs;             // [cap] row-count contribution
  long long* row_count;               // [size]
  uint8_t* dirty;                     // [size]
  int cap;
  int size;
};

__global__ void reset_kernel(AggArgs a) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= a.cap || !a.inserted[r]) return;
  const int s = a.slots[r];
  if (s >= a.size) return;
  for (int p = 0; p < a.n_prims; ++p) {
    switch (a.dtype[p]) {
      case RW_I64: static_cast<long long*>(a.state[p])[s] = a.init_i[p]; break;
      case RW_I32: static_cast<int*>(a.state[p])[s] =
                       static_cast<int>(a.init_i[p]); break;
      default: static_cast<double*>(a.state[p])[s] = a.init_f[p];
    }
  }
  a.row_count[s] = 0;
}

__global__ void scatter_kernel(AggArgs a) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= a.cap) return;
  const int s = a.slots[r];
  if (s >= a.size) return;
  for (int p = 0; p < a.n_prims; ++p) {
    if (a.dtype[p] == RW_I64) {
      long long* dst = static_cast<long long*>(a.state[p]) + s;
      const long long v = static_cast<const long long*>(a.value[p])[r];
      if (a.mode[p] == RW_ADD) {
        atomicAdd(reinterpret_cast<unsigned long long*>(dst),
                  static_cast<unsigned long long>(v));
      } else if (a.mode[p] == RW_MIN) {
        atomicMin(dst, v);
      } else {
        atomicMax(dst, v);
      }
    } else if (a.dtype[p] == RW_I32) {
      int* dst = static_cast<int*>(a.state[p]) + s;
      const int v = static_cast<const int*>(a.value[p])[r];
      if (a.mode[p] == RW_ADD) {
        atomicAdd(dst, v);
      } else if (a.mode[p] == RW_MIN) {
        atomicMin(dst, v);
      } else {
        atomicMax(dst, v);
      }
    } else {  // float64 add (min/max are refused by the wrapper)
      atomicAdd(static_cast<double*>(a.state[p]) + s,
                static_cast<const double*>(a.value[p])[r]);
    }
  }
  atomicAdd(reinterpret_cast<unsigned long long*>(a.row_count + s),
            static_cast<unsigned long long>(a.signs[r]));
  a.dirty[s] = 1;
}

extern "C" int rw_agg_scatter(AggArgs args, void* stream) {
  if (args.cap > 0) {
    const int threads = 256;
    const int blocks = (args.cap + threads - 1) / threads;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    reset_kernel<<<blocks, threads, 0, st>>>(args);
    scatter_kernel<<<blocks, threads, 0, st>>>(args);
  }
  return static_cast<int>(cudaGetLastError());
}
