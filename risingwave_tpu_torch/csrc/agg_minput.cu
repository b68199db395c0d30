// Kernel K6m: the materialized-input state of retractable min/max (sm_90a).
//
// Replaces risingwave_tpu/stream/hash_agg.py `_minput_update` (:790) and
// `_refresh_minput_caches` (:879).  An aggregation over a retractable
// input keeps, for each min/max call, a [size, B] value bucket aligned
// with its group table's slots and a [size, B] occupancy plane; the
// call's [size] state is a cache that the flush recomputes from the
// bucket.  Values are int64, int32 or float64 (`dtype` 0, 1, 2, as
// agg_scatter.cu).  Before the update: K1 hashes each row's (slot,
// value) pair, and K13's rank launch ranks the surviving inserts among
// rows of equal slot, in the aggregation's sorted row order.
//
//   rw_bucket_cancel   in-chunk annihilation over the stably sorted pair
//                      hashes, one 1024-thread block (rw_bucket.cuh,
//                      shared with K13d): the k-th insert of a (slot,
//                      value) cancels the k-th delete of it; it also
//                      writes each surviving delete's rank among the
//                      surviving deletes of its pair;
//   rw_minput_update   five grid launches, in the reference's order:
//     reset         empties the buckets of the slots claimed anew this
//                   chunk (`ins_pos`: a reclaimed slot's stale values);
//     find_clears   one thread per surviving delete walks its slot's B
//                   entries and picks the del_rank-th occupied entry equal
//                   to its value (the bucket as the reset left it); a
//                   delete with no such entry counts into `inconsistency`;
//     apply_clears  clears the picked entries (distinct: equal values
//                   differ in rank);
//     find_takes    one thread per surviving insert picks the ins_rank-th
//                   free entry of its slot's bucket after the clears; an
//                   insert that finds none counts into `overflow`;
//     apply_takes   marks the taken entries and writes the values.
//   Each pick launch only reads the occupancy and each write launch only
//   writes it, so the deletes see one snapshot and the inserts the next,
//   as the reference's vectorised passes do, without atomics on the plane.
//   rw_minput_refresh  one warp per emitted slot reduces its bucket over
//                      the occupied entries (identity: the type's max for
//                      min, min for max, +-inf for float64; a NaN wins)
//                      into the call's cache at that slot; sentinel slots
//                      (>= size) write nothing.
//
// Bound: bytes.  A surviving insert reads its bucket's B occupancy bytes
// and writes one entry (9 B); a surviving delete reads the B occupancy
// bytes and B values and clears one byte; a cancelled pair reads no
// bucket.  The refresh reads B x 9 bytes per live emitted slot and writes
// one value.  A walk is B sequential bytes a thread, so the update is
// latency-bound at chunk sizes.
#include <cstdint>
#include <cuda_runtime.h>

#include "rw_bucket.cuh"

struct MinputArgs {
  void* vals;                // [size * B] values of `dtype`
  uint8_t* occupied;         // [size * B]
  const int* row_slots;      // [cap] each row's group slot (< size)
  const void* v;             // [cap] each row's value, `dtype`
  const uint8_t* is_ins;     // [cap] surviving inserts
  const uint8_t* is_del;     // [cap] surviving deletes
  const int* ins_rank;       // [cap] rank among inserts of equal slot
  const int* del_rank;       // [cap] rank among deletes of equal pair
  const int* ins_pos;        // [cap] slots claimed anew (>= size: none)
  long long* overflow;       // [1]
  long long* inconsistency;  // [1]
  int* clear_pos;            // [cap] scratch: flat entry to clear or -1
  int* take_pos;             // [cap] scratch: flat entry to take or -1
  int cap;
  int size;
  int B;
  int dtype;
};

__device__ __forceinline__ long long row_base(const MinputArgs& a, int r) {
  const int s = a.row_slots[r];
  return static_cast<long long>(s < a.size - 1 ? s : a.size - 1) * a.B;
}

// a stored value equal to row r's (IEEE == for float64, as the reference)
struct ValEq {
  const void* vals;
  const void* v;
  int r;
  int dtype;
  __device__ __forceinline__ bool operator()(long long e) const {
    switch (dtype) {
      case 0:
        return static_cast<const long long*>(vals)[e] ==
               static_cast<const long long*>(v)[r];
      case 1:
        return static_cast<const int*>(vals)[e] ==
               static_cast<const int*>(v)[r];
      default:
        return static_cast<const double*>(vals)[e] ==
               static_cast<const double*>(v)[r];
    }
  }
};

__global__ void minput_reset_kernel(MinputArgs a) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= a.cap) return;
  const int s = a.ins_pos[r];
  if (s < 0 || s >= a.size) return;
  uint8_t* row = a.occupied + static_cast<long long>(s) * a.B;
  for (int b = 0; b < a.B; ++b) row[b] = 0;
}

__global__ void minput_find_clears_kernel(MinputArgs a) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= a.cap) return;
  int pos = -1;
  if (a.is_del[r]) {
    pos = rw_bucket_pick(a.occupied, row_base(a, r), a.B, true,
                         a.del_rank[r], ValEq{a.vals, a.v, r, a.dtype});
    if (pos < 0) {
      atomicAdd(reinterpret_cast<unsigned long long*>(a.inconsistency), 1ull);
    }
  }
  a.clear_pos[r] = pos;
}

__global__ void minput_apply_clears_kernel(MinputArgs a) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= a.cap) return;
  const int p = a.clear_pos[r];
  if (p >= 0) a.occupied[p] = 0;
}

__global__ void minput_find_takes_kernel(MinputArgs a) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= a.cap) return;
  int pos = -1;
  if (a.is_ins[r]) {
    pos = rw_bucket_pick(a.occupied, row_base(a, r), a.B, false,
                         a.ins_rank[r], RwAny{});
    if (pos < 0) {
      atomicAdd(reinterpret_cast<unsigned long long*>(a.overflow), 1ull);
    }
  }
  a.take_pos[r] = pos;
}

__global__ void minput_apply_takes_kernel(MinputArgs a) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= a.cap) return;
  const int p = a.take_pos[r];
  if (p < 0) return;
  a.occupied[p] = 1;
  switch (a.dtype) {
    case 0:
      static_cast<long long*>(a.vals)[p] =
          static_cast<const long long*>(a.v)[r];
      break;
    case 1:
      static_cast<int*>(a.vals)[p] = static_cast<const int*>(a.v)[r];
      break;
    default:
      static_cast<double*>(a.vals)[p] = static_cast<const double*>(a.v)[r];
  }
}

extern "C" int rw_minput_update(MinputArgs a, void* stream) {
  if (a.cap > 0) {
    const int threads = 256;
    const int blocks = (a.cap + threads - 1) / threads;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    minput_reset_kernel<<<blocks, threads, 0, s>>>(a);
    minput_find_clears_kernel<<<blocks, threads, 0, s>>>(a);
    minput_apply_clears_kernel<<<blocks, threads, 0, s>>>(a);
    minput_find_takes_kernel<<<blocks, threads, 0, s>>>(a);
    minput_apply_takes_kernel<<<blocks, threads, 0, s>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// refresh: the caches of the emitted slots

struct RefreshArgs {
  const void* vals;         // [size * B]
  const uint8_t* occupied;  // [size * B]
  const int* slots;         // [n] emitted slots (>= size: none)
  void* prim;               // [size] the call's cache
  int n;
  int size;
  int B;
  int dtype;
  int mode;                 // 1 min, 2 max
};

template <typename T>
__device__ __forceinline__ T pick_ext(T x, T y, bool is_min) {
  if (x != x) return x;  // NaN wins (float64 only; integers equal self)
  if (y != y) return y;
  return is_min ? (y < x ? y : x) : (y > x ? y : x);
}

template <typename T>
__device__ __forceinline__ void refresh_slot(const RefreshArgs& a, int s,
                                             int lane, T ident) {
  const bool is_min = a.mode == 1;
  const T* vals = static_cast<const T*>(a.vals);
  const long long base = static_cast<long long>(s) * a.B;
  T acc = ident;
  for (int b = lane; b < a.B; b += 32) {
    if (a.occupied[base + b]) acc = pick_ext(acc, vals[base + b], is_min);
  }
  for (int o = 16; o > 0; o >>= 1) {
    acc = pick_ext(acc, __shfl_down_sync(0xffffffffu, acc, o), is_min);
  }
  if (lane == 0) static_cast<T*>(a.prim)[s] = acc;
}

__global__ void minput_refresh_kernel(RefreshArgs a) {
  const int w = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (w >= a.n) return;  // whole warps leave together
  const int s = a.slots[w];
  if (s < 0 || s >= a.size) return;
  const bool is_min = a.mode == 1;
  switch (a.dtype) {
    case 0:
      refresh_slot<long long>(a, s, lane,
                              is_min ? 0x7fffffffffffffffll
                                     : (-0x7fffffffffffffffll - 1));
      break;
    case 1:
      refresh_slot<int>(a, s, lane, is_min ? 0x7fffffff : (-0x7fffffff - 1));
      break;
    default:
      refresh_slot<double>(a, s, lane,
                           is_min ? __longlong_as_double(0x7ff0000000000000ll)
                                  : __longlong_as_double(
                                        static_cast<long long>(
                                            0xfff0000000000000ull)));
  }
}

extern "C" int rw_minput_refresh(RefreshArgs a, void* stream) {
  if (a.n > 0) {
    const int threads = 256;
    const int blocks = (a.n * 32 + threads - 1) / threads;
    minput_refresh_kernel<<<blocks, threads, 0,
                            static_cast<cudaStream_t>(stream)>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}
