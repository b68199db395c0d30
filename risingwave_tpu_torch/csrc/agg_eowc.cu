// Kernel K7e: the closed windows of an EMIT ON WINDOW CLOSE aggregation
// (sm_90a).
//
// Replaces risingwave_tpu/stream/hash_agg.py `_closed_mask` (:961) and the
// compaction of `_flush_eowc` (:973-1001), with `pending_flush`'s EOWC
// count (:1007-1010).  A group slot is closed when
//   occupied & key + lag <= wm & !key_null & wm != INT64_MIN
// where `key` is the window-start (or window-end) group key column and
// `wm` the aggregation's watermark, read on the device (no host read).
// The flush takes the first k closed slots in ascending slot order
// through the two passes of compact.cu's K7 (rw_compact.cuh), computing
// each closed bit where it is read instead of storing a mask:
//   eowc_count_kernel  counts each tile's closed slots;
//   eowc_write_kernel  writes the ranks below k (the `size` sentinel past
//                      the last one) and the total closed count, which is
//                      the drain's pending count (with k = 0 only that).
// The key and output gathers and the eviction (the K4 sweep by slot list)
// are the ported code's.
//
// Bound: bytes.  Each slot's occupancy byte, key and null byte are read
// twice (9-10 B a slot per pass) and 4k bytes written; at 2^18 slots
// that is ~1.5 us of HBM time, so launch latency dominates.
#include <cstdint>
#include <cuda_runtime.h>

#include "rw_compact.cuh"

struct EowcArgs {
  const uint8_t* occupied;  // [size]
  const long long* key;     // [size] the window group key
  const uint8_t* key_null;  // [size] or null
  const long long* wm;      // [1] the aggregation's watermark
  long long lag;
  int* counts;              // [n_tiles] scratch
  int* out;                 // [k] closed slots, ascending (fill: size)
  long long* total;         // [1] the number of closed slots
  int size;
  int k;
};

struct ClosedBits {
  const uint8_t* occupied;
  const long long* key;
  const uint8_t* key_null;
  long long wm;
  long long lag;
  __device__ __forceinline__ bool operator()(int i) const {
    if (wm == (-0x7fffffffffffffffll - 1) || !occupied[i]) return false;
    if (key_null != nullptr && key_null[i]) return false;
    // key + lag wraps as the reference's int64 add does
    const long long end = static_cast<long long>(
        static_cast<unsigned long long>(key[i]) +
        static_cast<unsigned long long>(lag));
    return end <= wm;
  }
};

__device__ __forceinline__ ClosedBits closed_bits(const EowcArgs& a) {
  return ClosedBits{a.occupied, a.key, a.key_null, *a.wm, a.lag};
}

__global__ void __launch_bounds__(MI_THREADS) eowc_count_kernel(EowcArgs a) {
  rw_mi_count(closed_bits(a), a.size, a.counts);
}

__global__ void __launch_bounds__(MI_THREADS)
    eowc_write_kernel(EowcArgs a, int n_tiles) {
  rw_mi_write(closed_bits(a), a.size, n_tiles, a.counts, a.k, a.size, a.out,
              a.total);
}

extern "C" int rw_agg_eowc(EowcArgs a, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_tiles = a.size > 0 ? (a.size + MI_TILE - 1) / MI_TILE : 0;
  if (n_tiles > 0) eowc_count_kernel<<<n_tiles, MI_THREADS, 0, st>>>(a);
  eowc_write_kernel<<<n_tiles > 0 ? n_tiles : 1, MI_THREADS, 0, st>>>(
      a, n_tiles);
  return static_cast<int>(cudaGetLastError());
}
