// Kernels K7 and K8-ring: order-preserving compaction of a mask (sm_90a).
//
// rw_mask_indices replaces risingwave_tpu/common/compact.py `mask_indices`
// (:32) as the agg flush uses it (risingwave_tpu/stream/hash_agg.py:909
// `flush`): the ascending indices of up to k set bits of a bool [n] mask,
// `fill` past the last one.  Two passes over tiles of 1024 mask bytes:
//   1. count_kernel: each block counts its tile's set bits;
//   2. write_kernel: each block sums the counts of the tiles before it,
//      scans its own tile (warp shuffles + one shared array) and writes
//      the indices whose rank is below k; every block also fills its
//      share of the positions [total, k) with `fill`.
// Nothing is read back to the host and the output size is fixed.  The
// two passes live in rw_compact.cuh, shared with K7e (agg_eowc.cu).
// Bound: bytes (n mask bytes read twice, 4k bytes written); at n = 2^18
// that is ~0.3 us of HBM time, so launch latency dominates.
//
// rw_ring_append replaces risingwave_tpu/stream/materialize.py:224
// `AppendOnlyMaterialize.apply`: the visible rows of a chunk, in order,
// are written to ring positions (cursor + rank) % ring_size, the cursor
// advances by the visible count and the rows evicted by a lap are added
// to the overflow counter.  One block walks the chunk in tiles of
// blockDim rows with a running base, so the cursor is read once and
// written once, by the same block, with no host sync.  Bound: bytes (the
// visible rows' column bytes read and written once).
#include "rw_common.cuh"
#include "rw_compact.cuh"

// a uint8 mask read from memory
struct MaskBits {
  const uint8_t* mask;
  __device__ __forceinline__ bool operator()(int i) const {
    return mask[i] != 0;
  }
};

__global__ void __launch_bounds__(MI_THREADS)
count_kernel(const uint8_t* __restrict__ mask, int n, int* __restrict__ counts) {
  rw_mi_count(MaskBits{mask}, n, counts);
}

__global__ void __launch_bounds__(MI_THREADS)
write_kernel(const uint8_t* __restrict__ mask, int n, int n_tiles,
             const int* __restrict__ counts, int k, int fill,
             int* __restrict__ out) {
  rw_mi_write(MaskBits{mask}, n, n_tiles, counts, k, fill, out, nullptr);
}

extern "C" int rw_mask_indices(const void* mask, int n, int k, int fill,
                               void* out, void* counts, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_tiles = n > 0 ? (n + MI_TILE - 1) / MI_TILE : 0;
  if (n_tiles > 0) {
    count_kernel<<<n_tiles, MI_THREADS, 0, st>>>(
        static_cast<const uint8_t*>(mask), n, static_cast<int*>(counts));
  }
  if (k > 0) {
    write_kernel<<<n_tiles > 0 ? n_tiles : 1, MI_THREADS, 0, st>>>(
        static_cast<const uint8_t*>(mask), n, n_tiles,
        static_cast<const int*>(counts), k, fill, static_cast<int*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// ring append

static constexpr int RA_THREADS = 1024;

__global__ void __launch_bounds__(RA_THREADS)
ring_append_kernel(RwCols cols, const uint8_t* __restrict__ valid, int cap,
                   long long* cursor, long long* overflow,
                   long long ring_size) {
  const long long cur = *cursor;
  long long written = 0;
  for (int t0 = 0; t0 < cap; t0 += blockDim.x) {
    const int i = t0 + threadIdx.x;
    const int v = (i < cap && valid[i] != 0) ? 1 : 0;
    int tile_total;
    const int rank = block_exclusive_scan(v, tile_total);
    if (v) {
      const long long pos = (cur + written + rank) & (ring_size - 1);
      rw_store_row(cols, pos, i);
    }
    written += tile_total;
  }
  __syncthreads();  // every thread has read the cursor
  if (threadIdx.x == 0) {
    const long long lost_before = cur > ring_size ? cur - ring_size : 0;
    const long long end = cur + written;
    const long long lost_after = end > ring_size ? end - ring_size : 0;
    *cursor = end;
    *overflow += lost_after - lost_before;
  }
}

extern "C" int rw_ring_append(RwCols cols, const void* valid, int cap,
                              void* cursor, void* overflow,
                              long long ring_size, void* stream) {
  ring_append_kernel<<<1, RA_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      cols, static_cast<const uint8_t*>(valid), cap,
      static_cast<long long*>(cursor), static_cast<long long*>(overflow),
      ring_size);
  return static_cast<int>(cudaGetLastError());
}
