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
// to the overflow counter.  One launch, a grid of tiles of RA_TILE rows:
//   - a block takes the next tile by a ticket (so every tile it waits on
//     is already running), ranks the tile's visible rows with a block scan
//     and takes their base from the tiles before it by decoupled look-back:
//     each tile publishes its count at once and its inclusive prefix as
//     soon as it knows it, in one 64-bit status word tagged with the
//     call's epoch (a counter of the wrapper's, one per device and stream,
//     with the scratch), so no call resets the words;
//   - it copies its rows plane by plane in the widest word that divides
//     the plane's row and both pointers (rw_rowcopy.cuh), so a warp moves
//     consecutive words of one plane; null planes move with their leaves;
//   - every block reads the cursor before it counts in on a second ticket
//     (after a fence); the last one writes cursor + n and the lap count
//     and puts both tickets back to 0.  No block reads a cursor another
//     block has advanced, nothing is read back to the host, and positions
//     wrap within a chunk.
// Bound: bytes (the valid bytes read, the visible rows' planes read and
// written once).
#include "rw_common.cuh"
#include "rw_compact.cuh"
#include "rw_rowcopy.cuh"

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

static constexpr int RA_THREADS = 256;
static constexpr int RA_TILE = RA_THREADS;  // one row a thread

// status word: epoch << 34 | state << 32 | count
#define RA_AGG 1ull     // the tile's count is published
#define RA_PREFIX 2ull  // its inclusive prefix is published

struct RingArgs {
  RwCols cols;                 // in = chunk leaves, st = ring stores
  const uint8_t* valid;        // [cap]
  long long* cursor;           // [1] rows written so far, in place
  long long* overflow;         // [1] += rows a lap evicted
  unsigned long long* status;  // [tiles] look-back words, persistent
  int* ctl;                    // [2] tile and finish tickets, rest at 0
  unsigned long long epoch;    // this call's tag of the status words
  long long ring_size;
  int cap;
  int n_tiles;
};

__global__ void __launch_bounds__(RA_THREADS) ring_append_kernel(RingArgs a) {
  __shared__ int s_tile;
  __shared__ int s_base;
  __shared__ bool s_last;
  __shared__ int s_row[RA_TILE];
  __shared__ RwPlanes s_planes;
  const int t = threadIdx.x;
  const int lane = t & 31;
  if (t == 0) {
    s_tile = atomicAdd(&a.ctl[0], 1);
    rw_planes_of(a.cols, s_planes);
  }
  const long long cur = *a.cursor;
  __syncthreads();
  const int tile = s_tile;
  const int r = tile * RA_TILE + t;
  const int v = (r < a.cap && a.valid[r] != 0) ? 1 : 0;
  int tile_total;
  const int rank = block_exclusive_scan(v, tile_total);
  if (v) s_row[rank] = r;

  // the tile's base: decoupled look-back over the tiles before it (warp 0)
  if (t < 32) {
    volatile unsigned long long* status = a.status;
    const unsigned long long tag = a.epoch << 34;
    if (lane == 0) {
      status[tile] = tag | ((tile == 0 ? RA_PREFIX : RA_AGG) << 32) |
                     static_cast<unsigned>(tile_total);
    }
    long long base = 0;
    int pos = tile - 1;
    while (pos >= 0) {
      const int idx = pos - lane;  // lane 0 the nearest
      unsigned long long w = tag | (RA_PREFIX << 32);
      if (idx >= 0) {
        do {
          w = status[idx];
        } while ((w >> 34) != a.epoch);
      }
      const bool prefix = ((w >> 32) & RA_PREFIX) != 0;
      const unsigned stops = __ballot_sync(0xffffffffu, prefix);
      const int stop = stops ? __ffs(stops) - 1 : 32;
      long long c = (lane <= stop && idx >= 0) ? (w & 0xffffffffull) : 0;
      for (int o = 16; o > 0; o >>= 1) {
        c += __shfl_xor_sync(0xffffffffu, c, o);
      }
      base += c;
      if (stops) break;
      pos -= 32;
    }
    if (lane == 0) {
      if (tile > 0) {
        status[tile] = tag | (RA_PREFIX << 32) |
                       static_cast<unsigned>(base + tile_total);
      }
      s_base = static_cast<int>(base);
    }
  }
  __syncthreads();

  // the copy, plane by plane in words
  const long long first = cur + s_base;
  const long long mask = a.ring_size - 1;
  const int* rows = s_row;
  rw_copy_rows(
      s_planes, tile_total, [rows](int i) { return rows[i]; },
      [first, mask](int i) { return (first + i) & mask; }, t, RA_THREADS);

  // the last block to finish advances the cursor and counts the lap
  __syncthreads();
  if (t == 0) {
    __threadfence();
    s_last = atomicAdd(&a.ctl[1], 1) == a.n_tiles - 1;
  }
  __syncthreads();
  if (s_last && t == 0) {
    __threadfence();
    const volatile unsigned long long* status = a.status;
    const long long n =
        static_cast<long long>(status[a.n_tiles - 1] & 0xffffffffull);
    const long long R = a.ring_size;
    const long long lost_before = cur > R ? cur - R : 0;
    const long long end = cur + n;
    const long long lost_after = end > R ? end - R : 0;
    *a.cursor = end;
    *a.overflow += lost_after - lost_before;
    a.ctl[0] = 0;
    a.ctl[1] = 0;
  }
}

extern "C" int rw_ring_append(RingArgs args, void* stream) {
  if (args.n_tiles < 1) return static_cast<int>(cudaErrorInvalidValue);
  ring_append_kernel<<<args.n_tiles, RA_THREADS, 0,
                       static_cast<cudaStream_t>(stream)>>>(args);
  return static_cast<int>(cudaGetLastError());
}
