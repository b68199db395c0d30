// Kernel K22b: the sink's changelog ring append (sm_90a).
//
// Replaces risingwave_tpu/stream/sink.py `SinkExecutor.apply` (:63): the
// chunk's visible rows, compacted in row order, and their ops are written
// to ring positions (cursor + rank) % ring_size; the cursor advances by
// the visible count.  Invalid rows write nothing (the reference's
// mode="drop" at position ring_size).  Nothing is read back to the host.
//
// A row is a list of planes: each value leaf (an int64/int32/float64/bool
// column, a string's [cap, W] bytes and its int32 lengths), each leaf's
// uint8 null plane and the int8 op.  Three launches:
//   1. sink_count_kernel  K7's first pass (rw_compact.cuh): each tile of
//                         1024 valid bytes counts its visible rows;
//   2. sink_rank_kernel   K7's second pass: idx[rank] = row for every
//                         visible row, meta[0] = their count; block 0
//                         also copies the cursor to meta[1];
//   3. sink_copy_kernel   one thread per (plane, rank, word): every plane
//                         of every visible row moves in 16-, 8-, 4-, 2-
//                         or 1-byte words (the widest that divides the
//                         plane's row and both pointers, chosen by the
//                         wrapper; the word copy is rw_rowcopy.cuh's,
//                         shared with K8-ring and K16), plane-major so
//                         that a warp reads and writes consecutive rows
//                         of one plane; block 0
//                         writes cursor = meta[1] + meta[0].  Every block
//                         reads the base from meta[1], never the cursor,
//                         so the write does not race the reads.
// Any chunk capacity works (a 2^18-row backfill chunk as well as 8192).
//
// Bound: bytes.  The visible rows' planes are read once and written
// once, and the valid bytes read twice: for 8192 rows of 4 x 8 B and a
// 1 B op, ~0.16 us of HBM time, so launch latency dominates.
#include <cstdint>
#include <cuda_runtime.h>

#include "rw_compact.cuh"
#include "rw_rowcopy.cuh"

#define SINK_MAX_PLANES 33

struct SinkPlanes {
  int n;
  int words[SINK_MAX_PLANES];       // words a row holds in this plane
  int word_bytes[SINK_MAX_PLANES];  // 16, 8, 4, 2 or 1
  long long start[SINK_MAX_PLANES + 1];  // first flat index (cap * words)
  const void* src[SINK_MAX_PLANES];      // [cap] chunk rows
  void* dst[SINK_MAX_PLANES];            // [ring_size] ring rows
};

struct ValidBits {
  const uint8_t* valid;
  __device__ __forceinline__ bool operator()(int i) const {
    return valid[i] != 0;
  }
};

static constexpr int SC_THREADS = 256;

__global__ void __launch_bounds__(MI_THREADS)
sink_count_kernel(const uint8_t* __restrict__ valid, int cap,
                  int* __restrict__ counts) {
  rw_mi_count(ValidBits{valid}, cap, counts);
}

__global__ void __launch_bounds__(MI_THREADS)
sink_rank_kernel(const uint8_t* __restrict__ valid, int cap, int n_tiles,
                 const int* __restrict__ counts, int* __restrict__ idx,
                 long long* __restrict__ meta,
                 const long long* __restrict__ cursor) {
  rw_mi_write(ValidBits{valid}, cap, n_tiles, counts, cap, cap, idx, meta);
  if (blockIdx.x == 0 && threadIdx.x == 0) meta[1] = *cursor;
}

__global__ void __launch_bounds__(SC_THREADS)
sink_copy_kernel(SinkPlanes p, const int* __restrict__ idx,
                 const long long* __restrict__ meta, long long* cursor,
                 long long ring_size) {
  const long long total = meta[0];
  const long long base = meta[1];
  if (blockIdx.x == 0 && threadIdx.x == 0) *cursor = base + total;
  const long long f =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (f >= p.start[p.n]) return;
  int k = 0;
  while (k + 1 < p.n && f >= p.start[k + 1]) ++k;
  const long long local = f - p.start[k];
  const int words = p.words[k];
  const long long rank = local / words;
  if (rank >= total) return;
  const int jj = static_cast<int>(local - rank * words);
  const long long row = idx[rank];
  const long long pos = (base + rank) & (ring_size - 1);
  const long long from = row * words + jj;
  const long long to = pos * words + jj;
  rw_copy_word(p.src[k], p.dst[k], from, to, p.word_bytes[k]);
}

extern "C" int rw_sink_append(SinkPlanes p, const void* valid, int cap,
                              void* cursor, long long ring_size, void* counts,
                              void* idx, void* meta, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (p.n < 1 || p.n > SINK_MAX_PLANES || cap <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int n_tiles = (cap + MI_TILE - 1) / MI_TILE;
  const uint8_t* v = static_cast<const uint8_t*>(valid);
  sink_count_kernel<<<n_tiles, MI_THREADS, 0, st>>>(v, cap,
                                                    static_cast<int*>(counts));
  sink_rank_kernel<<<n_tiles, MI_THREADS, 0, st>>>(
      v, cap, n_tiles, static_cast<const int*>(counts),
      static_cast<int*>(idx), static_cast<long long*>(meta),
      static_cast<const long long*>(cursor));
  const long long items = p.start[p.n];
  const long long blocks = (items + SC_THREADS - 1) / SC_THREADS;
  sink_copy_kernel<<<static_cast<unsigned>(blocks > 0 ? blocks : 1),
                     SC_THREADS, 0, st>>>(
      p, static_cast<const int*>(idx), static_cast<const long long*>(meta),
      static_cast<long long*>(cursor), ring_size);
  return static_cast<int>(cudaGetLastError());
}
