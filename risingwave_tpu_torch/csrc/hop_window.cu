// Kernel K10: TUMBLE / HOP window assignment (sm_90a).
//
// Replaces risingwave_tpu/stream/executor.py:142
// `HopWindowExecutor.apply`.  For every row, ws0 = ts - ts mod slide (the
// FLOOR modulo of jnp and torch, so negative timestamps fall into the
// window that contains them; CUDA's % truncates and is corrected here).
//   - k == 1 (TUMBLE): one thread per row writes window_start = ws0 and
//     window_end = ws0 + size; the chunk's columns are not copied.
//   - k > 1 (HOP): one thread per OUTPUT row o writes copy o % k of input
//     row o / k: every plane of the chunk (column payloads, null planes,
//     string bytes and lengths, ops, valid) is copied, window_start is
//     ws0 - (o % k) * slide and window_end window_start + size.  That is
//     the reference's `repeat(col, k)` order, in which the U-/U+ halves of
//     an update are k rows apart after the expansion.
// Bound: bytes (per output row: the copied planes' bytes read and written
// once, plus 16 B of window columns); the integer work is a handful of
// operations per row.
#include "rw_common.cuh"

__device__ __forceinline__ long long floor_mod(long long x, long long m) {
  const long long r = x % m;
  return (r != 0 && ((r < 0) != (m < 0))) ? r + m : r;
}

// Copy row `src` of plane k (width[k] bytes per row) to row `dst`.
__device__ __forceinline__ void copy_plane_row(const RwCols& c, int k,
                                               long long dst, long long src) {
  const int w = c.width[k];
  const uint8_t* ps = static_cast<const uint8_t*>(c.in_data[k]) + src * w;
  uint8_t* pd = static_cast<uint8_t*>(c.st_data[k]) + dst * w;
  switch (w) {
    case 1: *pd = *ps; break;
    case 2: *reinterpret_cast<uint16_t*>(pd) =
                *reinterpret_cast<const uint16_t*>(ps); break;
    case 4: *reinterpret_cast<uint32_t*>(pd) =
                *reinterpret_cast<const uint32_t*>(ps); break;
    case 8: *reinterpret_cast<uint64_t*>(pd) =
                *reinterpret_cast<const uint64_t*>(ps); break;
    default:
      for (int j = 0; j < w; ++j) pd[j] = ps[j];
  }
}

__global__ void hop_kernel(RwCols planes, const long long* __restrict__ ts,
                           long long n_out, int k, long long slide,
                           long long size, long long* __restrict__ ws,
                           long long* __restrict__ we) {
  const long long o = blockIdx.x * static_cast<long long>(blockDim.x) +
                      threadIdx.x;
  if (o >= n_out) return;
  const long long src = o / k;
  const int copy = static_cast<int>(o - src * k);
  for (int p = 0; p < planes.n; ++p) copy_plane_row(planes, p, o, src);
  const long long t = ts[src];
  const long long start = t - floor_mod(t, slide) - copy * slide;
  ws[o] = start;
  we[o] = start + size;
}

extern "C" int rw_hop_window(RwCols planes, const void* ts, long long cap,
                             int k, long long slide, long long size, void* ws,
                             void* we, void* stream) {
  const long long n_out = cap * k;
  if (n_out > 0) {
    const int threads = 256;
    const long long blocks = (n_out + threads - 1) / threads;
    hop_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                 static_cast<cudaStream_t>(stream)>>>(
        planes, static_cast<const long long*>(ts), n_out, k, slide, size,
        static_cast<long long*>(ws), static_cast<long long*>(we));
  }
  return static_cast<int>(cudaGetLastError());
}
