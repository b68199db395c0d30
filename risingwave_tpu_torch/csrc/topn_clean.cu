// K19a: watermark cleaning of a top-N row pool and its emitted band
// (sm_90a).
//
// Replaces risingwave_tpu/stream/top_n.py `GroupTopNExecutor.clean_below`
// (top_n.py:418), which the over-window's `on_watermark` also calls
// (over_window.py:366): every pool row and every emitted-band row whose
// watermark column is below the threshold leaves, `valid &= ~(col < thr)`
// on the pool's S rows and the band's E rows.
//
// The column is a signed integer of 1, 2, 4 or 8 bytes (an event time);
// the threshold is an int64 device scalar (the watermark minus its lag), so
// the host never reads it.  One launch, one thread per row of either side.
//
// Bound: bytes.  Per row it reads the column (8 B) and the flag (1 B) and
// may write the flag: ~9 B/row, ~2.9 MB at S = 2^18 and E = 2^16, under a
// microsecond of HBM time; the launch costs more.
#include <cstdint>
#include <cuda_runtime.h>

struct TopnCleanArgs {
  const void* col;        // [S] the pool's watermark column
  uint8_t* valid;         // [S] in place
  const void* prev_col;   // [E] the band's watermark column
  uint8_t* prev_valid;    // [E] in place
  const long long* thr;   // [1] the threshold
  int width;              // bytes per value
  int S;
  int E;
};

__device__ __forceinline__ long long load_signed(const void* base, int width,
                                                 long long i) {
  switch (width) {
    case 1: return static_cast<const int8_t*>(base)[i];
    case 2: return static_cast<const int16_t*>(base)[i];
    case 4: return static_cast<const int32_t*>(base)[i];
    default: return static_cast<const long long*>(base)[i];
  }
}

__global__ void topn_clean_kernel(TopnCleanArgs a) {
  const long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                      threadIdx.x;
  const long long thr = *a.thr;
  if (i < a.S) {
    if (a.valid[i] && load_signed(a.col, a.width, i) < thr) a.valid[i] = 0;
  } else if (i < static_cast<long long>(a.S) + a.E) {
    const long long j = i - a.S;
    if (a.prev_valid[j] && load_signed(a.prev_col, a.width, j) < thr) {
      a.prev_valid[j] = 0;
    }
  }
}

extern "C" int rw_topn_clean(TopnCleanArgs args, void* stream) {
  const long long n = static_cast<long long>(args.S) + args.E;
  if (n > 0) {
    const int threads = 256;
    topn_clean_kernel<<<static_cast<unsigned>((n + threads - 1) / threads),
                        threads, 0, static_cast<cudaStream_t>(stream)>>>(
        args);
  }
  return static_cast<int>(cudaGetLastError());
}
