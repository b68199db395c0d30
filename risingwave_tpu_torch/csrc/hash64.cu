// Kernel A: 64-bit key hash of a chunk (sm_90a).
//
// Replaces risingwave_tpu/common/hash.py `hash64_columns` / `_mix64`
// (hash.py:183, :160), which XLA fuses into the agg and MV probe programs.
//
// Work: one thread per row folds each fixed-width key column (and its null
// plane) through the splitmix64 mix in uint64_t, remaps ~0 to ~1, and writes
// the hash; when `slot` is given it also writes `h & mask`, the row's first
// probe slot in a power-of-two table.
//
// Bound: bytes.  Per row it reads the key words (8 B per int64 key) and
// writes 8 B (+4 B of slot); three multiplies per word are far below the
// card's integer rate.  At 8192 rows that is ~130 KB, well under the launch
// latency, so the design is the plainest coalesced one-thread-per-row map.
#include "rw_common.cuh"

__global__ void hash64_kernel(RwCols cols, int64_t n, uint64_t* __restrict__ out,
                              int32_t* __restrict__ slot, uint64_t mask) {
  const int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (i >= n) return;
  const uint64_t h = rw_hash_row(cols, i);
  out[i] = h;
  if (slot != nullptr) slot[i] = static_cast<int32_t>(h & mask);
}

extern "C" int rw_hash64(RwCols cols, long long n, void* out, void* slot,
                         unsigned long long mask, void* stream) {
  if (n > 0) {
    const int threads = 256;
    const long long blocks = (n + threads - 1) / threads;
    hash64_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
        cols, n, static_cast<uint64_t*>(out), static_cast<int32_t*>(slot),
        mask);
  }
  return static_cast<int>(cudaGetLastError());
}
