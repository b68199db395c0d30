// Shared helpers of the string and calendar kernels K23a-d (sm_90a).
//
// RwStr is one side of a string operation: a StrCol's [cap, width] bytes
// and its int32 lengths, row i at `data + i * stride` and
// `lens[i * lens_stride]`.  A literal passes ONE encoded row with both
// strides 0, so every row reads the same bytes and no per-chunk copy of the
// literal exists.  Bytes at and past a row's length are not read as part of
// the string: the zero padding the reference keeps there is written by the
// kernels that produce strings, never assumed by the ones that read them.
//
// rw_floor_div / rw_floor_mod are the floor division and modulo of jnp and
// torch on int64 (CUDA's / and % truncate toward zero), for divisors > 0.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

struct RwStr {
  const uint8_t* data;
  const int32_t* lens;
  long long stride;       // bytes between rows; 0 for a broadcast literal
  long long lens_stride;  // 1, or 0 for a broadcast literal
  int width;
};

__device__ __forceinline__ const uint8_t* rw_str_row(const RwStr& s,
                                                     long long i) {
  return s.data + i * s.stride;
}

__device__ __forceinline__ int rw_str_len(const RwStr& s, long long i) {
  return s.lens[i * s.lens_stride];
}

// Does the `n`-byte pattern `p` occur at `s`?
__device__ __forceinline__ bool rw_bytes_eq(const uint8_t* s,
                                            const uint8_t* p, int n) {
  for (int j = 0; j < n; ++j) {
    if (s[j] != p[j]) return false;
  }
  return true;
}

__device__ __forceinline__ long long rw_floor_div(long long x, long long m) {
  const long long q = x / m;
  return (x % m != 0 && x < 0) ? q - 1 : q;
}

__device__ __forceinline__ long long rw_floor_mod(long long x, long long m) {
  const long long r = x % m;
  return r < 0 ? r + m : r;
}

// Rows a launch of `threads` threads per block covers in one grid.
static inline unsigned rw_blocks(long long n, int threads) {
  return static_cast<unsigned>((n + threads - 1) / threads);
}
