// Shared helpers of the string and calendar kernels K23a-h (sm_90a).
//
// RwStr is one side of a string operation: a StrCol's [cap, width] bytes
// and its int32 lengths, row i at `data + i * stride` and
// `lens[i * lens_stride]`.  A literal passes ONE encoded row with both
// strides 0, so every row reads the same bytes and no per-chunk copy of the
// literal exists.  Bytes at and past a row's length are not read as part of
// the string: the zero padding the reference keeps there is written by the
// kernels that produce strings, never assumed by the ones that read them.
//
// RwReader reads a row's bytes through the aligned 16-byte words that hold
// them: a word is loaded once and serves every byte it holds, so a walk over
// a row's active bytes costs one 16-byte load per word it touches, whatever
// the row's alignment.  Only words that hold an active byte are loaded; such
// a word lies inside its allocation's block (the caching allocator hands out
// 512-byte-rounded, 512-byte-aligned blocks).  RwWriter writes a row in
// order, in 16-byte stores for the aligned words that lie whole inside the
// row and byte stores at its two unaligned ends (never a neighbour's byte).
// rw_next_match is the greedy walk of split_part (K23a) and replace (K23e):
// the leftmost match at or after a cursor, which the caller moves past each
// match, so matches never overlap ('aa' occurs twice in 'aaaa').
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

union RwWord {
  uint4 v;
  uint8_t b[16];
};

struct RwReader {
  const uint8_t* row;
  uintptr_t at;  // address of the loaded word; 1 (never aligned) = none
  RwWord w;

  __device__ __forceinline__ explicit RwReader(const uint8_t* r)
      : row(r), at(1) {}

  __device__ __forceinline__ uint8_t operator[](long long j) {
    const uintptr_t a = reinterpret_cast<uintptr_t>(row) + j;
    const uintptr_t base = a & ~static_cast<uintptr_t>(15);
    if (base != at) {
      w.v = __ldg(reinterpret_cast<const uint4*>(base));
      at = base;
    }
    return w.b[a & 15];
  }
};

struct RwWriter {
  uint8_t* row;
  int width;
  int pos;  // bytes written so far
  RwWord w;

  __device__ __forceinline__ RwWriter(uint8_t* r, int wd)
      : row(r), width(wd), pos(0) {}

  __device__ __forceinline__ void put(uint8_t c) {
    const uintptr_t a = reinterpret_cast<uintptr_t>(row) + pos;
    w.b[a & 15] = c;
    ++pos;
    if (((a + 1) & 15) == 0 || pos == width) flush(a);
  }

  // the word holding byte address `last` is complete up to `last`
  __device__ __forceinline__ void flush(uintptr_t last) {
    const uintptr_t base = last & ~static_cast<uintptr_t>(15);
    const uintptr_t lo = reinterpret_cast<uintptr_t>(row);
    if (base >= lo && base + 16 <= lo + width) {
      *reinterpret_cast<uint4*>(base) = w.v;
      return;
    }
    for (uintptr_t x = base < lo ? lo : base; x <= last; ++x) {
      row[x - lo] = w.b[x & 15];
    }
  }

  // zeros from the current position to the end of the row
  __device__ __forceinline__ void finish() {
    while (pos < width) put(0);
  }
};

// Do the first `n` bytes of `p` occur in `s` at byte `off`?
__device__ __forceinline__ bool rw_eq_at(RwReader& s, int off, RwReader& p,
                                         int n) {
  for (int j = 0; j < n; ++j) {
    if (s[off + j] != p[j]) return false;
  }
  return true;
}

// The offset of the leftmost match of the `n`-byte pattern `p` in
// `s[from, ls)`, or -1 (an empty pattern matches at `from`).
__device__ __forceinline__ int rw_next_match(RwReader& s, int ls,
                                             RwReader& p, int n, int from) {
  for (int b = from; b + n <= ls; ++b) {
    if (rw_eq_at(s, b, p, n)) return b;
  }
  return -1;
}

// int64 + and - that wrap as jnp's and torch's do (no signed overflow)
__device__ __forceinline__ long long rw_wrap_add(long long a, long long b) {
  return static_cast<long long>(static_cast<unsigned long long>(a) +
                                static_cast<unsigned long long>(b));
}

__device__ __forceinline__ long long rw_wrap_sub(long long a, long long b) {
  return static_cast<long long>(static_cast<unsigned long long>(a) -
                                static_cast<unsigned long long>(b));
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
