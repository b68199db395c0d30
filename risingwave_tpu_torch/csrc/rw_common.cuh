// Shared device helpers of the port's CUDA kernels (sm_90a).
//
// RwCols describes up to RW_MAX_COLS fixed-width columns: for column k,
// `width[k]` bytes per row, the input rows `in_data[k]` (a chunk's key or
// value column), an optional store `st_data[k]` (a table's key store or an
// MV value column) and optional uint8 null planes.  A StrCol passes as two
// columns (its [cap, w] bytes and its int32 lens), an NCol as its payload
// with the null plane beside it.  The struct is passed by value, so a kernel
// reads the descriptor from its parameter space.
//
// `kind[k]` marks a StrCol key for the hash: RW_KIND_STR on its bytes
// column k (then column k+1 holds its lens, RW_KIND_LENS); RW_KIND_F32 and
// RW_KIND_F64 on float columns; RW_KIND_WORD (0, the zero fill of an unset
// descriptor) on every other fixed-width column.  Row copies need no kind,
// and equality only the float kinds: every other column compares every
// byte, a string's padding past `lens` included.
//
// Float keys hash and compare as the reference does under XLA's CPU
// runtime, which runs with denormals-are-zero and flush-to-zero set:
//   - a subnormal input counts as zero, so -0.0, +0.0 and every subnormal
//     hash as +0.0 and compare equal; NaN hashes as 0x7FC00000 and equals
//     nothing (IEEE ==);
//   - float32 folds the bits of the value;
//   - float64 folds two float32 words, double-double style: hi = f32(x),
//     lo = f32(x - f64(hi)), each rounded to nearest and a subnormal result
//     flushed to a zero of its sign; for an infinite x, lo is the x86
//     default NaN of inf - inf narrowed (0xFFC00000).
//
// rw_mix64 / rw_hash_row are the device copy of the reference's 64-bit key
// hash (risingwave_tpu/common/hash.py `_mix64`, `hash64_columns`,
// `_hash64_one`): a splitmix64 fold of each key word, words zero-extended to
// 64 bits, a string folded as 8-byte little-endian words with the bytes at
// and past its length masked to 0 and then its length, a nullable column
// folded as [payload-with-nulls-zeroed, null flag], and the all-ones result
// remapped to ~1.
#pragma once

#include <cfloat>
#include <cstdint>
#include <cuda_runtime.h>

#define RW_MAX_COLS 16
#define RW_KIND_WORD 0
#define RW_KIND_STR 1
#define RW_KIND_LENS 2
#define RW_KIND_F32 3
#define RW_KIND_F64 4

struct RwCols {
  int n;
  int width[RW_MAX_COLS];
  const void* in_data[RW_MAX_COLS];
  const uint8_t* in_null[RW_MAX_COLS];
  void* st_data[RW_MAX_COLS];
  uint8_t* st_null[RW_MAX_COLS];
  int kind[RW_MAX_COLS];
};

static constexpr uint64_t RW_K1 = 0x9E3779B97F4A7C15ull;
static constexpr uint64_t RW_K2 = 0xBF58476D1CE4E5B9ull;
static constexpr uint64_t RW_K3 = 0x94D049BB133111EBull;

__device__ __forceinline__ uint64_t rw_mix64(uint64_t x) {
  x = (x ^ (x >> 30)) * RW_K2;
  x = (x ^ (x >> 27)) * RW_K3;
  return x ^ (x >> 31);
}

// One fixed-width value, zero-extended to 64 bits (the reference views
// int16/int32 as uint16/uint32 before widening, and bool as 0/1).
__device__ __forceinline__ uint64_t rw_load_word(const void* base, int width,
                                                 int64_t i) {
  switch (width) {
    case 1: return static_cast<const uint8_t*>(base)[i];
    case 2: return static_cast<const uint16_t*>(base)[i];
    case 4: return static_cast<const uint32_t*>(base)[i];
    default: return static_cast<const uint64_t*>(base)[i];
  }
}

// Fold a string of `w` bytes at `p` with length `len` (bytes at and past
// `len` read as 0) into the mix state, then its length.
__device__ __forceinline__ uint64_t rw_fold_str(uint64_t st,
                                                const uint8_t* p, int w,
                                                int32_t len) {
  for (int j = 0; j < w; j += 8) {
    uint64_t word = 0;
    for (int b = 0; b < 8 && j + b < w; ++b) {
      if (j + b < len) word |= static_cast<uint64_t>(p[j + b]) << (8 * b);
    }
    st = rw_mix64(st ^ (word * RW_K1));
  }
  return rw_mix64(st ^ static_cast<uint64_t>(static_cast<int64_t>(len)));
}

// rw_fold_str read in 8-byte words where the row and its width are
// 8-byte aligned (the bytes at and past `len` masked), else a byte at a
// time: the same value either way.
__device__ __forceinline__ uint64_t rw_fold_str_words(uint64_t st,
                                                      const uint8_t* p,
                                                      int w, int32_t len) {
  if (((reinterpret_cast<uintptr_t>(p) | static_cast<uintptr_t>(w)) & 7) !=
      0) {
    return rw_fold_str(st, p, w, len);
  }
  const uint64_t* q = reinterpret_cast<const uint64_t*>(p);
  for (int j = 0; j < w; j += 8) {
    uint64_t word = 0;
    if (len >= j + 8) {
      word = q[j >> 3];
    } else if (len > j) {
      word = q[j >> 3] & ((1ull << (8 * (len - j))) - 1ull);
    }
    st = rw_mix64(st ^ (word * RW_K1));
  }
  return rw_mix64(st ^ static_cast<uint64_t>(static_cast<int64_t>(len)));
}

// A float32 key's word: subnormals and -0.0 as +0.0, NaN as one NaN.
__device__ __forceinline__ uint32_t rw_f32_word(float x) {
  if (isnan(x)) return 0x7FC00000u;
  if (fabsf(x) < FLT_MIN) return 0u;
  return __float_as_uint(x);
}

// The bits of a float32 result with a subnormal flushed to a signed zero.
__device__ __forceinline__ uint32_t rw_ftz_bits(float f) {
  const uint32_t u = __float_as_uint(f);
  return (u & 0x7F800000u) == 0u ? (u & 0x80000000u) : u;
}

// A float64 key's two words (hi, lo).
__device__ __forceinline__ void rw_f64_words(double x, uint32_t* hi,
                                             uint32_t* lo) {
  if (isnan(x)) {
    *hi = *lo = 0x7FC00000u;
    return;
  }
  if (isinf(x)) {
    *hi = x > 0.0 ? 0x7F800000u : 0xFF800000u;
    *lo = 0xFFC00000u;
    return;
  }
  if (fabs(x) < DBL_MIN) x = 0.0;
  *hi = rw_ftz_bits(__double2float_rn(x));
  const double r = x - static_cast<double>(__uint_as_float(*hi));
  *lo = rw_ftz_bits(__double2float_rn(r));
}

__device__ __forceinline__ uint64_t rw_hash_row(const RwCols& c, int64_t i) {
  uint64_t st = RW_K1;  // seed 0 ^ K1
  for (int k = 0; k < c.n; ++k) {
    const bool is_null = c.in_null[k] != nullptr && c.in_null[k][i] != 0;
    if (c.kind[k] == RW_KIND_STR) {
      const int w = c.width[k];
      const int32_t len =
          is_null ? 0 : static_cast<const int32_t*>(c.in_data[k + 1])[i];
      st = rw_fold_str(st, static_cast<const uint8_t*>(c.in_data[k]) + i * w,
                       w, len);
      ++k;  // the lens column is folded
    } else if (c.kind[k] == RW_KIND_F32) {
      const uint32_t w =
          is_null ? 0u
                  : rw_f32_word(static_cast<const float*>(c.in_data[k])[i]);
      st = rw_mix64(st ^ (static_cast<uint64_t>(w) * RW_K1));
    } else if (c.kind[k] == RW_KIND_F64) {
      uint32_t hi = 0u, lo = 0u;
      if (!is_null) {
        rw_f64_words(static_cast<const double*>(c.in_data[k])[i], &hi, &lo);
      }
      st = rw_mix64(st ^ (static_cast<uint64_t>(hi) * RW_K1));
      st = rw_mix64(st ^ (static_cast<uint64_t>(lo) * RW_K1));
    } else {
      const uint64_t w =
          is_null ? 0ull : rw_load_word(c.in_data[k], c.width[k], i);
      st = rw_mix64(st ^ (w * RW_K1));
    }
    if (c.in_null[k] != nullptr) {
      st = rw_mix64(st ^ (static_cast<uint64_t>(is_null) * RW_K1));
    }
  }
  return st == ~0ull ? ~1ull : st;
}

// A float with a subnormal read as zero (the reference's compares run
// with denormals-are-zero).
__device__ __forceinline__ float rw_daz(float x) {
  return fabsf(x) < FLT_MIN ? 0.0f : x;
}
__device__ __forceinline__ double rw_daz(double x) {
  return fabs(x) < DBL_MIN ? 0.0 : x;
}

// Equality of row `a` of column k's store and row `b` of its input: IEEE
// == on float kinds (subnormals as zero), every byte on the others.
__device__ __forceinline__ bool rw_value_equal(const RwCols& c, int k,
                                               int64_t a, int64_t b) {
  if (c.kind[k] == RW_KIND_F32) {
    return rw_daz(static_cast<const float*>(c.st_data[k])[a]) ==
           rw_daz(static_cast<const float*>(c.in_data[k])[b]);
  }
  if (c.kind[k] == RW_KIND_F64) {
    return rw_daz(static_cast<const double*>(c.st_data[k])[a]) ==
           rw_daz(static_cast<const double*>(c.in_data[k])[b]);
  }
  const int w = c.width[k];
  const uint8_t* pa = static_cast<const uint8_t*>(c.st_data[k]) + a * w;
  const uint8_t* pb = static_cast<const uint8_t*>(c.in_data[k]) + b * w;
  switch (w) {
    case 1: return *pa == *pb;
    case 2: return *reinterpret_cast<const uint16_t*>(pa) ==
                   *reinterpret_cast<const uint16_t*>(pb);
    case 4: return *reinterpret_cast<const uint32_t*>(pa) ==
                   *reinterpret_cast<const uint32_t*>(pb);
    case 8: return *reinterpret_cast<const uint64_t*>(pa) ==
                   *reinterpret_cast<const uint64_t*>(pb);
    default:
      for (int j = 0; j < w; ++j) {
        if (pa[j] != pb[j]) return false;
      }
      return true;
  }
}

// Grouping equality of a stored key and an input key (NULL == NULL), as
// risingwave_tpu/state/hash_table.py `_keys_equal`.
__device__ __forceinline__ bool rw_keys_equal(const RwCols& c, int64_t slot,
                                              int64_t row) {
  for (int k = 0; k < c.n; ++k) {
    bool eq = rw_value_equal(c, k, slot, row);
    if (c.st_null[k] != nullptr) {
      const bool an = c.st_null[k][slot] != 0;
      const bool bn = c.in_null[k][row] != 0;
      eq = (an && bn) || (!an && !bn && eq);
    }
    if (!eq) return false;
  }
  return true;
}

// Copy row `src` of every input column into row `dst` of its store.
__device__ __forceinline__ void rw_store_row(const RwCols& c, int64_t dst,
                                             int64_t src) {
  for (int k = 0; k < c.n; ++k) {
    const int w = c.width[k];
    uint8_t* pd = static_cast<uint8_t*>(c.st_data[k]) + dst * w;
    const uint8_t* ps = static_cast<const uint8_t*>(c.in_data[k]) + src * w;
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
    if (c.st_null[k] != nullptr) c.st_null[k][dst] = c.in_null[k][src];
  }
}

// The split hash of risingwave_tpu/common/hash.py (`hash64_partial` :203,
// `hash64_extend` :222, `hash64_finish` :230) for one int64 key-hash column
// extended by an int32 rank (zero-extended, as the reference views int32 as
// uint32), and the join's pair tag (state/hash_table.py `pair_tag` :387,
// `finish_tag` :396): the finished hash moved off the EMPTY (0) and TOMB (1)
// tag values.
__device__ __forceinline__ uint64_t rw_hash_partial1(uint64_t h) {
  return rw_mix64(RW_K1 ^ (h * RW_K1));
}

__device__ __forceinline__ uint64_t rw_hash_extend_u32(uint64_t st,
                                                       uint32_t w) {
  return rw_mix64(st ^ (static_cast<uint64_t>(w) * RW_K1));
}

__device__ __forceinline__ uint64_t rw_hash_finish(uint64_t st) {
  return st == ~0ull ? ~1ull : st;
}

__device__ __forceinline__ uint64_t rw_tag_of(uint64_t partial, int rank) {
  const uint64_t raw =
      rw_hash_finish(rw_hash_extend_u32(partial, static_cast<uint32_t>(rank)));
  return raw < 2ull ? raw + 2ull : raw;
}

__device__ __forceinline__ uint64_t rw_pair_tag(uint64_t h, int rank) {
  return rw_tag_of(rw_hash_partial1(h), rank);
}

static constexpr uint64_t RW_EMPTY_TAG = 0ull;
static constexpr uint64_t RW_TOMB_TAG = 1ull;

// The vnode of one integer key (risingwave_tpu/cluster/scale/vnode.py
// `vnodes_of_ints` :29): the key sign-extended to int64, hashed as
// hash64_columns([key]) does (rw_hash_row over one 8-byte column is
// rw_hash_finish(rw_hash_partial1(key))), then the unsigned 64-bit hash
// mod n_vnodes.  The gate (K25) and the vnode sweep (K26) both call it.
__device__ __forceinline__ int64_t rw_load_int(const void* base, int width,
                                               int64_t i) {
  switch (width) {
    case 1: return static_cast<const int8_t*>(base)[i];
    case 2: return static_cast<const int16_t*>(base)[i];
    case 4: return static_cast<const int32_t*>(base)[i];
    default: return static_cast<const int64_t*>(base)[i];
  }
}

__device__ __forceinline__ int rw_vnode_of_int(int64_t key, int n_vnodes) {
  const uint64_t h =
      rw_hash_finish(rw_hash_partial1(static_cast<uint64_t>(key)));
  return static_cast<int>(h % static_cast<uint64_t>(n_vnodes));
}

// Adds `v` summed over the block into *dst: a warp shuffle sum, then one
// 64-bit atomicAdd per block (integer adds: exact in any order).  Every
// thread of the block must call it (it synchronises the block).
__device__ __forceinline__ void rw_block_sum_add(int v,
                                                 unsigned long long* dst) {
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_down_sync(0xffffffffu, v, off);
  }
  __shared__ int warp_sums[32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = v;
  __syncthreads();
  if (warp == 0) {
    const int n_warps = (blockDim.x + 31) >> 5;
    int s = lane < n_warps ? warp_sums[lane] : 0;
    for (int off = 16; off > 0; off >>= 1) {
      s += __shfl_down_sync(0xffffffffu, s, off);
    }
    if (lane == 0 && s != 0) {
      atomicAdd(dst, static_cast<unsigned long long>(s));
    }
  }
}
