// Kernel K2: the vnode hash of a chunk's distribution key (sm_90a).
//
// Replaces risingwave_tpu/common/hash.py `crc32_columns` (:94) and
// `compute_vnodes` (:137) with `normalize_null_col` (:32) and `_key_words`
// (:72), which XLA unrolls over the key's static byte width: a zlib-equal
// CRC32 (reflected polynomial 0xEDB88320, init and final xor 0xFFFFFFFF)
// over each row's little-endian key bytes, and vnode = crc % vnode_count.
//
// One thread per row walks the key leaves in order:
//   - an integer leaf: its `nbytes` low bytes (8 for int64 and for a bool,
//     which the reference widens to int64; 4 for int32, 2 for int16);
//   - a float32 leaf: the 4 bytes of its canonical word (subnormals and
//     -0.0 as +0.0, every NaN as 0x7FC00000: rw_common.cuh's rw_f32_word,
//     the word kernel A folds); a float64 leaf: its two float32 words
//     hi then lo (rw_f64_words);
//   - a string: its bytes up to `lens` (the padding past it is skipped; a
//     string's lengths leaf adds no byte);
//   - a nullable leaf: its payload zeroed at NULL (a NULL string has no
//     byte), then its null flag as 8 bytes (the reference widens the bool
//     flag to int64), so every NULL key lands on one vnode.
// The 256-entry table lives in shared memory, computed by each block.
//
// Bound: bytes.  A row reads its key bytes and writes a 4 B vnode (and an
// 8 B crc when asked); the byte-serial table walk is ~5 instructions a key
// byte, below the card's integer rate at these widths (8-24 B a row).
#include <cfloat>
#include <cstdint>
#include <cuda_runtime.h>

#include "rw_common.cuh"

struct RwCrcCols {
  int n;
  int width[RW_MAX_COLS];   // bytes a row holds in the leaf
  int nbytes[RW_MAX_COLS];  // bytes a row feeds the CRC (integer leaves)
  int kind[RW_MAX_COLS];    // RW_KIND_*
  const void* data[RW_MAX_COLS];
  const uint8_t* null[RW_MAX_COLS];
};

__device__ __forceinline__ uint32_t crc_byte(const uint32_t* table,
                                             uint32_t st, uint32_t b) {
  return (st >> 8) ^ table[(st ^ b) & 0xFFu];
}

__device__ __forceinline__ uint32_t crc_word(const uint32_t* table,
                                             uint32_t st, uint64_t w,
                                             int nbytes) {
  for (int k = 0; k < nbytes; ++k) {
    st = crc_byte(table, st, static_cast<uint32_t>((w >> (8 * k)) & 0xFFu));
  }
  return st;
}

__global__ void crc32_kernel(RwCrcCols c, int64_t n, int vnode_count,
                             int64_t* __restrict__ crc_out,
                             int32_t* __restrict__ vnode_out) {
  __shared__ uint32_t table[256];
  for (int t = threadIdx.x; t < 256; t += blockDim.x) {
    uint32_t v = static_cast<uint32_t>(t);
    for (int k = 0; k < 8; ++k) v = (v & 1u) ? (0xEDB88320u ^ (v >> 1)) : (v >> 1);
    table[t] = v;
  }
  __syncthreads();
  const int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (i >= n) return;
  uint32_t st = 0xFFFFFFFFu;
  for (int k = 0; k < c.n; ++k) {
    const bool has_null = c.null[k] != nullptr;
    const bool is_null = has_null && c.null[k][i] != 0;
    if (c.kind[k] == RW_KIND_STR) {
      const int w = c.width[k];
      const int32_t len =
          is_null ? 0 : static_cast<const int32_t*>(c.data[k + 1])[i];
      const uint8_t* p = static_cast<const uint8_t*>(c.data[k]) + i * w;
      for (int j = 0; j < w && j < len; ++j) st = crc_byte(table, st, p[j]);
      ++k;  // the lengths leaf adds no byte; its null plane is this one's
    } else if (c.kind[k] == RW_KIND_F32) {
      const uint32_t w =
          is_null ? 0u : rw_f32_word(static_cast<const float*>(c.data[k])[i]);
      st = crc_word(table, st, w, 4);
    } else if (c.kind[k] == RW_KIND_F64) {
      uint32_t hi = 0u, lo = 0u;
      if (!is_null) {
        rw_f64_words(static_cast<const double*>(c.data[k])[i], &hi, &lo);
      }
      st = crc_word(table, st, hi, 4);
      st = crc_word(table, st, lo, 4);
    } else {
      const uint64_t w = is_null ? 0ull : rw_load_word(c.data[k], c.width[k], i);
      st = crc_word(table, st, w, c.nbytes[k]);
    }
    if (has_null) st = crc_word(table, st, is_null ? 1ull : 0ull, 8);
  }
  const uint32_t crc = ~st;
  vnode_out[i] = static_cast<int32_t>(crc % static_cast<uint32_t>(vnode_count));
  if (crc_out != nullptr) crc_out[i] = static_cast<int64_t>(crc);
}

extern "C" int rw_crc32_vnodes(RwCrcCols cols, long long n, int vnode_count,
                               void* crc_out, void* vnode_out, void* stream) {
  if (n > 0) {
    const int threads = 256;
    const long long blocks = (n + threads - 1) / threads;
    crc32_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
        cols, n, vnode_count, static_cast<int64_t*>(crc_out),
        static_cast<int32_t*>(vnode_out));
  }
  return static_cast<int>(cudaGetLastError());
}
