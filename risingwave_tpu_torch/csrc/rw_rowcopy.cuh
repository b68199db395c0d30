// Plane-wise row copies in the widest word, shared by K8-ring
// (compact.cu), K16 (topn_pool.cu) and K22b (sink_ring.cu).
//
// A row is a list of planes: each fixed-width leaf of an RwCols (a
// column's payload, a string's [cap, W] bytes and its int32 lengths) and
// each leaf's uint8 null plane.  A plane moves in 16-, 8-, 4-, 2- or 1-byte
// words, the widest that divides its row width and both base pointers, so
// that a warp reads and writes consecutive words of one plane: a 176-byte
// row of q22 is eleven 16-byte words, where a per-row copy would read it a
// byte at a time with a stride of the row width between a warp's threads.
#pragma once

#include <cstdint>

#include "rw_common.cuh"

#define RW_MAX_PLANES (2 * RW_MAX_COLS)

struct RwPlanes {
  int n;
  int words[RW_MAX_PLANES];  // words a row holds in this plane
  int wb[RW_MAX_PLANES];     // bytes a word: 16, 8, 4, 2 or 1
  const void* src[RW_MAX_PLANES];
  void* dst[RW_MAX_PLANES];
};

// The widest word (16, 8, 4, 2 or 1 bytes) that divides `width` and both
// pointers.
__host__ __device__ __forceinline__ int rw_word_bytes(int width,
                                                      const void* a,
                                                      const void* b) {
  const unsigned long long m = static_cast<unsigned long long>(width) |
                               reinterpret_cast<uintptr_t>(a) |
                               reinterpret_cast<uintptr_t>(b);
  for (int w = 16; w > 1; w >>= 1) {
    if ((m & static_cast<unsigned long long>(w - 1)) == 0) return w;
  }
  return 1;
}

template <typename W>
__device__ __forceinline__ void rw_copy_as(const void* src, void* dst,
                                           long long from, long long to) {
  static_cast<W*>(dst)[to] = static_cast<const W*>(src)[from];
}

// Word `from` of src to word `to` of dst, words of `wb` bytes.
__device__ __forceinline__ void rw_copy_word(const void* src, void* dst,
                                             long long from, long long to,
                                             int wb) {
  switch (wb) {
    case 16: rw_copy_as<uint4>(src, dst, from, to); break;
    case 8: rw_copy_as<uint64_t>(src, dst, from, to); break;
    case 4: rw_copy_as<uint32_t>(src, dst, from, to); break;
    case 2: rw_copy_as<uint16_t>(src, dst, from, to); break;
    default: rw_copy_as<uint8_t>(src, dst, from, to); break;
  }
}

// The planes of an RwCols, input side to store side: every leaf, then its
// null plane where the store has one.
__device__ __forceinline__ void rw_planes_of(const RwCols& c, RwPlanes& p) {
  int n = 0;
  for (int k = 0; k < c.n; ++k) {
    const int w = c.width[k];
    const int wb = rw_word_bytes(w, c.in_data[k], c.st_data[k]);
    p.words[n] = w / wb;
    p.wb[n] = wb;
    p.src[n] = c.in_data[k];
    p.dst[n] = c.st_data[k];
    ++n;
    if (c.st_null[k] != nullptr) {
      p.words[n] = 1;
      p.wb[n] = 1;
      p.src[n] = c.in_null[k];
      p.dst[n] = c.st_null[k];
      ++n;
    }
  }
  p.n = n;
}

// Copy `n` rows, row i from source row src_of(i) to store row dst_of(i),
// plane after plane.  The threads t, t + nt, t + 2 nt, ... of the caller
// take the (row, word) items of a plane in turn, so consecutive threads
// move consecutive words.  A plane's items (n x words) stay below 2^31.
template <typename SrcOf, typename DstOf>
__device__ __forceinline__ void rw_copy_rows(const RwPlanes& p, int n,
                                             SrcOf src_of, DstOf dst_of,
                                             unsigned t, unsigned nt) {
  for (int k = 0; k < p.n; ++k) {
    const unsigned words = static_cast<unsigned>(p.words[k]);
    const int wb = p.wb[k];
    const unsigned items = static_cast<unsigned>(n) * words;
    for (unsigned f = t; f < items; f += nt) {
      const unsigned i = f / words;
      const unsigned j = f - i * words;
      rw_copy_word(p.src[k], p.dst[k],
                   static_cast<long long>(src_of(static_cast<int>(i))) *
                           words + j,
                   static_cast<long long>(dst_of(static_cast<int>(i))) *
                           words + j,
                   wb);
    }
  }
}
