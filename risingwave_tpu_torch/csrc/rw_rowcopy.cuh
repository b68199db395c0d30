// Plane-wise row copies in the widest word, shared by K8-ring
// (compact.cu), K16 (topn_pool.cu), K22b (sink_ring.cu), and in their
// gather form (rw_gather_plane) by K18 (topn_flush.cu) and K20
// (over_window.cu).
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

// The widest word that divides `width` and the three pointers (`c` may be
// null).
__host__ __device__ __forceinline__ int rw_word_bytes3(int width,
                                                       const void* a,
                                                       const void* b,
                                                       const void* c) {
  return rw_word_bytes(width, a,
                       reinterpret_cast<const void*>(
                           reinterpret_cast<uintptr_t>(b) |
                           reinterpret_cast<uintptr_t>(c)));
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


template <typename W, typename SrcOf>
__device__ __forceinline__ void rw_gather_as(const W* src, W* dst, W* dst2,
                                             int words, int n, SrcOf src_of,
                                             unsigned t, unsigned nt) {
  const unsigned items = static_cast<unsigned>(n) *
                         static_cast<unsigned>(words);
  for (unsigned f = t; f < items; f += nt) {
    const unsigned i = f / static_cast<unsigned>(words);
    const unsigned j = f - i * static_cast<unsigned>(words);
    const W w = src[static_cast<long long>(src_of(static_cast<int>(i))) *
                        words + j];
    const long long d = static_cast<long long>(i) * words + j;
    dst[d] = w;
    if (dst2 != nullptr) dst2[d] = w;
  }
}

// The gather form: rows i < n of one plane of `width` bytes a row, row i
// of `dst` (and of `dst2` where it is not null) from row src_of(i) of
// `src`, in the widest word that divides the width and the three
// pointers.  `dst` and `dst2` point at the first row written; the threads
// t, t + nt, ... take the (row, word) items in turn, so consecutive
// threads move consecutive words.  A contiguous copy is the gather with
// src_of(i) = i.  n x words stays below 2^31.
template <typename SrcOf>
__device__ __forceinline__ void rw_gather_plane(const void* src, void* dst,
                                                void* dst2, int width, int n,
                                                SrcOf src_of, unsigned t,
                                                unsigned nt) {
  if (n <= 0) return;
  const int wb = rw_word_bytes3(width, src, dst, dst2);
  const int words = width / wb;
  switch (wb) {
    case 16:
      rw_gather_as(static_cast<const uint4*>(src), static_cast<uint4*>(dst),
                   static_cast<uint4*>(dst2), words, n, src_of, t, nt);
      break;
    case 8:
      rw_gather_as(static_cast<const uint64_t*>(src),
                   static_cast<uint64_t*>(dst), static_cast<uint64_t*>(dst2),
                   words, n, src_of, t, nt);
      break;
    case 4:
      rw_gather_as(static_cast<const uint32_t*>(src),
                   static_cast<uint32_t*>(dst), static_cast<uint32_t*>(dst2),
                   words, n, src_of, t, nt);
      break;
    case 2:
      rw_gather_as(static_cast<const uint16_t*>(src),
                   static_cast<uint16_t*>(dst), static_cast<uint16_t*>(dst2),
                   words, n, src_of, t, nt);
      break;
    default:
      rw_gather_as(static_cast<const uint8_t*>(src),
                   static_cast<uint8_t*>(dst), static_cast<uint8_t*>(dst2),
                   words, n, src_of, t, nt);
  }
}

// One row of `width` bytes from `src` (null: zeros) to `dst` and `dst2`
// by a single thread, in the widest word that divides the width and the
// pointers.
__device__ __forceinline__ void rw_row_words(const void* src, void* dst,
                                             void* dst2, int width) {
  const int wb = rw_word_bytes3(width, src, dst, dst2);
  const int words = width / wb;
  for (int j = 0; j < words; ++j) {
    switch (wb) {
      case 16: {
        const uint4 z = make_uint4(0u, 0u, 0u, 0u);
        const uint4 w = src ? static_cast<const uint4*>(src)[j] : z;
        static_cast<uint4*>(dst)[j] = w;
        static_cast<uint4*>(dst2)[j] = w;
        break;
      }
      case 8: {
        const uint64_t w = src ? static_cast<const uint64_t*>(src)[j] : 0ull;
        static_cast<uint64_t*>(dst)[j] = w;
        static_cast<uint64_t*>(dst2)[j] = w;
        break;
      }
      case 4: {
        const uint32_t w = src ? static_cast<const uint32_t*>(src)[j] : 0u;
        static_cast<uint32_t*>(dst)[j] = w;
        static_cast<uint32_t*>(dst2)[j] = w;
        break;
      }
      case 2: {
        const uint16_t w = src ? static_cast<const uint16_t*>(src)[j] : 0;
        static_cast<uint16_t*>(dst)[j] = w;
        static_cast<uint16_t*>(dst2)[j] = w;
        break;
      }
      default: {
        const uint8_t w = src ? static_cast<const uint8_t*>(src)[j] : 0;
        static_cast<uint8_t*>(dst)[j] = w;
        static_cast<uint8_t*>(dst2)[j] = w;
      }
    }
  }
}
