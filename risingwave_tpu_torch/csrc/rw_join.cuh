// Shared pieces of the join kernels (join_update.cu, join_emit.cu,
// join_clean.cu): the column-leaf descriptor and block-wide scans.
//
// JoinCols lists up to RW_JOIN_LEAVES fixed-width leaves: an int64 or
// int32 payload, a string's [n, w] bytes, its int32 lengths, or a null
// plane (one byte a row).  Leaf k moves `width[k]` bytes a row from `src[k]`
// to `dst[k]`; `from_probe[k]` tells the emission kernel whether its source
// row is the probe row or the build side's row.  `pad[k]` marks an output
// null plane of the emission (1 byte a row): 1 ORs the row's "transition"
// flag into it (a probe-side column padded on up/down rows), 2 its "self"
// flag (a build-side column padded on self rows); its `src` may be null
// (a column that is not nullable on its input).
#pragma once

#include <cstdint>

#define RW_JOIN_LEAVES 32

struct JoinCols {
  int n;
  int width[RW_JOIN_LEAVES];
  int from_probe[RW_JOIN_LEAVES];
  int pad[RW_JOIN_LEAVES];
  const void* src[RW_JOIN_LEAVES];
  void* dst[RW_JOIN_LEAVES];
};

// Copy `w` bytes of row `s` of `src` to row `d` of `dst` (8- or 4-byte
// words where the width allows; the tensors are allocated aligned).
__device__ __forceinline__ void rw_copy_row(void* dst, long long d,
                                            const void* src, long long s,
                                            int w) {
  if ((w & 7) == 0) {
    const uint64_t* ps = static_cast<const uint64_t*>(src) + s * (w >> 3);
    uint64_t* pd = static_cast<uint64_t*>(dst) + d * (w >> 3);
    for (int j = 0; j < (w >> 3); ++j) pd[j] = ps[j];
  } else if ((w & 3) == 0) {
    const uint32_t* ps = static_cast<const uint32_t*>(src) + s * (w >> 2);
    uint32_t* pd = static_cast<uint32_t*>(dst) + d * (w >> 2);
    for (int j = 0; j < (w >> 2); ++j) pd[j] = ps[j];
  } else {
    const uint8_t* ps = static_cast<const uint8_t*>(src) + s * w;
    uint8_t* pd = static_cast<uint8_t*>(dst) + d * w;
    for (int j = 0; j < w; ++j) pd[j] = ps[j];
  }
}

struct RwSum {
  __device__ __forceinline__ int operator()(int a, int b) const {
    return a + b;
  }
  static constexpr int identity = 0;
};

struct RwMax {
  __device__ __forceinline__ int operator()(int a, int b) const {
    return a > b ? a : b;
  }
  static constexpr int identity = -1;
};

// Block-wide exclusive scan of one value per thread (any block size that
// is a multiple of 32, up to 1024).  Every thread of the block must call
// it; `total` receives the reduction of all values.
template <typename Op>
__device__ __forceinline__ int rw_block_exclusive_scan(int v, int* total) {
  __shared__ int warp_part[32];
  Op op;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  int incl = v;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl = op(incl, y);
  }
  if (lane == 31) warp_part[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int x = lane < nwarps ? warp_part[lane] : Op::identity;
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, x, o);
      if (lane >= o) x = op(x, y);
    }
    warp_part[lane] = x;  // inclusive over warps
  }
  __syncthreads();
  const int prev = __shfl_up_sync(0xffffffffu, incl, 1);
  int excl = lane == 0 ? Op::identity : prev;
  if (warp > 0) excl = op(warp_part[warp - 1], excl);
  *total = warp_part[nwarps - 1];
  __syncthreads();
  return excl;
}
