// The two passes of the order-preserving mask compaction, shared by K7
// (compact.cu `rw_mask_indices`) and K7e (agg_eowc.cu): the ascending
// indices of up to k set bits of an [n] mask, `fill` past the last one.
// The mask is a functor `bits(i)`, so a caller may compute each bit where
// it is read instead of storing the mask first.  Tiles of MI_TILE bits:
//   1. rw_mi_count: each block counts its tile's set bits;
//   2. rw_mi_write: each block sums the counts of the tiles before it,
//      scans its own tile (warp shuffles + one shared array) and writes the
//      indices whose rank is below k; every block also fills its share of
//      the positions [total, k) with `fill`, and block 0 writes the total
//      count to `total_out` when it is given.
#pragma once

#include <cstdint>

static constexpr int MI_THREADS = 256;
static constexpr int MI_ITEMS = 4;
static constexpr int MI_TILE = MI_THREADS * MI_ITEMS;

// Exclusive prefix sum of one int per thread over the block; `total`
// receives the block's sum.  Every thread of the block must call it.
__device__ __forceinline__ int block_exclusive_scan(int v, int& total) {
  __shared__ int warp_tot[32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = (blockDim.x + 31) >> 5;
  int x = v;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_tot[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = lane < n_warps ? warp_tot[lane] : 0;
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += y;
    }
    if (lane < n_warps) warp_tot[lane] = w;
  }
  __syncthreads();
  const int excl = x - v + (warp > 0 ? warp_tot[warp - 1] : 0);
  total = warp_tot[n_warps - 1];
  __syncthreads();  // warp_tot is reused by the next call
  return excl;
}

template <typename Bits>
__device__ __forceinline__ void rw_mi_count(Bits bits, int n,
                                            int* __restrict__ counts) {
  const int base = blockIdx.x * MI_TILE + threadIdx.x * MI_ITEMS;
  int c = 0;
  for (int j = 0; j < MI_ITEMS; ++j) {
    const int i = base + j;
    c += (i < n && bits(i)) ? 1 : 0;
  }
  int total;
  block_exclusive_scan(c, total);
  if (threadIdx.x == 0) counts[blockIdx.x] = total;
}

template <typename Bits>
__device__ __forceinline__ void rw_mi_write(Bits bits, int n, int n_tiles,
                                            const int* __restrict__ counts,
                                            int k, int fill,
                                            int* __restrict__ out,
                                            long long* total_out) {
  // rank of this tile's first set bit, and the mask's total count
  int before = 0, all = 0;
  for (int b = threadIdx.x; b < n_tiles; b += blockDim.x) {
    const int c = counts[b];
    all += c;
    if (b < static_cast<int>(blockIdx.x)) before += c;
  }
  int tile_base, total;  // block sums of `before` and `all`
  block_exclusive_scan(before, tile_base);
  block_exclusive_scan(all, total);
  if (total_out != nullptr && blockIdx.x == 0 && threadIdx.x == 0) {
    *total_out = total;
  }

  const int base = blockIdx.x * MI_TILE + threadIdx.x * MI_ITEMS;
  uint8_t b8[MI_ITEMS];
  int c = 0;
  for (int j = 0; j < MI_ITEMS; ++j) {
    const int i = base + j;
    b8[j] = (i < n && bits(i)) ? 1 : 0;
    c += b8[j];
  }
  int tile_total;
  int pos = tile_base + block_exclusive_scan(c, tile_total);
  for (int j = 0; j < MI_ITEMS; ++j) {
    if (b8[j]) {
      if (pos < k) out[pos] = base + j;
      ++pos;
    }
  }
  for (int j = total + blockIdx.x * blockDim.x + threadIdx.x; j < k;
       j += gridDim.x * blockDim.x) {
    out[j] = fill;
  }
}
