// The claim rounds' shared pieces (sm_90a), of probe.cu (K3) and
// tag_probe.cu's ranked insert (K12): the claim scratch's free mark and
// control words, the warp and block reductions, the claimant list's append
// and block 0's claim map in shared memory.
//
// The claim scratch (one per device and stream, cached by the wrapper) is
// 4 * cap entries at RW_CLAIM_FREE, above every row index, followed by 16
// control words.  Every call leaves the words it reads before writing at
// their rest values (the wrapper's `_CTL_REST`): K3 and K12 share the
// scratch of a stream, one call after the other.
#pragma once

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#define RW_CLAIM_FREE INT_MAX
// control words after the claim scratch, with their rest values
#define RW_CTL_LEN0 0     // claimant list 0 length (the walk's list), 0
#define RW_CTL_LEN1 1     // claimant list 1 length, 0
#define RW_CTL_NEXT0 2    // next round (rounds with j even), INT_MAX
#define RW_CTL_NEXT1 3    // next round (rounds with j odd), INT_MAX
#define RW_CTL_K0 4       // least entry round of the walk's list, INT_MAX
#define RW_CTL_WOVER 5    // K3: the walk's overflow sum, 0
#define RW_CTL_TICKET 6   // K3: the walk's finished blocks, 0
#define RW_CTL_CLAIMANTS 8      // K3's last insert: claimants (no rest)
#define RW_CTL_GRID_ROUNDS 9    // K3's last insert: grid rounds (no rest)
#define RW_CTL_BLOCK_ROUNDS 10  // K3's last insert: block 0's rounds
#define RW_CTL_RANK_LAST 11     // K12: last resolving round + 1, 0
#define RW_CTL_RANK_OVER 12     // K12: rows over the round bound, 0
#define RW_CTL_RANK_CLAIMANTS 13    // K12's last call: listed rows
#define RW_CTL_RANK_GRID_ROUNDS 14  // K12's last call: grid rounds
#define RW_CTL_RANK_BLOCK_ROUNDS 15  // K12's last call: block 0's rounds

// block 0's last rounds: the shared claim maps (two, by round parity, of
// RW_TAIL_MAP entries: half full at most) from a scratch index to the least
// claiming row
#define RW_TAIL_MAP_BITS 11
#define RW_TAIL_MAP (1 << RW_TAIL_MAP_BITS)

__device__ __forceinline__ int rw_warp_min(int v) {
  for (int o = 16; o > 0; o >>= 1) {
    const int y = __shfl_xor_sync(0xffffffffu, v, o);
    v = y < v ? y : v;
  }
  return v;
}

__device__ __forceinline__ int rw_warp_max(int v) {
  for (int o = 16; o > 0; o >>= 1) {
    const int y = __shfl_xor_sync(0xffffffffu, v, o);
    v = y > v ? y : v;
  }
  return v;
}

__device__ __forceinline__ int rw_warp_sum(int v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Appends `e` for the lanes where `take` holds to list `dst` (length at
// *len), one atomicAdd a warp.  Every lane of the warp must call it.
template <typename E>
__device__ __forceinline__ void rw_warp_append(bool take, E e, E* dst,
                                               int* len) {
  const int lane = threadIdx.x & 31;
  const unsigned b = __ballot_sync(0xffffffffu, take);
  if (b == 0) return;
  int base = 0;
  if (lane == 0) base = atomicAdd(len, __popc(b));
  base = __shfl_sync(0xffffffffu, base, 0);
  if (take) dst[base + __popc(b & ((1u << lane) - 1u))] = e;
}

#define RW_RED_MIN 0
#define RW_RED_MAX 1

// Block-wide min or max of one value a thread, then one atomic into *dst
// (none when the result is the reduction's identity).  Every thread of the
// block must call it.
template <int OP>
__device__ __forceinline__ void rw_block_into(int v, int* dst) {
  __shared__ int s_red[32];
  const int ident = OP == RW_RED_MIN ? INT_MAX : INT_MIN;
  v = OP == RW_RED_MIN ? rw_warp_min(v) : rw_warp_max(v);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) s_red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    int x = lane < static_cast<int>(blockDim.x >> 5) ? s_red[lane] : ident;
    x = OP == RW_RED_MIN ? rw_warp_min(x) : rw_warp_max(x);
    if (lane == 0 && x != ident) {
      if (OP == RW_RED_MIN) atomicMin(dst, x);
      else atomicMax(dst, x);
    }
  }
  __syncthreads();
}

// Three block-wide reductions at once (a min, a max and a sum of one value
// a thread each), then one atomic apiece into their words (none for an
// identity result).  Every thread of the block must call it.
__device__ __forceinline__ void rw_block_min_max_sum(int vmin, int* dmin,
                                                     int vmax, int* dmax,
                                                     int vsum, int* dsum) {
  __shared__ int s_red3[3][32];
  vmin = rw_warp_min(vmin);
  vmax = rw_warp_max(vmax);
  vsum = rw_warp_sum(vsum);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) {
    s_red3[0][warp] = vmin;
    s_red3[1][warp] = vmax;
    s_red3[2][warp] = vsum;
  }
  __syncthreads();
  if (warp == 0) {
    const bool in = lane < static_cast<int>(blockDim.x >> 5);
    const int x = rw_warp_min(in ? s_red3[0][lane] : INT_MAX);
    const int y = rw_warp_max(in ? s_red3[1][lane] : INT_MIN);
    const int z = rw_warp_sum(in ? s_red3[2][lane] : 0);
    if (lane == 0) {
      if (x != INT_MAX) atomicMin(dmin, x);
      if (y != INT_MIN) atomicMax(dmax, y);
      if (z != 0) atomicAdd(dsum, z);
    }
  }
  __syncthreads();
}

// Block 0's claim contest in shared memory: registers row `r`'s claim of
// scratch index `e` in the map (`keys` holds the indices, -1 when free;
// `rows` the least claiming row, INT_MAX when free) and returns the map
// entry, which the claimant frees in its next round.
__device__ __forceinline__ int rw_map_claim(int* keys, int* rows, int e,
                                            int r) {
  unsigned h = (static_cast<unsigned>(e) * 2654435761u) >>
               (32 - RW_TAIL_MAP_BITS);
  while (true) {
    const int prev = atomicCAS(&keys[h], -1, e);
    if (prev == -1 || prev == e) break;
    h = (h + 1) & (RW_TAIL_MAP - 1);
  }
  atomicMin(&rows[h], r);
  return static_cast<int>(h);
}
