// K17: the top-N band of a row pool (sm_90a).
//
// Replaces risingwave_tpu/stream/top_n.py `GroupTopNExecutor._band_mask`
// (top_n.py:295) with `_order_key` (:49): the whole pool sorted
// lexicographically by (valid first, group hash, order keys, slot), every
// valid row ranked within its group, the band `offset <= rank <
// offset + limit`, and the 1-based absolute rank of every slot.
//
// Two entry points around the stable sorts, which stay torch.sort (CUB's
// radix sort), one per key from the least significant:
//   - rw_topn_keys encodes each integer order key as the reference's uint64
//     key (`u ^ 1 << 63`, `~k` when descending) with the sign bit flipped
//     back, so a signed sort orders it as the unsigned one, and folds the
//     group hash of each slot with K1's device function (`rw_hash_row`);
//   - rw_topn_band takes the final order.  Sorted position i holds the
//     group key gs[i] (the hash, sign-flipped; invalid slots INT64_MAX, above
//     any hash since K1 never returns all-ones), which is non-decreasing,
//     so the reference's segment start (the cummax of the is-new flags) is
//     the lower bound of gs[i]: one binary search per position, no scan.
//     The band flag and rank + 1 scatter back through the order.
//
// Bound: bytes.  Keys: the order columns and group columns read, keys and
// hash written (~32 B/slot); band: order, valid and hash read, the gather
// of the hash through the order, band and rank written (~40 B/slot) and 18
// cached probes per slot.  At 2^18 slots that is ~19 MB, ~6 us of HBM
// time; the sorts between them cost more.
#include "rw_common.cuh"

#define TOPN_MAX_ORDER 8

struct TopnKeysArgs {
  RwCols group;                  // in = the group key columns (n = 0: none)
  const void* okey[TOPN_MAX_ORDER];
  int owidth[TOPN_MAX_ORDER];
  int odesc[TOPN_MAX_ORDER];
  int n_order;
  int64_t* out_keys;             // [n_order, S] sortable order keys
  uint64_t* gh;                  // [S] group hash (0 without groups)
  int S;
};

struct TopnBandArgs {
  const int64_t* order;          // [S] the sorted slot order
  const uint8_t* valid;          // [S]
  const uint64_t* gh;            // [S]
  int64_t* gs;                   // [S] scratch: group key by position
  uint8_t* band;                 // [S] out
  int64_t* ranks;                // [S] out: 1-based absolute rank
  int S;
  long long offset;
  long long limit;
};

static constexpr uint64_t SIGN = 1ull << 63;

__device__ __forceinline__ int64_t load_signed(const void* base, int width,
                                               int64_t i) {
  switch (width) {
    case 1: return static_cast<const int8_t*>(base)[i];
    case 2: return static_cast<const int16_t*>(base)[i];
    case 4: return static_cast<const int32_t*>(base)[i];
    default: return static_cast<const int64_t*>(base)[i];
  }
}

__global__ void topn_keys_kernel(TopnKeysArgs a) {
  const int64_t s = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                    threadIdx.x;
  if (s >= a.S) return;
  for (int j = 0; j < a.n_order; ++j) {
    uint64_t k = static_cast<uint64_t>(load_signed(a.okey[j], a.owidth[j], s))
                 ^ SIGN;
    if (a.odesc[j]) k = ~k;
    a.out_keys[j * static_cast<int64_t>(a.S) + s] =
        static_cast<int64_t>(k ^ SIGN);
  }
  a.gh[s] = a.group.n > 0 ? rw_hash_row(a.group, s) : 0ull;
}

__global__ void topn_group_key_kernel(TopnBandArgs a) {
  const int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                    threadIdx.x;
  if (i >= a.S) return;
  const int64_t o = a.order[i];
  a.gs[i] = a.valid[o] ? static_cast<int64_t>(a.gh[o] ^ SIGN) : INT64_MAX;
}

__global__ void topn_band_kernel(TopnBandArgs a) {
  const int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                    threadIdx.x;
  if (i >= a.S) return;
  const int64_t g = a.gs[i];
  int64_t lo = 0, hi = i;  // first position of the segment holding i
  while (lo < hi) {
    const int64_t mid = (lo + hi) >> 1;
    if (a.gs[mid] < g) lo = mid + 1; else hi = mid;
  }
  const int64_t rank = i - lo;
  const int64_t o = a.order[i];
  a.band[o] = a.valid[o] && rank >= a.offset && rank < a.offset + a.limit;
  a.ranks[o] = rank + 1;
}

extern "C" int rw_topn_keys(TopnKeysArgs args, void* stream) {
  if (args.S > 0) {
    const int threads = 256;
    topn_keys_kernel<<<(args.S + threads - 1) / threads, threads, 0,
                       static_cast<cudaStream_t>(stream)>>>(args);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int rw_topn_band(TopnBandArgs args, void* stream) {
  if (args.S > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int threads = 256;
    const int blocks = (args.S + threads - 1) / threads;
    topn_group_key_kernel<<<blocks, threads, 0, s>>>(args);
    topn_band_kernel<<<blocks, threads, 0, s>>>(args);
  }
  return static_cast<int>(cudaGetLastError());
}
