// K18: the band diff of a top-N flush (sm_90a).
//
// Replaces the part of risingwave_tpu/stream/top_n.py
// `GroupTopNExecutor.flush` (top_n.py:337) after `mask_indices` (K7 here):
// the band compacted to E entries becomes the new emitted band, and the
// out chunk [2E] is the old band as deletes and the new band as inserts,
// each visible only where the other side lacks it as a multiset.
//
// Two entry points around a stable sort of each side's hashes (torch.sort):
//   - rw_topn_flush_gather, one thread per out row: rows j < E copy the old
//     band (`prev_rows`), rows E + c gather pool slot min(cur_idx[c], S-1),
//     the reference's clamp, so a dead entry carries a copy of row S-1 (the
//     shadow digests and the CPU parity see those bytes), into the out
//     chunk and into the new band's own buffers (state leaves, which the
//     shadow snapshot needs 8-byte aligned: views into the out chunk are
//     not for every E).  With a rank column the rank is gathered too (0 for
//     dead entries) and folded into the hash, h ^ rank * 0x9E3779B97F4A7C15
//     (wrapping); dead entries hash to 0.
//   - rw_topn_flush_diff: the reference's `member` is rank-aware: the k-th
//     live entry of a hash (index order) is a member iff the other side
//     holds more than k live entries of that hash.  It compares an [E, E]
//     matrix; here each side's hashes are sorted stably (equal hashes stay
//     in index order), one block per side scans the live flags in sorted
//     order into prefix counts, and one thread per entry finds its hash's
//     run in both sorted arrays by binary search: its rank is the live
//     count before it in its own run, the other side's count is the live
//     count of its run there.  An entry outside the other side goes out:
//     a delete for the old band, an insert for the new.
//
// Bound: bytes.  The gather reads the old band and the band's pool rows
// and writes the [2E] chunk and the new band (E = 2^16 rows of ~104 B:
// ~34 MB moved); the diff reads 2 x E sorted keys and permutations and
// writes 2E flags, with ~3 x 16 cached probes per entry.  The one-block
// scans are ~64 tiles each.
#include "rw_common.cuh"

struct FlushLeaf {
  const void* pool;   // [S] rows
  const void* prev;   // [E] rows
  void* out;          // [2E] rows
  void* cur;          // [E] rows: the new band
  int width;          // bytes per row
};

struct FlushGatherArgs {
  FlushLeaf leaf[RW_MAX_COLS];
  int n_leaves;
  const int32_t* cur_idx;     // [E] band slots (S: dead)
  const uint64_t* phash;      // [S] pool row hash
  const int64_t* ranks;       // [S] 1-based ranks, or null (no rank column)
  const int64_t* prev_rank;   // [E] the old band's rank column
  int64_t* out_rank;          // [2E] the out chunk's rank column
  int64_t* cur_rank;          // [E] the new band's rank column
  uint64_t* cur_hash;         // [E] out
  uint8_t* cur_live;          // [E] out
  int E;
  int S;
};

struct FlushDiffArgs {
  const int64_t* skey[2];     // sorted sign-flipped hashes: old, new band
  const int64_t* perm[2];     // their sort permutations
  const uint8_t* live[2];     // live flags in index order
  int* pref[2];               // [E + 1] scratch: live count before position
  uint8_t* out_valid;         // [2E] deletes (old band), inserts (new band)
  int E;
};

static constexpr uint64_t GOLDEN = 0x9E3779B97F4A7C15ull;
static constexpr int SCAN_T = 1024;

__device__ __forceinline__ void copy_row(uint8_t* dst, const uint8_t* src,
                                         int w) {
  switch (w) {
    case 1: *dst = *src; return;
    case 4: *reinterpret_cast<uint32_t*>(dst) =
                *reinterpret_cast<const uint32_t*>(src); return;
    case 8: *reinterpret_cast<uint64_t*>(dst) =
                *reinterpret_cast<const uint64_t*>(src); return;
    default:
      for (int j = 0; j < w; ++j) dst[j] = src[j];
  }
}

__global__ void topn_flush_gather_kernel(FlushGatherArgs a) {
  const int64_t j = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                    threadIdx.x;
  if (j >= 2 * static_cast<int64_t>(a.E)) return;
  if (j < a.E) {
    for (int k = 0; k < a.n_leaves; ++k) {
      const int w = a.leaf[k].width;
      copy_row(static_cast<uint8_t*>(a.leaf[k].out) + j * w,
               static_cast<const uint8_t*>(a.leaf[k].prev) + j * w, w);
    }
    if (a.ranks != nullptr) a.out_rank[j] = a.prev_rank[j];
    return;
  }
  const int64_t c = j - a.E;
  const int idx = a.cur_idx[c];
  const bool live = idx < a.S;
  const int64_t safe = live ? idx : a.S - 1;
  for (int k = 0; k < a.n_leaves; ++k) {
    const int w = a.leaf[k].width;
    const uint8_t* src =
        static_cast<const uint8_t*>(a.leaf[k].pool) + safe * w;
    copy_row(static_cast<uint8_t*>(a.leaf[k].out) + j * w, src, w);
    copy_row(static_cast<uint8_t*>(a.leaf[k].cur) + c * w, src, w);
  }
  uint64_t h = live ? a.phash[safe] : 0ull;
  if (a.ranks != nullptr) {
    const int64_t rk = live ? a.ranks[safe] : 0;
    a.out_rank[j] = rk;
    a.cur_rank[c] = rk;
    if (live) h ^= static_cast<uint64_t>(rk) * GOLDEN;
  }
  a.cur_hash[c] = h;
  a.cur_live[c] = live;
}

// Block `side`: pref[i] = live entries before sorted position i.
__global__ void __launch_bounds__(SCAN_T) topn_flush_scan_kernel(
    FlushDiffArgs a) {
  __shared__ int s_warp[32];
  const int side = blockIdx.x;
  const int t = threadIdx.x;
  const int lane = t & 31, wid = t >> 5;
  const int64_t* perm = a.perm[side];
  const uint8_t* live = a.live[side];
  int* pref = a.pref[side];
  int carry = 0;
  for (int base = 0; base < a.E; base += SCAN_T) {
    const int i = base + t;
    const int v = i < a.E ? live[perm[i]] != 0 : 0;
    int x = v;
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, x, o);
      if (lane >= o) x += y;
    }
    if (lane == 31) s_warp[wid] = x;
    __syncthreads();
    if (wid == 0) {
      int w = s_warp[lane];
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, w, o);
        if (lane >= o) w += y;
      }
      s_warp[lane] = w;
    }
    __syncthreads();
    if (i < a.E) pref[i] = carry + x - v + (wid > 0 ? s_warp[wid - 1] : 0);
    carry += s_warp[31];
    __syncthreads();
  }
  if (t == 0) pref[a.E] = carry;
}

__device__ __forceinline__ int lower_bound(const int64_t* k, int n,
                                           int64_t v) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (k[mid] < v) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__device__ __forceinline__ int upper_bound(const int64_t* k, int n,
                                           int64_t v) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (k[mid] <= v) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__global__ void topn_flush_member_kernel(FlushDiffArgs a) {
  const int64_t j = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                    threadIdx.x;
  if (j >= 2 * static_cast<int64_t>(a.E)) return;
  const int side = j < a.E ? 0 : 1;
  const int other = 1 - side;
  const int i = static_cast<int>(j - side * static_cast<int64_t>(a.E));
  const int64_t e = a.perm[side][i];
  uint8_t out = 0;
  if (a.live[side][e]) {
    const int64_t h = a.skey[side][i];
    const int lo = lower_bound(a.skey[side], i, h);
    const int rank = a.pref[side][i] - a.pref[side][lo];
    const int olo = lower_bound(a.skey[other], a.E, h);
    const int ohi = upper_bound(a.skey[other], a.E, h);
    const int cnt = a.pref[other][ohi] - a.pref[other][olo];
    out = cnt <= rank;  // not a member: it goes out
  }
  a.out_valid[side * static_cast<int64_t>(a.E) + e] = out;
}

extern "C" int rw_topn_flush_gather(FlushGatherArgs args, void* stream) {
  const int64_t n = 2 * static_cast<int64_t>(args.E);
  if (n > 0) {
    const int threads = 256;
    topn_flush_gather_kernel<<<static_cast<unsigned>((n + threads - 1) /
                                                      threads),
                               threads, 0,
                               static_cast<cudaStream_t>(stream)>>>(args);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int rw_topn_flush_diff(FlushDiffArgs args, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  topn_flush_scan_kernel<<<2, SCAN_T, 0, s>>>(args);
  const int64_t n = 2 * static_cast<int64_t>(args.E);
  if (n > 0) {
    const int threads = 256;
    topn_flush_member_kernel<<<static_cast<unsigned>((n + threads - 1) /
                                                      threads),
                               threads, 0, s>>>(args);
  }
  return static_cast<int>(cudaGetLastError());
}
