// K18: the band diff of a top-N flush (sm_90a).
//
// Replaces the part of risingwave_tpu/stream/top_n.py
// `GroupTopNExecutor.flush` (top_n.py:337) after `mask_indices` (K7 here):
// the band compacted to E entries becomes the new emitted band, and the
// out chunk [2E] is the old band as deletes and the new band as inserts,
// each visible only where the other side lacks it as a multiset.
//
// Two entry points around a stable sort of each side's hashes (torch.sort):
//   - rw_topn_flush_gather, one launch, each block a tile of GT entries:
//     each thread takes entry c's band slot min(cur_idx[c], S-1), the
//     reference's clamp (a dead entry carries a copy of row S-1: the
//     shadow digests and the CPU parity see those bytes), its liveness and
//     its hash (with a rank column the rank, 0 for dead entries, folded in
//     as h ^ rank * 0x9E3779B97F4A7C15, wrapping; dead entries hash to 0);
//     then the block moves its rows plane by plane in words
//     (rw_rowcopy.cuh's gather form): the old band's rows into the out
//     chunk's first half as a contiguous copy, the band's pool rows, one
//     gather written twice, into the second half and into the new band's
//     own buffers (state leaves, which the shadow snapshot needs 8-byte
//     aligned: views into the out chunk are not for every E).
//   - rw_topn_flush_diff, two launches.  The reference's `member` is
//     rank-aware: the k-th live entry of a hash (index order) is a member
//     iff the other side holds more than k live entries of that hash.  Each
//     side's hashes are sorted stably (equal hashes stay in index order),
//     so a hash is a run of sorted positions.
//       1. topn_flush_scan_kernel, a grid of ST-position tiles of both
//          sides: a segmented scan of the live flags in sorted order,
//          restarted at every run head, so seg[i] is the live count of i's
//          run through i (an entry's rank is seg[i] - live[i]: no search
//          for its run start).  The carry into a tile is a decoupled
//          look-back over 64-bit status words tagged with the call's epoch
//          (a counter of the wrapper's, one per device and stream, with the
//          scratch, so no call resets the words); the look-back stops at
//          the first tile before it that holds a run head, and a tile that
//          starts with a run head needs none.  Tiles come by a ticket, so a
//          tile waits only on running tiles; the last block to finish puts
//          the tickets back to 0.
//       2. topn_flush_member_kernel: for each side o (against the other, q)
//          the two sorted arrays are merged with q's entries first on equal
//          hashes, and the merge is cut into MT-entry tiles (merge path:
//          one search of the two arrays per tile boundary, a 32-ary search
//          by one warp).  In its tile
//          each entry of o finds, in shared memory, how many entries of q
//          come before it: j, the end of q's run of its hash, whose live
//          count is seg_q[j-1] when q[j-1] holds the hash.  An entry goes
//          out (a delete of the old band, an insert of the new) when it is
//          live and that count is at most its rank.
//     Exact for any run length: the dead entries (hash 0) are one run as
//     long as their count, a live entry may hash to 0 too, and a band of
//     equal rows is one live run of E entries.
//
// Bound: bytes.  The gather reads the old band and the band's pool rows
// and writes the [2E] chunk and the new band; the diff reads each side's
// sorted hashes, permutation and live flags and writes 2E flags (the
// scan's counts are written and read once more; the merge reads the
// hashes twice).
#include "rw_common.cuh"
#include "rw_rowcopy.cuh"

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
  int* seg[2];                // [E] scratch: run's live count << 1 | live
  unsigned long long* status; // [2 * n_tiles] look-back words, persistent
  int* ctl;                   // [2] tile and finish tickets, rest at 0
  unsigned long long epoch;   // this call's tag of the status words
  uint8_t* out_valid;         // [2E] deletes (old band), inserts (new band)
  int E;
  int n_tiles;                // scan tiles a side
};

static constexpr uint64_t GOLDEN = 0x9E3779B97F4A7C15ull;
static constexpr int GT = 256;   // gather: entries a block
static constexpr int ST = 512;   // scan: sorted positions a tile
static constexpr int MT = 2048;  // member: merged entries a tile
static constexpr int MB = 512;   // member: threads a block

// status word: epoch << 35 | state << 33 | run head in the tile << 32 |
// live count (of the tile from its last run head, or of all of it)
#define FD_AGG 1ull     // the tile's own count is published
#define FD_PREFIX 2ull  // its inclusive count is published

__global__ void __launch_bounds__(GT) topn_flush_gather_kernel(
    FlushGatherArgs a) {
  __shared__ int s_src[GT];
  const int t = threadIdx.x;
  const int c0 = blockIdx.x * GT;
  const int c = c0 + t;
  if (c < a.E) {
    const int idx = a.cur_idx[c];
    const bool live = idx < a.S;
    const int safe = live ? idx : a.S - 1;
    s_src[t] = safe;
    uint64_t h = live ? a.phash[safe] : 0ull;
    if (a.ranks != nullptr) {
      const int64_t rk = live ? a.ranks[safe] : 0;
      a.out_rank[c] = a.prev_rank[c];
      a.out_rank[a.E + static_cast<int64_t>(c)] = rk;
      a.cur_rank[c] = rk;
      if (live) h ^= static_cast<uint64_t>(rk) * GOLDEN;
    }
    a.cur_hash[c] = h;
    a.cur_live[c] = live;
  }
  __syncthreads();
  const int n = min(GT, a.E - c0);
  const int* src = s_src;
  for (int k = 0; k < a.n_leaves; ++k) {
    const FlushLeaf& l = a.leaf[k];
    const int w = l.width;
    uint8_t* out = static_cast<uint8_t*>(l.out);
    rw_gather_plane(static_cast<const uint8_t*>(l.prev) +
                        static_cast<int64_t>(c0) * w,
                    out + static_cast<int64_t>(c0) * w, nullptr, w, n,
                    [](int i) { return i; }, t, GT);
    rw_gather_plane(l.pool, out + (static_cast<int64_t>(a.E) + c0) * w,
                    static_cast<uint8_t*>(l.cur) +
                        static_cast<int64_t>(c0) * w,
                    w, n, [src](int i) { return src[i]; }, t, GT);
  }
}

// Inclusive segmented scan of (head, v) over the block: on return `head`
// says whether a run head lies at or before this position in the tile and
// `v` is the live count from the last such head (or the tile's start).
// `tot` gets the tile's (any head, count) on every thread.
__device__ __forceinline__ void seg_scan_block(bool& head, int& v,
                                               bool& any, int& tot) {
  __shared__ int s_f[ST / 32];
  __shared__ int s_v[ST / 32];
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  bool f = head;
  int x = v;
  for (int d = 1; d < 32; d <<= 1) {
    const int fo = __shfl_up_sync(0xffffffffu, static_cast<int>(f), d);
    const int xo = __shfl_up_sync(0xffffffffu, x, d);
    if (lane >= d) {
      if (!f) x += xo;
      f = f || fo;
    }
  }
  if (lane == 31) {
    s_f[w] = f;
    s_v[w] = x;
  }
  __syncthreads();
  if (w == 0) {
    bool g = lane < ST / 32 ? s_f[lane] != 0 : false;
    int u = lane < ST / 32 ? s_v[lane] : 0;
    for (int d = 1; d < 32; d <<= 1) {
      const int go = __shfl_up_sync(0xffffffffu, static_cast<int>(g), d);
      const int uo = __shfl_up_sync(0xffffffffu, u, d);
      if (lane >= d) {
        if (!g) u += uo;
        g = g || go;
      }
    }
    if (lane < ST / 32) {
      s_f[lane] = g;
      s_v[lane] = u;
    }
  }
  __syncthreads();
  if (w > 0 && !f) x += s_v[w - 1];
  if (w > 0) f = f || s_f[w - 1] != 0;
  head = f;
  v = x;
  any = s_f[ST / 32 - 1] != 0;
  tot = s_v[ST / 32 - 1];
}

__global__ void __launch_bounds__(ST) topn_flush_scan_kernel(
    FlushDiffArgs a) {
  __shared__ int s_ticket;
  __shared__ int s_carry;
  __shared__ bool s_last;
  const int t = threadIdx.x;
  const int lane = t & 31;
  if (t == 0) s_ticket = atomicAdd(&a.ctl[0], 1);
  __syncthreads();
  const int side = s_ticket >= a.n_tiles ? 1 : 0;
  const int tile = s_ticket - side * a.n_tiles;
  const int64_t* key = a.skey[side];
  const int i = tile * ST + t;
  const bool in = i < a.E;
  int v = in ? a.live[side][a.perm[side][i]] != 0 : 0;
  const int live_here = v;
  bool head = in && (i == 0 || key[i - 1] != key[i]);
  // warp 0: does the tile start with a run head (then it needs no carry)
  const bool first_head =
      __shfl_sync(0xffffffffu, static_cast<int>(head), 0) != 0;
  bool any;
  int tot;
  seg_scan_block(head, v, any, tot);

  // the carry: live entries of the run open at the tile's start, by
  // decoupled look-back over the tiles before it (warp 0)
  if (t < 32) {
    volatile unsigned long long* status = a.status + side * a.n_tiles;
    const unsigned long long tag = a.epoch << 35;
    const unsigned long long mine =
        (any ? 1ull << 32 : 0ull) | static_cast<unsigned>(tot);
    // a tile with a run head knows its inclusive count at once
    if (lane == 0) {
      status[tile] =
          tag | ((tile == 0 || any ? FD_PREFIX : FD_AGG) << 33) | mine;
    }
    long long carry = 0;
    int pos = tile - 1;
    const bool need = !first_head && tile > 0;
    while (need && pos >= 0) {
      const int idx = pos - lane;  // lane 0 the nearest
      unsigned long long w = tag | (FD_PREFIX << 33);
      if (idx >= 0) {
        do {
          w = status[idx];
        } while ((w >> 35) != a.epoch);
      }
      const bool stop = ((w >> 33) & FD_PREFIX) != 0 ||
                        ((w >> 32) & 1ull) != 0;
      const unsigned stops = __ballot_sync(0xffffffffu, stop);
      const int first = stops ? __ffs(stops) - 1 : 32;
      long long c = (lane <= first && idx >= 0) ? (w & 0xffffffffull) : 0;
      for (int o = 16; o > 0; o >>= 1) {
        c += __shfl_xor_sync(0xffffffffu, c, o);
      }
      carry += c;
      if (stops) break;
      pos -= 32;
    }
    if (lane == 0) {
      if (tile > 0 && !any) {
        status[tile] = tag | (FD_PREFIX << 33) |
                       static_cast<unsigned>(carry + tot);
      }
      s_carry = static_cast<int>(carry);
    }
  }
  __syncthreads();
  if (in) a.seg[side][i] = ((head ? v : s_carry + v) << 1) | live_here;

  // the last block to finish puts the tickets back
  __syncthreads();
  if (t == 0) {
    __threadfence();
    s_last = atomicAdd(&a.ctl[1], 1) == 2 * a.n_tiles - 1;
  }
  __syncthreads();
  if (s_last && t == 0) {
    a.ctl[0] = 0;
    a.ctl[1] = 0;
  }
}

// Merge path: the entries of o among the first d of the merge (q first on
// equal hashes), by a 32-ary search of one warp: each round probes 32
// evenly spaced candidates, so ~5 rounds of one load pair a lane cover 2^22.
__device__ __forceinline__ int co_rank(const int64_t* ko, const int64_t* kq,
                                       int E, int d) {
  const int lane = threadIdx.x & 31;
  int lo = max(0, d - E), hi = min(d, E);  // the answer lies in [lo, hi]
  while (lo < hi) {
    const int step = (hi - lo + 31) / 32;
    const int p = lo + lane * step;
    // o's entry p comes first iff its hash is below q's (d - 1 - p)
    const bool first = p < hi && ko[p] < kq[d - 1 - p];
    const int k = __popc(__ballot_sync(0xffffffffu, first));
    const int nlo = k > 0 ? lo + (k - 1) * step + 1 : lo;
    hi = min(hi, lo + k * step);
    lo = nlo;
  }
  return lo;
}

__global__ void __launch_bounds__(MB) topn_flush_member_kernel(
    FlushDiffArgs a) {
  __shared__ int64_t s_key[MT];
  __shared__ int s_o[2];
  const int t = threadIdx.x;
  const int E = a.E;
  const int m_tiles = (2 * E + MT - 1) / MT;
  const int dir = blockIdx.x >= m_tiles ? 1 : 0;  // the side of the entries
  const int tile = blockIdx.x - dir * m_tiles;
  const int64_t* ko = a.skey[dir];
  const int64_t* kq = a.skey[1 - dir];
  const int d0 = tile * MT;
  const int d1 = min(2 * E, d0 + MT);
  if (t < 64) {  // warp 0 the tile's start, warp 1 its end
    const int r = co_rank(ko, kq, E, t < 32 ? d0 : d1);
    if ((t & 31) == 0) s_o[t >> 5] = r;
  }
  __syncthreads();
  const int o0 = s_o[0], o1 = s_o[1];
  const int q0 = d0 - o0, q1 = d1 - o1;
  const int nq = q1 - q0;
  for (int j = t; j < nq; j += MB) s_key[j] = kq[q0 + j];
  __syncthreads();
  const int* seg_q = a.seg[1 - dir];
  for (int r = t; r < o1 - o0; r += MB) {
    const int i = o0 + r;
    const int64_t h = ko[i];
    int lo = 0, hi = nq;  // q's entries of the tile at or below h
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (s_key[mid] <= h) lo = mid + 1; else hi = mid;
    }
    const int j = q0 + lo;  // q's entries before this one in the merge
    int cnt = 0;
    if (j > 0 && (lo > 0 ? s_key[lo - 1] : kq[j - 1]) == h) {
      cnt = seg_q[j - 1] >> 1;
    }
    const int s = a.seg[dir][i];
    const int live = s & 1;
    const int rank = (s >> 1) - live;
    a.out_valid[dir * static_cast<int64_t>(E) + a.perm[dir][i]] =
        live && cnt <= rank;
  }
}

extern "C" int rw_topn_flush_gather(FlushGatherArgs args, void* stream) {
  if (args.E > 0) {
    topn_flush_gather_kernel<<<(args.E + GT - 1) / GT, GT, 0,
                               static_cast<cudaStream_t>(stream)>>>(args);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int rw_topn_flush_diff(FlushDiffArgs args, void* stream) {
  if (args.E <= 0) return static_cast<int>(cudaGetLastError());
  if (args.n_tiles != (args.E + ST - 1) / ST) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  topn_flush_scan_kernel<<<2 * args.n_tiles, ST, 0, s>>>(args);
  const int m_tiles = (2 * args.E + MT - 1) / MT;
  topn_flush_member_kernel<<<2 * m_tiles, MB, 0, s>>>(args);
  return static_cast<int>(cudaGetLastError());
}
