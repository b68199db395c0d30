// Kernel K13: the pool side update of the hash join (sm_90a).
//
// Replaces risingwave_tpu/stream/hash_join.py `_update_side_pool` (:597)
// around the ranked insert (K12), with `_rank_by_sorted` (:146) and
// `_totals_from_sort` (:167).  The wrapper sorts the chunk's key hashes
// stably as unsigned 64-bit values (`torch.sort` of the sign-flipped
// pattern, inactive rows last under the all-ones sentinel); then:
//
//   rw_join_rank    the segmented rank over the sorted keys: a row's rank
//                   is its sorted position minus its segment's start (a
//                   running max of the segment starts), scattered back to
//                   row order; the segment starts stay for the update.
//   rw_join_update  after K12: the bump allocator (an exclusive scan of
//                   the accepted rows in row order, pos = pool_len + offs,
//                   rows past the pool dropped and their fresh claims
//                   tombstoned again), the pool-row scatter (strings as
//                   fixed-width bytes plus lengths), pool_pos and
//                   slot_clean at the rows' slots, the degree add of each
//                   key's accepted-insert total at its head slot from its
//                   rank-0 row (a segmented sum over the sorted order),
//                   pool_len and the overflow / inconsistency counters.
//
// Both are one 1024-thread block: each thread owns a contiguous run of
// rows (or sorted positions), and block-wide scans carry the running
// values across threads, so nothing is read back to the host.  Scatter
// targets are unique: pool positions by construction, slots because
// distinct (hash, rank) entries own distinct slots (a 64-bit tag collision
// would merge two entries, as it does in the reference); the degree add is
// an atomic sum.
//
// Bound: bytes.  Per row the update reads ~30 B of flags, slots and ranks
// and moves its columns once (8192 auctions of 7 int64 columns: ~0.5 MB);
// the work is a few scans, so one block at the chunk size is
// latency-bound, not bandwidth-bound.
#include "rw_common.cuh"
#include "rw_join.cuh"

__global__ void __launch_bounds__(1024)
    join_rank_kernel(const long long* sorted_key, const long long* order,
                     int* rank, int* seg_start, int cap) {
  const int T = blockDim.x;
  const int t = threadIdx.x;
  const int per = (cap + T - 1) / T;
  const int lo = t * per < cap ? t * per : cap;
  const int hi = lo + per < cap ? lo + per : cap;
  int last = -1;
  for (int i = lo; i < hi; ++i) {
    if (i == 0 || sorted_key[i] != sorted_key[i - 1]) last = i;
  }
  int total;
  int run = rw_block_exclusive_scan<RwMax>(last, &total);
  for (int i = lo; i < hi; ++i) {
    if (i == 0 || sorted_key[i] != sorted_key[i - 1]) run = i;
    seg_start[i] = run;
    rank[order[i]] = i - run;
  }
}

extern "C" int rw_join_rank(const long long* sorted_key,
                            const long long* order, int* rank,
                            int* seg_start, int cap, void* stream) {
  if (cap > 0) {
    join_rank_kernel<<<1, 1024, 0, static_cast<cudaStream_t>(stream)>>>(
        sorted_key, order, rank, seg_start, cap);
  }
  return static_cast<int>(cudaGetLastError());
}

struct JoinUpdateArgs {
  JoinCols cols;              // src = chunk leaves [cap], dst = pool stores
  const uint8_t* valid;       // [cap]
  const int8_t* ops;          // [cap]
  const uint8_t* null_keys;   // [cap] any join key NULL, or null
  const uint8_t* is_ins;      // [cap] joinable inserts
  const uint8_t* over;        // [cap] K12: probe bound exhausted
  const uint8_t* existed;     // [cap] K12: target entry already present
  const uint8_t* inserted;    // [cap] K12: fresh claim
  const int* slots;           // [cap] K12: resolved entry slot
  const int* rank;            // [cap] rank among the chunk's rows of the key
  const int* head_slot;       // [cap] K12: the key's head slot
  const long long* order;     // [cap] sorted position -> row
  const int* seg_start;       // [cap] sorted position -> segment start
  const long long* clean_key; // [cap] window key for slot_clean, or null
  long long* tags;            // [size] tag table (un-claims)
  int* count;                 // [size] key degree at the head
  int* pool_pos;              // [size]
  long long* slot_clean;      // [size]
  int* pool_len;              // [1] bump cursor
  long long* overflow;        // [1]
  long long* inconsistency;   // [1]
  uint8_t* got;               // [cap] scratch: accepted and placed
  int* pos;                   // [cap] scratch: pool position
  int* prefix;                // [cap] scratch: inclusive sums, sorted order
  int cap;
  int size;
  int pool;
};

__device__ __forceinline__ int block_total(int v) {
  int total;
  rw_block_exclusive_scan<RwSum>(v, &total);
  return total;
}

__global__ void __launch_bounds__(1024) join_update_kernel(JoinUpdateArgs a) {
  const int T = blockDim.x;
  const int t = threadIdx.x;
  const int per = (a.cap + T - 1) / T;
  const int lo = t * per < a.cap ? t * per : a.cap;
  const int hi = lo + per < a.cap ? lo + per : a.cap;
  const int len0 = a.pool_len[0];

  // -- bump allocator over the accepted rows, in row order ---------------
  int mine = 0;
  for (int r = lo; r < hi; ++r) mine += a.is_ins[r] && !a.over[r];
  int n_acc;
  int offs = rw_block_exclusive_scan<RwSum>(mine, &n_acc);
  int n_probe_over = 0, n_dropped = 0, n_overwrite = 0, n_got = 0, n_bad = 0;
  for (int r = lo; r < hi; ++r) {
    const bool joinable =
        a.valid[r] && (a.null_keys == nullptr || !a.null_keys[r]);
    const bool ins_like = a.ops[r] == 0 || a.ops[r] == 3;
    n_bad += joinable && !ins_like;
    const bool acc = a.is_ins[r] && !a.over[r];
    n_probe_over += a.is_ins[r] && a.over[r];
    uint8_t g = 0;
    int p = a.pool;
    if (acc) {
      n_overwrite += a.existed[r];
      p = len0 + offs;
      ++offs;
      if (p < a.pool) {
        g = 1;
      } else {
        ++n_dropped;
        // un-claim the entry of a row that found no pool space
        if (a.inserted[r] && a.slots[r] < a.size) a.tags[a.slots[r]] = 1;
        p = a.pool;
      }
    }
    a.got[r] = g;
    a.pos[r] = p;
    if (!g) continue;
    ++n_got;
    for (int k = 0; k < a.cols.n; ++k) {
      rw_copy_row(a.cols.dst[k], p, a.cols.src[k], r, a.cols.width[k]);
    }
    const int slot = a.slots[r] < a.size - 1 ? a.slots[r] : a.size - 1;
    a.pool_pos[slot] = p;
    if (a.clean_key != nullptr) a.slot_clean[slot] = a.clean_key[r];
  }
  __syncthreads();

  // -- per-key totals of the placed rows over the sorted order ----------
  int s_mine = 0;
  for (int i = lo; i < hi; ++i) s_mine += a.got[a.order[i]];
  int s_tot;
  int run = rw_block_exclusive_scan<RwSum>(s_mine, &s_tot);
  for (int i = lo; i < hi; ++i) {
    run += a.got[a.order[i]];
    a.prefix[i] = run;
  }
  __syncthreads();
  // each segment's last position adds the key's total at its head, from
  // the key's rank-0 row (the segment's first position)
  for (int i = lo; i < hi; ++i) {
    const int s = a.seg_start[i];
    if (i + 1 < a.cap && a.seg_start[i + 1] == s) continue;
    const long long rep = a.order[s];
    if (!a.got[rep] || a.rank[rep] != 0 || a.head_slot[rep] >= a.size) {
      continue;
    }
    const int tot = a.prefix[i] - (s > 0 ? a.prefix[s - 1] : 0);
    atomicAdd(&a.count[a.head_slot[rep]], tot);
  }

  // -- cursor and counters ----------------------------------------------
  n_probe_over = block_total(n_probe_over);
  n_dropped = block_total(n_dropped);
  n_overwrite = block_total(n_overwrite);
  n_got = block_total(n_got);
  n_bad = block_total(n_bad);
  if (t == 0) {
    a.pool_len[0] = len0 + n_got;
    a.overflow[0] += static_cast<long long>(n_probe_over) + n_dropped +
                     n_overwrite;
    a.inconsistency[0] += n_bad;
  }
}

extern "C" int rw_join_update(JoinUpdateArgs args, void* stream) {
  if (args.cap > 0) {
    join_update_kernel<<<1, 1024, 0, static_cast<cudaStream_t>(stream)>>>(
        args);
  }
  return static_cast<int>(cudaGetLastError());
}
