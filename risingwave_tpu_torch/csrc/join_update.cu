// Kernel K13: the pool side update of the hash join (sm_90a).
//
// Replaces risingwave_tpu/stream/hash_join.py `_update_side_pool` (:597)
// around the ranked insert (K12), with `_rank_by_sorted` (:146) and
// `_totals_from_sort` (:167).  The wrapper sorts the chunk's key hashes
// stably as unsigned 64-bit values (`torch.sort` of the sign-flipped
// pattern, inactive rows last under the all-ones sentinel); then:
//
//   rw_join_rank    one grid launch, one thread a sorted position, no scan:
//                   position i's segment start is the lower bound of
//                   sorted_key[i] in sorted_key (a binary search that stays
//                   in cache), and rank[order[i]] = i - seg_start[i]; the
//                   segment starts stay for the update.  It also gives the
//                   dense side's ranks (`rank_by`: K13d, K6m).
//   rw_join_update  after K12, three grid launches of 256-row tiles, in row
//                   order where the reference is, with no host read:
//     join_count    each tile's accepted rows (is_ins and not over the
//                   probe bound) into tile_counts; the probe-bound and
//                   overwrite counts into `overflow` and the deletes of
//                   joinable rows into `inconsistency`, one atomic a block.
//     join_place    the bump allocator: a tile's offset is the sum of the
//                   counts before it, a row's the block scan of its tile,
//                   pos = pool_len + offset; rows past the pool are dropped
//                   and un-claim their fresh tag (tags[slot] = 1).  The
//                   placed rows of a tile own consecutive pool rows, so the
//                   row copy runs over the tile's destination bytes: the
//                   threads of a warp copy neighbouring 16/8/4-byte words
//                   of a leaf (the widest the width and addresses allow).
//                   pool_pos and slot_clean are written at the rows' slots.
//     join_degree   one thread a sorted position: a placed row whose
//                   segment's rank-0 row order[seg_start[i]] was placed with
//                   a head slot below size adds 1 at that head, which is
//                   the reference's segmented total added from the rank-0
//                   row (integer atomics: exact in any order).  The lanes
//                   of a warp that share a head add once (a hot key is one
//                   segment of thousands of rows).  Block 0 then moves
//                   pool_len to pool_len + n_got, n_got = clamp(pool -
//                   pool_len, 0, accepted), and counts the dropped rows:
//                   every block of join_place read pool_len before.
//
// Scatter targets are unique: pool positions by construction, slots because
// distinct (hash, rank) entries own distinct slots (a 64-bit tag collision
// would merge two entries, as it does in the reference).
//
// Bound: bytes.  Per row the update reads ~30 B of flags, slots and ranks
// and moves its columns once (8192 auctions of 7 int64 columns: ~0.5 MB),
// about a microsecond at HBM rate; four launches of 32 blocks at q8's chunk
// spend mostly launch latency.
#include <climits>

#include "rw_common.cuh"
#include "rw_join.cuh"

constexpr int JOIN_TILE = 256;

__global__ void __launch_bounds__(JOIN_TILE)
    join_rank_kernel(const long long* sorted_key, const long long* order,
                     int* rank, int* seg_start, int cap) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= cap) return;
  const long long key = sorted_key[i];
  int lo = i;
  if (i > 0 && sorted_key[i - 1] == key) {
    // the first position of the key: lower bound in [0, i - 1]
    int a = 0, b = i - 1;
    while (a < b) {
      const int mid = (a + b) >> 1;
      if (sorted_key[mid] < key) a = mid + 1; else b = mid;
    }
    lo = a;
  }
  seg_start[i] = lo;
  rank[order[i]] = i - lo;
}

extern "C" int rw_join_rank(const long long* sorted_key,
                            const long long* order, int* rank,
                            int* seg_start, int cap, void* stream) {
  if (cap > 0) {
    join_rank_kernel<<<(cap + JOIN_TILE - 1) / JOIN_TILE, JOIN_TILE, 0,
                       static_cast<cudaStream_t>(stream)>>>(
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
  int* tile_counts;           // [ceil(cap / JOIN_TILE)] scratch
  int cap;
  int size;
  int pool;
};

__device__ __forceinline__ bool accepted(const JoinUpdateArgs& a, int r) {
  return a.is_ins[r] && !a.over[r];
}

__global__ void __launch_bounds__(JOIN_TILE) join_count(JoinUpdateArgs a) {
  const int r = blockIdx.x * JOIN_TILE + threadIdx.x;
  int acc = 0, over = 0, bad = 0;
  if (r < a.cap) {
    const bool joinable =
        a.valid[r] && (a.null_keys == nullptr || !a.null_keys[r]);
    const bool ins_like = a.ops[r] == 0 || a.ops[r] == 3;
    bad = joinable && !ins_like;
    acc = accepted(a, r);
    // probe-bound losses and overwritten entries
    over = (a.is_ins[r] && a.over[r]) + (acc && a.existed[r]);
  }
  int n_acc, n_over, n_bad;
  rw_block_exclusive_scan<RwSum>(acc, &n_acc);
  rw_block_exclusive_scan<RwSum>(over, &n_over);
  rw_block_exclusive_scan<RwSum>(bad, &n_bad);
  if (threadIdx.x == 0) {
    a.tile_counts[blockIdx.x] = n_acc;
    if (n_over) {
      atomicAdd(reinterpret_cast<unsigned long long*>(a.overflow),
                static_cast<unsigned long long>(n_over));
    }
    if (n_bad) {
      atomicAdd(reinterpret_cast<unsigned long long*>(a.inconsistency),
                static_cast<unsigned long long>(n_bad));
    }
  }
}

// Copy rows [0, n) of the tile (source rows s_rows[...]) of one leaf of
// width w to pool rows p0 .. p0 + n - 1: neighbouring threads on
// neighbouring words of the destination.
template <typename W>
__device__ __forceinline__ void copy_tile_leaf(void* dst, const void* src,
                                               int w, long long p0,
                                               const int* s_rows, int n) {
  const int per = w / static_cast<int>(sizeof(W));
  const W* ps = static_cast<const W*>(src);
  W* pd = static_cast<W*>(dst) + p0 * per;
  for (int j = threadIdx.x; j < n * per; j += blockDim.x) {
    const int row = j / per;
    const int word = j - row * per;
    pd[j] = ps[static_cast<long long>(s_rows[row]) * per + word];
  }
}

__global__ void __launch_bounds__(JOIN_TILE) join_place(JoinUpdateArgs a) {
  __shared__ int s_rows[JOIN_TILE];
  const int tile = blockIdx.x;
  const int r = tile * JOIN_TILE + threadIdx.x;
  const int len0 = a.pool_len[0];
  // this tile's offset: the accepted rows of the tiles before it
  int before = 0;
  for (int b = threadIdx.x; b < tile; b += blockDim.x) {
    before += a.tile_counts[b];
  }
  int tile_off;
  rw_block_exclusive_scan<RwSum>(before, &tile_off);
  const bool acc = r < a.cap && accepted(a, r);
  int n_tile;
  const int local = rw_block_exclusive_scan<RwSum>(acc, &n_tile);
  const long long p0 = static_cast<long long>(len0) + tile_off;
  long long room = static_cast<long long>(a.pool) - p0;
  room = room < 0 ? 0 : room;
  const int n_got = static_cast<int>(room < n_tile ? room : n_tile);
  if (r < a.cap) {
    const bool g = acc && local < n_got;
    a.got[r] = g;
    if (acc) {
      if (g) {
        s_rows[local] = r;
        const int p = static_cast<int>(p0 + local);
        const int slot = a.slots[r] < a.size - 1 ? a.slots[r] : a.size - 1;
        a.pool_pos[slot] = p;
        if (a.clean_key != nullptr) a.slot_clean[slot] = a.clean_key[r];
      } else if (a.inserted[r] && a.slots[r] < a.size) {
        // un-claim the entry of a row that found no pool space
        a.tags[a.slots[r]] = 1;
      }
    }
  }
  __syncthreads();
  if (n_got == 0) return;
  for (int k = 0; k < a.cols.n; ++k) {
    const int w = a.cols.width[k];
    const unsigned long long addr =
        reinterpret_cast<unsigned long long>(a.cols.src[k]) |
        reinterpret_cast<unsigned long long>(a.cols.dst[k]);
    const int align = (w | static_cast<int>(addr & 15)) & 15;
    if (align == 0) {
      copy_tile_leaf<uint4>(a.cols.dst[k], a.cols.src[k], w, p0, s_rows,
                            n_got);
    } else if ((align & 7) == 0) {
      copy_tile_leaf<uint64_t>(a.cols.dst[k], a.cols.src[k], w, p0, s_rows,
                               n_got);
    } else if ((align & 3) == 0) {
      copy_tile_leaf<uint32_t>(a.cols.dst[k], a.cols.src[k], w, p0, s_rows,
                               n_got);
    } else {
      copy_tile_leaf<uint8_t>(a.cols.dst[k], a.cols.src[k], w, p0, s_rows,
                              n_got);
    }
  }
}

__global__ void __launch_bounds__(JOIN_TILE) join_degree(JoinUpdateArgs a,
                                                         int n_tiles) {
  const int lane = threadIdx.x & 31;
  const int i = blockIdx.x * JOIN_TILE + threadIdx.x;
  int head = -1;
  if (i < a.cap && a.got[a.order[i]]) {
    const long long rep = a.order[a.seg_start[i]];
    if (a.got[rep] && a.rank[rep] == 0 && a.head_slot[rep] < a.size) {
      head = a.head_slot[rep];
    }
  }
  // the lanes that share a head add once
  const unsigned peers = __match_any_sync(0xffffffffu, head);
  if (head >= 0 && lane == __ffs(peers) - 1) {
    atomicAdd(&a.count[head], __popc(peers));
  }
  if (blockIdx.x != 0) return;
  int mine = 0;
  for (int b = threadIdx.x; b < n_tiles; b += blockDim.x) {
    mine += a.tile_counts[b];
  }
  int n_acc;
  rw_block_exclusive_scan<RwSum>(mine, &n_acc);
  if (threadIdx.x == 0) {
    const int len0 = a.pool_len[0];
    long long room = static_cast<long long>(a.pool) - len0;
    room = room < 0 ? 0 : room;
    const int n_got = static_cast<int>(room < n_acc ? room : n_acc);
    a.pool_len[0] = len0 + n_got;
    if (n_acc > n_got) {
      atomicAdd(reinterpret_cast<unsigned long long*>(a.overflow),
                static_cast<unsigned long long>(n_acc - n_got));
    }
  }
}

extern "C" int rw_join_update(JoinUpdateArgs args, void* stream) {
  if (args.cap <= 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tiles = (args.cap + JOIN_TILE - 1) / JOIN_TILE;
  join_count<<<tiles, JOIN_TILE, 0, s>>>(args);
  join_place<<<tiles, JOIN_TILE, 0, s>>>(args);
  join_degree<<<tiles, JOIN_TILE, 0, s>>>(args, tiles);
  return static_cast<int>(cudaGetLastError());
}
