// K16: apply a changelog chunk to a top-N row pool (sm_90a).
//
// Replaces risingwave_tpu/stream/top_n.py `pool_apply` (top_n.py:134), the
// XLA program behind GroupTopNExecutor.apply (and the pools of the
// over-window and dynamic-filter executors).  The reference's semantics, on
// the chunk's row hashes h (K1) and the pool's `valid` / `row_hash`:
//   - in-chunk annihilation: an insert whose rank among the equal-h inserts
//     (row order) is below the count of equal-h deletes drops, and likewise
//     for deletes;
//   - each surviving delete clears the rank-th valid pool slot of its h
//     (slot order); the deletes that find none are counted (`inconsistency`);
//   - the surviving insert of rank r (row order) claims the r-th free slot
//     (ascending) and writes every column and its hash there; the inserts
//     past the last free slot are counted (`overflow`).
//
// Design.  The reference builds a [cap, S] match matrix; here a chunk-sized
// open-addressing table of the active rows' hashes (T >= 2 cap slots, keys
// claimed by atomicCAS, all-ones = empty: K1 never returns it) holds each
// hash's insert and delete counts.  Only three things need an order:
//   - the rank of an insert whose hash also has deletes (the others never
//     annihilate),
//   - the rank of a matching pool slot among the valid slots of its hash,
//   - the rank of an insert among the surviving inserts and of a free slot.
// ONE block of 1024 threads walks rows (and pool slots) in tiles of 1024 in
// order: a block scan compacts a tile's candidates into shared memory in
// order, each candidate counts the earlier candidates of its table entry in
// the tile and adds the entry's count from earlier tiles, and the counts
// advance after a barrier.  Surviving deletes only need their count per
// hash, so the pool pass runs only when one exists, and the free-slot scan
// stops at the tile where the inserts are all placed.  A second, grid-wide
// kernel copies the claimed rows' columns.  Nothing is read back to the
// host; the counters are added on the device.
//
// Bound: bytes.  The chunk (cap x ~100 B) is read and written once; the
// pool pass reads valid + hash of every slot (9 B/slot) only when a delete
// survives; the free scan reads the first free slots' validity.  On the
// append-only q19/q18 path that is ~1.6 MB per 8192-row chunk, under a
// microsecond of HBM time: the one-block walk makes the kernel latency
// bound, tens of microseconds.
#include "rw_common.cuh"

struct PoolApplyArgs {
  RwCols cols;                 // in = chunk column leaves, st = pool stores
  const uint64_t* hash;        // [cap] row hash (K1)
  const int8_t* ops;           // [cap]
  const uint8_t* valid;        // [cap]
  uint8_t* pvalid;             // [S] pool validity, in place
  uint64_t* phash;             // [S] pool row hash, in place
  unsigned long long* tkey;    // [T] scratch: hash table keys
  int* tins;                   // [T] scratch: inserts per hash
  int* tdel;                   // [T] scratch: deletes per hash
  int* tcnt;                   // [T] scratch: running rank per entry
  int* rent;                   // [cap] scratch: row -> entry (-1: inactive)
  int* rank;                   // [cap] scratch: survival flag, then rank
  int* sor;                    // [cap] scratch: slot of free rank
  int* tgt;                    // [cap] out: claimed slot (S: none)
  long long* overflow;         // [1] += inserts without a free slot
  long long* inconsistency;    // [1] += deletes without a pool row
  int cap;
  int S;
  int T;
};

static constexpr unsigned long long EMPTY_KEY = ~0ull;
static constexpr int NT = 1024;

__device__ __forceinline__ bool is_insert_op(int8_t op) {
  return op == 0 || op == 3;  // Insert, UpdateInsert
}

// Exclusive block scan of one int per thread (all NT threads call it).
__device__ int block_excl_scan(int v, int* s_warp, int* total) {
  const int lane = threadIdx.x & 31;
  const int wid = threadIdx.x >> 5;
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
    s_warp[lane] = w;  // inclusive prefix of the warp totals
  }
  __syncthreads();
  const int excl = x - v + (wid > 0 ? s_warp[wid - 1] : 0);
  *total = s_warp[31];
  __syncthreads();  // s_warp is reused by the next call
  return excl;
}

__device__ int table_insert(unsigned long long* tkey, int T,
                            unsigned long long h) {
  int s = static_cast<int>(h & static_cast<unsigned long long>(T - 1));
  while (true) {
    const unsigned long long prev = atomicCAS(&tkey[s], EMPTY_KEY, h);
    if (prev == EMPTY_KEY || prev == h) return s;
    s = (s + 1) & (T - 1);
  }
}

__device__ int table_find(const unsigned long long* tkey, int T,
                          unsigned long long h) {
  int s = static_cast<int>(h & static_cast<unsigned long long>(T - 1));
  while (true) {
    const unsigned long long k = tkey[s];
    if (k == h) return s;
    if (k == EMPTY_KEY) return -1;
    s = (s + 1) & (T - 1);
  }
}

// Surviving deletes of an entry: the first min(ins, del) of each side
// annihilate.
__device__ __forceinline__ int surviving_deletes(const PoolApplyArgs& a,
                                                 int e) {
  return a.tdel[e] - min(a.tins[e], a.tdel[e]);
}

// Rank of this thread's candidate among the tile's earlier candidates of
// the same entry (candidates compacted in order into s_ent).
__device__ __forceinline__ int tile_rank(const int* s_ent, int k, int e) {
  int before = 0;
  for (int j = 0; j < k; ++j) before += (s_ent[j] == e);
  return before;
}

__global__ void __launch_bounds__(NT) topn_pool_kernel(PoolApplyArgs a) {
  __shared__ int s_warp[32];
  __shared__ int s_ent[NT];
  __shared__ unsigned long long s_miss;
  const int t = threadIdx.x;
  if (t == 0) s_miss = 0;
  for (int j = t; j < a.T; j += NT) {
    a.tkey[j] = EMPTY_KEY;
    a.tins[j] = 0;
    a.tdel[j] = 0;
    a.tcnt[j] = 0;
  }
  __syncthreads();

  // 1. table entries and per-hash insert/delete counts
  for (int r = t; r < a.cap; r += NT) {
    int e = -1;
    if (a.valid[r]) {
      e = table_insert(a.tkey, a.T, a.hash[r]);
      atomicAdd(is_insert_op(a.ops[r]) ? &a.tins[e] : &a.tdel[e], 1);
    }
    a.rent[r] = e;
  }
  __syncthreads();

  // 2. annihilation of inserts: rank among the equal-hash inserts
  int total;
  for (int base = 0; base < a.cap; base += NT) {
    const int r = base + t;
    const int e = r < a.cap ? a.rent[r] : -1;
    const bool ins = e >= 0 && is_insert_op(a.ops[r]);
    const bool contested = ins && a.tdel[e] > 0;
    const int k = block_excl_scan(contested, s_warp, &total);
    if (contested) s_ent[k] = e;
    __syncthreads();
    bool keep = ins;
    if (contested) keep = a.tcnt[e] + tile_rank(s_ent, k, e) >= a.tdel[e];
    __syncthreads();
    if (contested) atomicAdd(&a.tcnt[e], 1);
    if (r < a.cap) a.rank[r] = keep;
    __syncthreads();
  }
  int any_del = 0;
  for (int r = t; r < a.cap; r += NT) {
    const int e = a.rent[r];
    if (e >= 0 && !is_insert_op(a.ops[r]) && surviving_deletes(a, e) > 0) {
      any_del = 1;
    }
  }
  for (int j = t; j < a.T; j += NT) a.tcnt[j] = 0;
  any_del = __syncthreads_or(any_del);

  // 3. deletes: each hash clears its first valid pool slots (slot order)
  if (any_del) {
    for (int base = 0; base < a.S; base += NT) {
      const int s = base + t;
      int e = -1;
      if (s < a.S && a.pvalid[s]) {
        e = table_find(a.tkey, a.T, a.phash[s]);
        if (e >= 0 && surviving_deletes(a, e) == 0) e = -1;
      }
      const bool cand = e >= 0;
      const int k = block_excl_scan(cand, s_warp, &total);
      if (cand) s_ent[k] = e;
      __syncthreads();
      bool clear = false;
      if (cand) {
        clear = a.tcnt[e] + tile_rank(s_ent, k, e) < surviving_deletes(a, e);
      }
      __syncthreads();
      if (cand) {
        atomicAdd(&a.tcnt[e], 1);
        if (clear) a.pvalid[s] = 0;
      }
      __syncthreads();
    }
    unsigned long long miss = 0;
    for (int j = t; j < a.T; j += NT) {
      if (a.tkey[j] != EMPTY_KEY) {
        miss += static_cast<unsigned long long>(
            max(0, surviving_deletes(a, j) - a.tcnt[j]));
      }
    }
    if (miss) atomicAdd(&s_miss, miss);
  }

  // 4. rank of each surviving insert in row order
  int n_ins = 0;
  for (int base = 0; base < a.cap; base += NT) {
    const int r = base + t;
    const int keep = r < a.cap ? a.rank[r] : 0;
    const int k = block_excl_scan(keep, s_warp, &total);
    if (r < a.cap) a.rank[r] = keep ? n_ins + k : -1;
    n_ins += total;
  }

  // 5. the first n_ins free slots, ascending (after the deletes)
  int found = 0;
  for (int base = 0; base < a.S && found < n_ins; base += NT) {
    const int s = base + t;
    const int fr = s < a.S && !a.pvalid[s];
    const int k = block_excl_scan(fr, s_warp, &total);
    if (fr && found + k < n_ins) a.sor[found + k] = s;
    found += total;
  }
  __syncthreads();
  const int placed = min(found, n_ins);

  // 6. claims
  for (int r = t; r < a.cap; r += NT) {
    const int rk = a.rank[r];
    int slot = a.S;
    if (rk >= 0 && rk < placed) {
      slot = a.sor[rk];
      a.pvalid[slot] = 1;
      a.phash[slot] = a.hash[r];
    }
    a.tgt[r] = slot;
  }
  __syncthreads();
  if (t == 0) {
    a.overflow[0] += static_cast<long long>(n_ins - placed);
    a.inconsistency[0] += static_cast<long long>(s_miss);
  }
}

// Copy every column of each claimed row into its pool slot.
__global__ void topn_pool_write_kernel(RwCols cols, const int* tgt, int cap,
                                       int S) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= cap) return;
  const int slot = tgt[r];
  if (slot < S) rw_store_row(cols, slot, r);
}

extern "C" int rw_topn_pool_apply(PoolApplyArgs args, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  topn_pool_kernel<<<1, NT, 0, s>>>(args);
  if (args.cap > 0) {
    const int threads = 256;
    topn_pool_write_kernel<<<(args.cap + threads - 1) / threads, threads, 0,
                             s>>>(args.cols, args.tgt, args.cap, args.S);
  }
  return static_cast<int>(cudaGetLastError());
}
