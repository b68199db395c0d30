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
// So per hash only counts matter on the delete side: with i inserts and d
// deletes of h in the chunk, the first min(i, d) inserts drop, and the
// first max(d - i, 0) valid slots of h (slot order) are cleared.  Only
// three things need an order: the rank of an insert whose hash also has
// deletes, the rank of a matching pool slot, and the ranks of the surviving
// inserts and of the free slots.
//
// One cooperative launch (every block co-resident, grid.sync() between the
// phases).  Each block owns a contiguous range of chunk rows and one of
// pool slots, so a range's count, a scan of the blocks' counts and a block
// scan per tile compact in order across the grid.
//   P1  every block: whether its rows hold a valid delete (one flag for the
//       grid), its valid inserts and its free slots (16 validity bytes a
//       load).
//   Without a delete (q19's, q18's and ow_bid's every chunk) no row
//   annihilates and no slot is cleared: straight to P7.
//   P2  rows into a chunk-sized open-addressing table of their hashes (T >=
//       2 cap slots, keys claimed by atomicCAS, all-ones = empty: K1 never
//       returns it) with each hash's insert and delete counts; the row that
//       claims an entry represents it.
//   P3  per block: the contested rows (an insert whose hash has deletes)
//       and the other inserts, which survive.
//   P4  the contested rows listed in row order; per block, the candidate
//       slots (a valid slot whose hash has surviving deletes).
//   P5  the candidate slots listed in slot order.
//   P6  over the lists only: one block walks a list in tiles of NT items,
//       each item ranked among the tile's earlier items of its entry plus
//       the entry's running count in the table.  Block 0 keeps a contested
//       insert iff its rank among its hash's contested inserts is at least
//       the hash's deletes; the last block clears a candidate iff its rank
//       among its hash's candidates is below the hash's surviving deletes,
//       and gives the slot back to its block's free count.  A pool full of
//       equal rows makes the candidate list as long as the pool, and the
//       walk as long.
//   P7  every block: the surviving inserts' ranks (row order) and the free
//       slots' (slot order, only the first n_ins written); the missing
//       deletes, per represented hash.
//   P8  the claims: slot of rank r gets row of rank r, its hash and every
//       plane of its columns in words (rw_rowcopy.cuh); the representatives
//       put their table entries back at rest; the overflow counted.
// The scratch stays allocated between calls (the wrapper keeps one set per
// device and stream, sized for the largest chunk and pool so far), and the
// table and the flag rest empty: each call restores what it touched.
// Nothing is read back to the host; the counters are added on the device.
//
// Bound: bytes.  Every chunk row's flag read; a valid row's op, hash and
// payload read; the pool's validity read (1 B a slot) for the free slots;
// a delete's matched slot; an insert's claimed slot written (payload,
// hash, flag).  With deletes, the pool's hashes of valid slots are read
// too (P4, P5).
#include <cooperative_groups.h>

#include "rw_common.cuh"
#include "rw_compact.cuh"
#include "rw_rowcopy.cuh"

namespace cg = cooperative_groups;

struct PoolApplyArgs {
  RwCols cols;                 // in = chunk column leaves, st = pool stores
  const uint64_t* hash;        // [cap] row hash (K1)
  const int8_t* ops;           // [cap]
  const uint8_t* valid;        // [cap]
  uint8_t* pvalid;             // [S] pool validity, in place
  uint64_t* phash;             // [S] pool row hash, in place
  unsigned long long* tkey;    // [T] scratch at rest: EMPTY_KEY
  int* tcount;                 // [4 T] scratch at rest 0: ins, del, ranked
                               // contested inserts, ranked candidates
  int* rent;                   // [cap] row -> entry << 1 | represents
  uint8_t* surv;               // [cap] surviving insert
  int* list;                   // [cap] contested rows, row order
  int* cand;                   // [S] candidate slots, slot order
  int* ins_row;                // [cap] row of insert rank
  int* sor;                    // [cap] slot of free rank
  int* bcount;                 // [4 G] per block: inserts, contested,
                               // candidates, free slots
  int* ctl;                    // [1] any delete, at rest 0
  long long* overflow;         // [1] += inserts without a free slot
  long long* inconsistency;    // [1] += deletes without a pool row
  int cap;
  int S;
  int T;
  int pv_aligned;              // pvalid is 16-byte aligned
};

static constexpr unsigned long long EMPTY_KEY = ~0ull;
static constexpr int NT = 512;
// most blocks of the grid: the room of the per-block counts (bcount holds
// 4 MAX_BLOCKS ints, top_n._POOL_MAX_BLOCKS); the card's co-resident
// blocks bound the grid first
static constexpr int MAX_BLOCKS = 4096;

__device__ __forceinline__ bool is_insert_op(int8_t op) {
  return op == 0 || op == 3;  // Insert, UpdateInsert
}

// The entry of h, claimed if it is new; *rep: this call claimed it.
__device__ __forceinline__ int table_insert(unsigned long long* tkey, int T,
                                            unsigned long long h, bool* rep) {
  int s = static_cast<int>(h & static_cast<unsigned long long>(T - 1));
  while (true) {
    const unsigned long long prev = atomicCAS(&tkey[s], EMPTY_KEY, h);
    if (prev == EMPTY_KEY || prev == h) {
      *rep = prev == EMPTY_KEY;
      return s;
    }
    s = (s + 1) & (T - 1);
  }
}

__device__ __forceinline__ int table_find(const unsigned long long* tkey,
                                          int T, unsigned long long h) {
  int s = static_cast<int>(h & static_cast<unsigned long long>(T - 1));
  while (true) {
    const unsigned long long k = tkey[s];
    if (k == h) return s;
    if (k == EMPTY_KEY) return -1;
    s = (s + 1) & (T - 1);
  }
}

struct Ranges {
  int row_lo, row_hi;    // this block's chunk rows
  int slot_lo, slot_hi;  // this block's pool slots
};

// Rows and slots a block owns: contiguous ranges, the slot ranges in
// whole 16-byte words of validity.
__device__ __forceinline__ int rows_per_block(const PoolApplyArgs& a,
                                              int G) {
  return (a.cap + G - 1) / G;
}

__device__ __forceinline__ int slots_per_block(const PoolApplyArgs& a,
                                               int G) {
  return (((a.S + G - 1) / G) + 15) & ~15;
}

__device__ __forceinline__ Ranges ranges_of(const PoolApplyArgs& a, int b,
                                            int G) {
  const int rows = rows_per_block(a, G);
  const int slots = slots_per_block(a, G);
  Ranges r;
  r.row_lo = min(b * rows, a.cap);
  r.row_hi = min(r.row_lo + rows, a.cap);
  r.slot_lo = static_cast<int>(
      min(static_cast<long long>(b) * slots, static_cast<long long>(a.S)));
  r.slot_hi = min(r.slot_lo + slots, a.S);
  return r;
}

// Free slots among the 16 starting at s (s a multiple of 16, below hi).
__device__ __forceinline__ int free_in_word(const PoolApplyArgs& a, int s,
                                            int hi, unsigned* bits) {
  unsigned m = 0;
  if (a.pv_aligned && s + 16 <= hi) {
    const uint4 w = __ldcg(reinterpret_cast<const uint4*>(a.pvalid + s));
    const unsigned q[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const unsigned z = __vcmpeq4(q[k], 0u);  // 0xff per free byte
#pragma unroll
      for (int j = 0; j < 4; ++j) m |= ((z >> (8 * j)) & 1u) << (4 * k + j);
    }
  } else {
    for (int j = 0; j < 16 && s + j < hi; ++j) {
      m |= (a.pvalid[s + j] == 0 ? 1u : 0u) << j;
    }
  }
  *bits = m;
  return __popc(m);
}

// Sum of `v` over the block, in every thread.
__device__ __forceinline__ int block_sum(int v) {
  int total;
  block_exclusive_scan(v, total);
  return total;
}

// Sums of block counts column `col` of bcount: the blocks before b, and all.
__device__ __forceinline__ void count_base(const PoolApplyArgs& a, int col,
                                          int b, int G, int* before,
                                          int* all) {
  int x = 0, y = 0;
  const volatile int* c = a.bcount + static_cast<long long>(col) * G;
  for (int i = threadIdx.x; i < G; i += NT) {
    const int v = c[i];
    y += v;
    if (i < b) x += v;
  }
  *before = block_sum(x);
  *all = block_sum(y);
}

// Rank of this thread's list item among the tile's earlier items of the
// same entry (the tile's entries in s_ent, in order).
__device__ __forceinline__ int tile_rank(const int* s_ent, int k, int e) {
  int before = 0;
  for (int j = 0; j < k; ++j) before += (s_ent[j] == e);
  return before;
}

__device__ __forceinline__ int surviving_deletes(const int* tins,
                                                 const int* tdel, int e) {
  return tdel[e] - min(tins[e], tdel[e]);
}

__global__ void __launch_bounds__(NT) topn_pool_grid(PoolApplyArgs a) {
  cg::grid_group grid = cg::this_grid();
  __shared__ int s_ent[NT];
  __shared__ RwPlanes s_planes;
  const int t = threadIdx.x;
  const int b = blockIdx.x;
  const int G = gridDim.x;
  const Ranges rg = ranges_of(a, b, G);
  int* tins = a.tcount;
  int* tdel = a.tcount + a.T;
  int* tcon = a.tcount + 2 * a.T;
  int* tmat = a.tcount + 3 * a.T;
  int* b_ins = a.bcount;
  int* b_con = a.bcount + G;
  int* b_cand = a.bcount + 2 * G;
  int* b_free = a.bcount + 3 * G;
  if (t == 0) rw_planes_of(a.cols, s_planes);

  // -- P1: a delete anywhere?  the block's inserts and free slots ---------
  int has_del = 0, n_ins = 0, n_free = 0;
  for (int r = rg.row_lo + t; r < rg.row_hi; r += NT) {
    if (a.valid[r]) {
      if (is_insert_op(a.ops[r])) {
        ++n_ins;
      } else {
        has_del = 1;
      }
    }
  }
  for (int s = rg.slot_lo + 16 * t; s < rg.slot_hi; s += 16 * NT) {
    unsigned bits;
    n_free += free_in_word(a, s, rg.slot_hi, &bits);
  }
  has_del = __syncthreads_or(has_del);
  n_ins = block_sum(n_ins);
  n_free = block_sum(n_free);
  if (t == 0) {
    b_ins[b] = n_ins;
    b_free[b] = n_free;
    if (has_del) atomicExch(&a.ctl[0], 1);
  }
  grid.sync();
  const bool any_del = *reinterpret_cast<volatile int*>(a.ctl) != 0;

  if (any_del) {
    // -- P2: the rows' hashes into the table, with their counts ----------
    for (int r = b * NT + t; r < a.cap; r += G * NT) {
      int e = -1;
      if (a.valid[r]) {
        bool rep;
        e = table_insert(a.tkey, a.T, a.hash[r], &rep);
        atomicAdd(is_insert_op(a.ops[r]) ? &tins[e] : &tdel[e], 1);
        e = e << 1 | (rep ? 1 : 0);
      }
      a.rent[r] = e;
    }
    grid.sync();
    // -- P3: contested inserts; the others survive -----------------------
    int n_con = 0, n_free_ins = 0;
    for (int r = rg.row_lo + t; r < rg.row_hi; r += NT) {
      const int e = a.rent[r];
      bool keep = false;
      if (e >= 0 && is_insert_op(a.ops[r])) {
        if (tdel[e >> 1] > 0) {
          ++n_con;
        } else {
          keep = true;
          ++n_free_ins;
        }
      }
      a.surv[r] = keep;
    }
    n_con = block_sum(n_con);
    n_free_ins = block_sum(n_free_ins);
    if (t == 0) {
      b_con[b] = n_con;
      b_ins[b] = n_free_ins;
    }
    grid.sync();
    // -- P4: the contested list (row order); candidate slots per block ---
    {
      int base, total;
      count_base(a, 1, b, G, &base, &total);
      for (int r0 = rg.row_lo; r0 < rg.row_hi; r0 += NT) {
        const int r = r0 + t;
        int e = -1;
        if (r < rg.row_hi) e = a.rent[r];
        const int c = (e >= 0 && is_insert_op(a.ops[r]) && tdel[e >> 1] > 0)
                          ? 1 : 0;
        int tile_total;
        const int k = block_exclusive_scan(c, tile_total);
        if (c) a.list[base + k] = r;
        base += tile_total;
      }
    }
    int n_cand = 0;
    for (int s = rg.slot_lo + t; s < rg.slot_hi; s += NT) {
      if (a.pvalid[s]) {
        const int e = table_find(a.tkey, a.T, a.phash[s]);
        n_cand += e >= 0 && surviving_deletes(tins, tdel, e) > 0;
      }
    }
    n_cand = block_sum(n_cand);
    if (t == 0) b_cand[b] = n_cand;
    grid.sync();
    // -- P5: the candidate list (slot order) -----------------------------
    {
      int base, total;
      count_base(a, 2, b, G, &base, &total);
      for (int s0 = rg.slot_lo; s0 < rg.slot_hi && total > 0; s0 += NT) {
        const int s = s0 + t;
        int c = 0;
        if (s < rg.slot_hi && a.pvalid[s]) {
          const int e = table_find(a.tkey, a.T, a.phash[s]);
          c = e >= 0 && surviving_deletes(tins, tdel, e) > 0;
        }
        int tile_total;
        const int k = block_exclusive_scan(c, tile_total);
        if (c) a.cand[base + k] = s;
        base += tile_total;
      }
    }
    grid.sync();
    // -- P6: ranks over the lists only -----------------------------------
    if (b == 0) {
      // contested inserts: keep iff the hash's earlier contested inserts
      // number at least its deletes
      int base, total;
      count_base(a, 1, b, G, &base, &total);
      for (int i0 = 0; i0 < total; i0 += NT) {
        const int i = i0 + t;
        const int r = i < total ? a.list[i] : -1;
        const int e = r >= 0 ? a.rent[r] >> 1 : -1;
        if (r >= 0) s_ent[t] = e;
        __syncthreads();
        bool keep = false;
        if (r >= 0) keep = tcon[e] + tile_rank(s_ent, t, e) >= tdel[e];
        __syncthreads();
        if (r >= 0) {
          atomicAdd(&tcon[e], 1);
          if (keep) {
            a.surv[r] = 1;
            atomicAdd(&b_ins[r / rows_per_block(a, G)], 1);
          }
        }
        __syncthreads();
      }
    }
    if (b == G - 1) {
      // candidate slots: clear iff the hash's earlier candidates number
      // fewer than its surviving deletes
      int base, total;
      count_base(a, 2, b, G, &base, &total);
      for (int i0 = 0; i0 < total; i0 += NT) {
        const int i = i0 + t;
        const int s = i < total ? a.cand[i] : -1;
        const int e = s >= 0 ? table_find(a.tkey, a.T, a.phash[s]) : -1;
        if (s >= 0) s_ent[t] = e;
        __syncthreads();
        bool clear = false;
        if (s >= 0) {
          clear = tmat[e] + tile_rank(s_ent, t, e) <
                  surviving_deletes(tins, tdel, e);
        }
        __syncthreads();
        if (s >= 0) {
          atomicAdd(&tmat[e], 1);
          if (clear) {
            a.pvalid[s] = 0;
            atomicAdd(&b_free[s / slots_per_block(a, G)], 1);
          }
        }
        __syncthreads();
      }
    }
    grid.sync();
  }

  // -- P7: the surviving inserts' ranks and the first free slots ---------
  int n_ins_all, n_free_all;
  {
    int base;
    count_base(a, 0, b, G, &base, &n_ins_all);
    for (int r0 = rg.row_lo; r0 < rg.row_hi; r0 += NT) {
      const int r = r0 + t;
      int c = 0;
      if (r < rg.row_hi) {
        c = any_del ? a.surv[r]
                    : (a.valid[r] != 0 && is_insert_op(a.ops[r]));
      }
      int tile_total;
      const int k = block_exclusive_scan(c, tile_total);
      if (c) a.ins_row[base + k] = r;
      base += tile_total;
    }
  }
  {
    int base;
    count_base(a, 3, b, G, &base, &n_free_all);
    for (int s0 = rg.slot_lo; s0 < rg.slot_hi && base < n_ins_all;
         s0 += 16 * NT) {
      const int s = s0 + 16 * t;
      unsigned bits = 0;
      const int c = s < rg.slot_hi ? free_in_word(a, s, rg.slot_hi, &bits)
                                   : 0;
      int tile_total;
      int k = base + block_exclusive_scan(c, tile_total);
      while (bits && k < n_ins_all) {
        const int j = __ffs(bits) - 1;
        bits &= bits - 1;
        a.sor[k++] = s + j;
      }
      base += tile_total;
    }
  }
  if (any_del) {
    // deletes that found no slot, once per hash (its representative row)
    long long miss = 0;
    for (int r = b * NT + t; r < a.cap; r += G * NT) {
      const int e = a.rent[r];
      if (e >= 0 && (e & 1)) {
        const int sd = surviving_deletes(tins, tdel, e >> 1);
        miss += max(0, sd - tmat[e >> 1]);
      }
    }
    const int m = block_sum(static_cast<int>(miss));
    if (t == 0 && m) {
      atomicAdd(reinterpret_cast<unsigned long long*>(a.inconsistency),
                static_cast<unsigned long long>(m));
    }
  }
  grid.sync();

  // -- P8: the claims and the row copy -----------------------------------
  const int placed = min(n_ins_all, n_free_all);
  const unsigned gt = static_cast<unsigned>(b) * NT + t;
  const unsigned gn = static_cast<unsigned>(G) * NT;
  for (int i = static_cast<int>(gt); i < placed; i += static_cast<int>(gn)) {
    const int slot = a.sor[i];
    a.pvalid[slot] = 1;
    a.phash[slot] = a.hash[a.ins_row[i]];
  }
  const int* ins_row = a.ins_row;
  const int* sor = a.sor;
  rw_copy_rows(
      s_planes, placed, [ins_row](int i) { return ins_row[i]; },
      [sor](int i) { return sor[i]; }, gt, gn);
  if (any_del) {
    for (int r = static_cast<int>(gt); r < a.cap; r += static_cast<int>(gn)) {
      const int e = a.rent[r];
      if (e >= 0 && (e & 1)) {
        const int x = e >> 1;
        a.tkey[x] = EMPTY_KEY;
        tins[x] = 0;
        tdel[x] = 0;
        tcon[x] = 0;
        tmat[x] = 0;
      }
    }
  }
  if (gt == 0) {
    a.overflow[0] += static_cast<long long>(n_ins_all - placed);
    a.ctl[0] = 0;
  }
}

extern "C" int rw_topn_pool_apply(PoolApplyArgs args, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  // the grid: every block co-resident (the most per card found once), no
  // more blocks than the rows and the pool's validity words need, and at
  // least two (P6 runs its two walks on the first and the last)
  static int most_of[64] = {0};
  int dev = 0;
  cudaGetDevice(&dev);
  int& most = most_of[dev & 63];
  if (most == 0) {
    int sms = 0, per_sm = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, topn_pool_grid,
                                                  NT, 0);
    if (per_sm < 1) return static_cast<int>(cudaErrorLaunchOutOfResources);
    most = sms * per_sm;
  }
  const long long by_rows = (static_cast<long long>(args.cap) + NT - 1) / NT;
  const long long by_slots =
      (static_cast<long long>(args.S) + 16 * NT - 1) / (16 * NT);
  long long need = by_rows > by_slots ? by_rows : by_slots;
  if (need > most) need = most;
  if (need > MAX_BLOCKS) need = MAX_BLOCKS;
  const int blocks = static_cast<int>(need < 2 ? 2 : need);
  void* params[] = {&args};
  cudaError_t rc = cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(topn_pool_grid), dim3(blocks), dim3(NT), params,
      0, s);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  return static_cast<int>(cudaGetLastError());
}
