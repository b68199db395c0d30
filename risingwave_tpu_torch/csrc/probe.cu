// Kernel B (K3): open-addressing find-or-claim probe of a chunk (sm_90a).
//
// Replaces risingwave_tpu/state/hash_table.py `HashTable._probe`
// (hash_table.py:236), the XLA while_loop behind `lookup`,
// `lookup_counted` and `lookup_or_insert`.  Keys compare as `_keys_equal`
// (:104) does: a string key passes as its [size, w] bytes and its lens, and
// equality is every one of the w bytes, the padding past lens included,
// and equal lens (the hash masks that padding; a key's bytes are copied
// whole when it claims a slot).
//
// The slot layout must equal the reference's.  Its rounds: within a round
// every pending row reads `occupied`, the key store and `tombstone` as they
// were at the round's start; a key match resolves the row; an occupied
// non-match or a tombstone advances its offset; a true-empty slot is a
// miss (lookup) or a claim (insert): claimants atomicMin their row index
// into claim[cand % (4 * cap)], a row wins only if the entry holds its own
// index, and losers re-check the same slot next round (so cross-slot
// scratch collisions delay a row by one round).  The loop stops when no row
// is pending or after max_iters = min(size + 2, 1024) rounds; rows still
// pending are overflow.
//
// Why two launches are exact: within one call, claims only turn TRUE-EMPTY
// slots into occupied ones; occupied slots, their keys and the tombstones
// never change.  So until a row reaches the first slot of its walk that was
// true-empty when the call began, its rounds are fixed and independent of
// every other row: in round k it is at offset k, it advances past occupied
// non-matches and tombstones and resolves on a key match.  Call that slot's
// offset the row's entry round o_r.  The reference's rounds are rebuilt
// exactly from the rows that entered by each round.
//
//   probe_walk   a grid, one thread a row: walks the call-start table up to
//                max_iters slots (an int64 key reads eight slots' flags and
//                keys at once: one dependent read per eight slots).  Hits
//                resolve, walks that run out overflow, and a true-empty
//                slot is a miss for a lookup (so a lookup is this one
//                launch) or, for an insert, appends (row, o_r) to the
//                claimant list (a warp-aggregated atomicAdd; the list's
//                order does not matter, winners are decided by row index).
//                The last block to finish (fence and ticket) writes the
//                overflow count.
//   probe_claim  the reference's rounds over the claimant list only, from
//                the smallest entry round; a row is active from round o_r.
//                A round has two phases: evaluate against the round-start
//                table (hits resolve, advances carry the new offset, claims
//                atomicMin); then each claim's winner writes `occupied` and
//                the key and frees its scratch entry at once (a loser reads
//                the winner's index or the free mark, never its own), and
//                the survivors are compacted into the other list, the next
//                round being the least round some survivor needs (rounds
//                where no row is active are skipped).  A cooperative grid
//                (co-resident, at most four rows of the chunk a thread, at
//                least two blocks)
//                runs the rounds with grid.sync() while the list is longer
//                than ONE_BLOCK_MAX (the block's 1024 threads; `grid_only`,
//                for checks, keeps every round on the grid); then every
//                block but block 0 returns, and block 0 goes on
//                with __syncthreads(), one row a thread in registers, the
//                claims meeting in shared memory.  The branch is read from
//                the list's length in device memory, the same in every
//                block: no host read.
//
// The claim scratch stays allocated between calls (the wrapper caches one per
// device and stream, sized for the largest chunk so far) and rests at
// RW_CLAIM_FREE, above every row index, with the control words (list
// lengths, next rounds, the walk's overflow sum and ticket) at their rest
// values: each call restores what it touched, so no call fills the 4 * cap
// entries.  The scratch's layout and the helpers the rounds share with K12's
// ranked insert are in rw_claim.cuh.  The kernels allocate nothing.
//
// Bound: bytes, what the chunk's data needs.  Every row's valid flag read
// and its outputs written (slot, inserted, overflow: 7 B); a valid row's
// home slot (4 B) and key (kw B) read and one probe read of the table
// (occupied, tombstone, key: kw + 2 B); a key + occupied write per claimed
// slot: cap * 7 + n_valid * (2 * kw + 6) + n_inserted * (kw + 1) bytes.
// What the kernels spend is latency: the walk a launch and its longest
// chain's reads, the rounds over the claimants only, each round a
// dependent read or two and two barriers.
#include <cooperative_groups.h>

#include "rw_claim.cuh"
#include "rw_probe.cuh"

namespace cg = cooperative_groups;

constexpr int WALK_THREADS = 256;
constexpr int CLAIM_THREADS = 1024;
// claimant lists up to this long run their rounds on block 0 alone, one
// row a thread
constexpr int ONE_BLOCK_MAX = CLAIM_THREADS;
static_assert(RW_TAIL_MAP >= 2 * CLAIM_THREADS, "claim map size");
// the listed rows the cooperative grid gives each thread in its first
// round, at most
constexpr int GRID_ROWS_PER_THREAD = 4;

struct ProbeArgs {
  RwCols keys;                 // in = chunk key cols, st = table key store
  const int32_t* start;        // [cap] h & (size - 1)
  const uint8_t* valid;        // [cap]
  uint8_t* occupied;           // [size], updated in place on claims
  const uint8_t* tombstone;    // [size]
  int32_t* slots;              // [cap] out (size = sentinel)
  uint8_t* inserted;           // [cap] out
  uint8_t* pending;            // [cap] out: 1 = unresolved = overflow at end
  int2* list;                  // [2 * cap] scratch: (row, offset) lists
  int32_t* cand;               // [cap] scratch: a list position's claim
  int32_t* claim;              // [4 * cap] persistent, at RW_CLAIM_FREE
  int32_t* ctl;                // [16] persistent control words
  long long* n_over;           // [1] out: rows left pending
  int cap;
  int size;
  int insert;
  int max_iters;
  int grid_only;               // 1: every claim round on the grid (checks)
};

#define RW_WALK_EMPTY -1  // walk outcomes besides a hit's slot
#define RW_WALK_OVER -2

// The walk of one row from its home slot s0 over the call-start table:
// the slot of its key, RW_WALK_EMPTY at the first true-empty slot (its
// offset in *entry) or RW_WALK_OVER after max_iters slots.  A single
// 8-byte key column without nulls (an int64 key) loads eight slots' flags
// and keys at once, so a chain costs one dependent read per eight slots;
// other keys step a slot at a time through rw_probe_step.
__device__ __forceinline__ int walk_row(const ProbeArgs& a, bool word8,
                                        int s0, long long r, int* entry) {
  const int mask = a.size - 1;
  if (word8) {
    const uint64_t key = static_cast<const uint64_t*>(a.keys.in_data[0])[r];
    const uint64_t* st = static_cast<const uint64_t*>(a.keys.st_data[0]);
    for (int off0 = 0; off0 < a.max_iters; off0 += 8) {
      uint8_t occ[8], tomb[8];
      uint64_t kk[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = (s0 + off0 + j) & mask;
        occ[j] = a.occupied[c];
        tomb[j] = a.tombstone[c];
        kk[j] = st[c];
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (off0 + j >= a.max_iters) return RW_WALK_OVER;
        if (occ[j]) {
          if (kk[j] == key) return (s0 + off0 + j) & mask;
        } else if (!tomb[j]) {
          *entry = off0 + j;
          return RW_WALK_EMPTY;
        }
      }
    }
    return RW_WALK_OVER;
  }
  for (int off = 0; off < a.max_iters; ++off) {
    const int c = (s0 + off) & mask;
    const int s = rw_probe_step(a.keys, a.occupied, a.tombstone, c, r);
    if (s == RW_PROBE_HIT) return c;
    if (s == RW_PROBE_EMPTY) {
      *entry = off;
      return RW_WALK_EMPTY;
    }
  }
  return RW_WALK_OVER;
}

__global__ void __launch_bounds__(WALK_THREADS) probe_walk(ProbeArgs a) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const bool word8 = a.keys.n == 1 && a.keys.width[0] == 8 &&
                     a.keys.kind[0] == RW_KIND_WORD &&
                     a.keys.st_null[0] == nullptr;
  int n_over = 0;
  int k0 = INT_MAX;
  // warp-uniform trip count: every lane runs every iteration
  for (long long w = static_cast<long long>(blockIdx.x) * blockDim.x +
                     (threadIdx.x & ~31);
       w < a.cap; w += stride) {
    const long long r = w + lane;
    bool claimant = false;
    int entry = 0;
    if (r < a.cap) {
      int slot = a.size;
      bool over = false;
      if (a.valid[r]) {
        const int res = walk_row(a, word8, a.start[r], r, &entry);
        if (res >= 0) {
          slot = res;
        } else if (res == RW_WALK_EMPTY) {
          claimant = a.insert != 0;
        } else {
          over = true;
        }
      }
      a.slots[r] = slot;
      a.inserted[r] = 0;
      a.pending[r] = over || claimant;
      n_over += over;
      if (claimant && entry < k0) k0 = entry;
    }
    rw_warp_append(claimant, make_int2(static_cast<int>(r), entry), a.list,
                   &a.ctl[RW_CTL_LEN0]);
  }
  // the claimants' least entry round, one atomic a warp
  k0 = rw_warp_min(k0);
  if (lane == 0 && k0 != INT_MAX) atomicMin(&a.ctl[RW_CTL_K0], k0);
  // the overflow count: one atomic a block, the last block writes it
  __shared__ int s_over[WALK_THREADS / 32];
  __shared__ bool s_last;
  n_over = rw_warp_sum(n_over);
  if (lane == 0) s_over[warp] = n_over;
  __syncthreads();
  if (threadIdx.x == 0) {
    int tot = 0;
    for (int i = 0; i < WALK_THREADS / 32; ++i) tot += s_over[i];
    if (tot) atomicAdd(&a.ctl[RW_CTL_WOVER], tot);
    __threadfence();
    s_last = atomicAdd(&a.ctl[RW_CTL_TICKET], 1) ==
             static_cast<int>(gridDim.x) - 1;
  }
  __syncthreads();
  if (s_last && threadIdx.x == 0) {
    __threadfence();
    a.n_over[0] = atomicExch(&a.ctl[RW_CTL_WOVER], 0);
    a.ctl[RW_CTL_TICKET] = 0;
  }
}

// A claimant wins its slot: the key and `occupied` written, the row
// resolved.  The winner frees its scratch entry at once: a loser of the
// entry reads the winner's index or the free mark, never its own.
__device__ __forceinline__ void win_slot(const ProbeArgs& a, int c, int r,
                                         int m) {
  a.occupied[c] = 1;
  rw_store_row(a.keys, c, r);
  a.slots[r] = c;
  a.inserted[r] = 1;
  a.pending[r] = 0;
  a.claim[c % m] = RW_CLAIM_FREE;
}

// Block 0's last rounds, over at most blockDim.x listed rows, one a thread
// in registers.  The claims meet in shared memory: a map per round parity
// from the scratch index c % (4 * cap) to the least claiming row (the
// global scratch's contest, so the global scratch is not touched), each
// entry freed the round after by its claimants.  An int64 key loads its
// slot's flags and key at once.  Returns the rounds run and the rows left
// (overflow) in *n_left.
__device__ int claim_tail(const ProbeArgs& a, const int2* list, int L,
                          int k, int* n_left) {
  __shared__ int s_keys[2][RW_TAIL_MAP];
  __shared__ int s_rows[2][RW_TAIL_MAP];
  __shared__ int s_next[2];
  const int t = threadIdx.x;
  const int m = 4 * a.cap;
  const int mask = a.size - 1;
  const bool word8 = a.keys.n == 1 && a.keys.width[0] == 8 &&
                     a.keys.kind[0] == RW_KIND_WORD &&
                     a.keys.st_null[0] == nullptr;
  for (int i = t; i < RW_TAIL_MAP; i += blockDim.x) {
    s_keys[0][i] = s_keys[1][i] = -1;
    s_rows[0][i] = s_rows[1][i] = INT_MAX;
  }
  if (t < 2) s_next[t] = INT_MAX;
  bool live = t < L;
  int r = 0, off = 0, s0 = 0, mine = -1;
  uint64_t key = 0;
  if (live) {
    const int2 e = list[t];
    r = e.x;
    off = e.y;
    s0 = a.start[r];
    if (word8) key = static_cast<const uint64_t*>(a.keys.in_data[0])[r];
  }
  __syncthreads();
  int rounds = 0;
  while (k < a.max_iters) {
    const int p = rounds & 1;
    // last round's map: free the entry this row claimed in it
    if (mine >= 0) {
      s_keys[p ^ 1][mine] = -1;
      s_rows[p ^ 1][mine] = INT_MAX;
      mine = -1;
    }
    // phase A: the row against the round-start table
    if (live && off <= k) {
      const int c = (s0 + off) & mask;
      int s;
      if (word8) {
        const uint8_t occ = a.occupied[c];
        const uint8_t tomb = a.tombstone[c];
        const uint64_t kv = static_cast<const uint64_t*>(a.keys.st_data[0])[c];
        s = occ ? (kv == key ? RW_PROBE_HIT : RW_PROBE_NEXT)
                : (tomb ? RW_PROBE_NEXT : RW_PROBE_EMPTY);
      } else {
        s = rw_probe_step(a.keys, a.occupied, a.tombstone, c, r);
      }
      if (s == RW_PROBE_HIT) {
        a.slots[r] = c;
        a.pending[r] = 0;
        live = false;
      } else if (s == RW_PROBE_EMPTY) {
        mine = rw_map_claim(s_keys[p], s_rows[p], c % m, r);
      } else {
        ++off;
      }
    }
    // this round's word was last read two barriers ago
    if (t == 0) s_next[p] = INT_MAX;
    __syncthreads();
    // phase B: the least claimant of each scratch index wins its slot
    if (mine >= 0 && s_rows[p][mine] == r) {
      const int c = (s0 + off) & mask;
      a.occupied[c] = 1;
      rw_store_row(a.keys, c, r);
      a.slots[r] = c;
      a.inserted[r] = 1;
      a.pending[r] = 0;
      live = false;
    }
    int need = live ? (off > k ? off : k + 1) : INT_MAX;
    need = rw_warp_min(need);
    if ((t & 31) == 0 && need != INT_MAX) atomicMin(&s_next[p], need);
    __syncthreads();
    k = s_next[p];
    ++rounds;
  }
  *n_left = __syncthreads_count(live);
  return rounds;
}

__global__ void __launch_bounds__(CLAIM_THREADS) probe_claim(ProbeArgs a) {
  volatile int* ctl = a.ctl;
  int L = ctl[RW_CTL_LEN0];
  const int n_claimants = L;
  int k = ctl[RW_CTL_K0];
  const int one_block_max = a.grid_only ? 0 : ONE_BLOCK_MAX;
  bool grid_mode = L > one_block_max;
  if (!grid_mode && blockIdx.x != 0) return;
  if (L == 0) {
    if (threadIdx.x == 0) {
      ctl[RW_CTL_CLAIMANTS] = 0;
      ctl[RW_CTL_GRID_ROUNDS] = 0;
      ctl[RW_CTL_BLOCK_ROUNDS] = 0;
    }
    return;
  }
  cg::grid_group grid = cg::this_grid();
  const int lane = threadIdx.x & 31;
  const int m = 4 * a.cap;
  const int mask = a.size - 1;
  const int base = blockIdx.x * blockDim.x + (threadIdx.x & ~31);
  const int stride = gridDim.x * blockDim.x;
  int j = 0;  // grid rounds run; list j & 1 is the current one
  // -- rounds over the listed rows on the whole grid ----------------------
  while (grid_mode) {
    const int cur = j & 1;
    int2* list = a.list + static_cast<long long>(cur) * a.cap;
    int2* next = a.list + static_cast<long long>(cur ^ 1) * a.cap;
    // phase A: every active row against the round-start table; the next
    // list's length and this round's next-round word start over (every
    // block read them two barriers ago)
    if (blockIdx.x == 0 && threadIdx.x == 0) {
      ctl[RW_CTL_LEN0 + (cur ^ 1)] = 0;
      ctl[RW_CTL_NEXT0 + cur] = INT_MAX;
    }
    for (int w = base; w < L; w += stride) {
      const int i = w + lane;
      if (i >= L) continue;
      int2 e = list[i];
      int cd = -1;  // -1 survives as it is, -2 resolved, >= 0 claims cd
      if (e.y <= k) {
        const int r = e.x;
        const int c = (a.start[r] + e.y) & mask;
        const int s = rw_probe_step(a.keys, a.occupied, a.tombstone, c, r);
        if (s == RW_PROBE_HIT) {
          a.slots[r] = c;
          a.pending[r] = 0;
          cd = -2;
        } else if (s == RW_PROBE_EMPTY) {
          cd = c;
          atomicMin(&a.claim[c % m], r);
        } else {
          e.y += 1;
          list[i] = e;
        }
      }
      a.cand[i] = cd;
    }
    grid.sync();
    // phase B: the lowest claimant of each scratch entry wins its slot;
    // the survivors move to the next list
    int need = INT_MAX;
    for (int w = base; w < L; w += stride) {
      const int i = w + lane;
      bool keep = false;
      int2 e = make_int2(0, 0);
      if (i < L) {
        e = list[i];
        const int c = a.cand[i];
        if (c >= 0 && a.claim[c % m] == e.x) {
          win_slot(a, c, e.x, m);
        } else if (c != -2) {
          keep = true;
          const int nk = e.y > k ? e.y : k + 1;
          need = nk < need ? nk : need;
        }
      }
      rw_warp_append(keep, e, next, &a.ctl[RW_CTL_LEN0 + (cur ^ 1)]);
    }
    rw_block_into<RW_RED_MIN>(need, &a.ctl[RW_CTL_NEXT0 + cur]);
    grid.sync();
    k = ctl[RW_CTL_NEXT0 + cur];
    L = ctl[RW_CTL_LEN0 + (cur ^ 1)];
    ++j;
    if (k >= a.max_iters) break;
    if (L <= one_block_max) {
      grid_mode = false;
      if (blockIdx.x != 0) return;
    }
  }
  if (blockIdx.x != 0) return;
  // -- block 0 alone, the listed rows in registers -----------------------
  int n_left = L;
  int tail_rounds = 0;
  if (k < a.max_iters) {
    tail_rounds = claim_tail(a, a.list + static_cast<long long>(j & 1) *
                                            a.cap, L, k, &n_left);
  }
  if (threadIdx.x != 0) return;
  // rows still listed ran out of rounds: overflow (pending stays 1)
  atomicAdd(reinterpret_cast<unsigned long long*>(a.n_over),
            static_cast<unsigned long long>(n_left));
  ctl[RW_CTL_CLAIMANTS] = n_claimants;
  ctl[RW_CTL_GRID_ROUNDS] = j;
  ctl[RW_CTL_BLOCK_ROUNDS] = tail_rounds;
  ctl[RW_CTL_LEN0] = 0;
  ctl[RW_CTL_LEN1] = 0;
  ctl[RW_CTL_NEXT0] = INT_MAX;
  ctl[RW_CTL_NEXT1] = INT_MAX;
  ctl[RW_CTL_K0] = INT_MAX;
}

extern "C" int rw_probe(ProbeArgs args, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  long long want = (static_cast<long long>(args.cap) + WALK_THREADS - 1) /
                   WALK_THREADS;
  if (want < 1) want = 1;  // one block writes n_over on an empty chunk
  const int walk_blocks = static_cast<int>(want < 8192 ? want : 8192);
  probe_walk<<<walk_blocks, WALK_THREADS, 0, s>>>(args);
  cudaError_t rc = cudaGetLastError();
  if (rc != cudaSuccess || !args.insert || args.cap == 0) {
    return static_cast<int>(rc);
  }
  // the persistent grid: every block co-resident (the most per card found
  // once), no more blocks than the chunk's rows need, and at least two
  static int most_of[64] = {0};
  int dev = 0;
  cudaGetDevice(&dev);
  int& most = most_of[dev & 63];
  if (most == 0) {
    int sms = 0, per_sm = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, probe_claim,
                                                  CLAIM_THREADS, 0);
    if (per_sm < 1) return static_cast<int>(cudaErrorLaunchOutOfResources);
    most = sms * per_sm;
  }
  const long long need = (static_cast<long long>(args.cap) +
                          GRID_ROWS_PER_THREAD * CLAIM_THREADS - 1) /
                         (GRID_ROWS_PER_THREAD * CLAIM_THREADS);
  int blocks = static_cast<int>(need < most ? need : most);
  if (blocks < 2) blocks = 2;
  void* params[] = {&args};
  rc = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(probe_claim),
                                   dim3(blocks), dim3(CLAIM_THREADS), params,
                                   0, s);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  return static_cast<int>(cudaGetLastError());
}
