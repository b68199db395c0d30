// Kernel K12: the join's tag-table probes (sm_90a).
//
// Replaces risingwave_tpu/state/hash_table.py `TagTable._probe_tags`
// (:450, behind `lookup_pair_counted` :514 and `rehashed` :686) and
// `TagTable.lookup_or_insert_ranked` (:525): open addressing over one
// 64-bit tag per slot, EMPTY = 0 and TOMB = 1, the home slot of a tag being
// tag & (size - 1).
//
// The slot layout must equal the reference's, so the inserts replay its
// rounds: within a round every pending row reads the table as it was at
// the round's start; a row that meets an empty slot it wants claims it by
// atomicMin of its row index into scratch[cand % (4 * cap)], the lowest row
// wins, and losers re-check the same slot next round.  The loop stops when
// no row is pending or after the reference's round bound (the unrolled
// first round counted); rows still pending are overflow.
//
// Three entry points:
//   rw_tag_lookup         a lookup (`_probe_tags`, insert=False): a lookup
//                         never writes the table, so one thread walks each
//                         row's chain up to min(size + 2, 1024) slots and
//                         gets the reference's result.  Tags are given, or
//                         computed in-kernel as pair_tag(hash, rank).
//   rw_tag_insert         an insert (`_probe_tags`, insert=True: the rehash
//                         of a whole table, cap = size).  One cooperative
//                         grid: the three phases of a round (read and
//                         claim, resolve, reset and count) are separated by
//                         grid-wide barriers, so the rounds stay exact at
//                         any number of rows.
//   rw_tag_insert_ranked  `lookup_or_insert_ranked` for a chunk of rows,
//                         bound min(2 * size + 4, 1024).  Phase 1 resolves
//                         the key's head (hash, 0) and reads the pre-chunk
//                         degree there; the row then switches its target to
//                         (hash, degree + chunk_rank) and finds or claims it
//                         (phase 2).  One cooperative launch,
//                         `ranked_insert`, in two parts (probe.cu's design,
//                         whose walk and rounds are two launches):
//     the walk      the grid, a thread a row, over the call-start table.
//                   Claims only turn slots that were true-empty at the
//                   call's start into occupied ones, and never change a tag
//                   or tombstone that was there, so a row's rounds are fixed
//                   up to the first such slot of its walk, in either phase:
//                   it advances a slot a round, at a head match reads the
//                   degree (rank 0: resolved, `existed`; else a round to
//                   switch) and in phase 2 resolves on a match (a stranded
//                   entry).  Rows that resolve so are done; the others are
//                   listed as (row, offset, target, round), the round being
//                   the one in which they read that empty slot.  grid.sync.
//     the rounds    the reference's rounds over the list only, from its
//                   least round; a row acts in the round it waits for.  It
//                   reads its slot against the round-start table: if the
//                   slot was claimed meanwhile it walks on as above (a
//                   phase-1 row of chunk rank > 0 may so meet its key's head
//                   claimed earlier in the call and read the degree there),
//                   and it waits again at the next empty slot; if the slot
//                   is still empty, a phase-1 row of chunk rank > 0 switches
//                   to (hash, chunk rank) with degree 0, and a rank-0 or
//                   phase-2 row claims it (the lowest row index of
//                   claim[c % (4 * cap)] wins, cross-slot collisions
//                   included; a loser re-reads its slot next round).  The
//                   walk over non-empty slots skips the rounds in which a
//                   row only advances, and the rounds where no listed row
//                   acts are skipped.  The grid runs the rounds with
//                   grid.sync() while more than RANK_ONE_BLOCK_MAX rows
//                   are listed, then block 0 alone, one row a thread, the
//                   claims meeting in shared memory; `grid_only` (checks)
//                   keeps every round on the grid.  `iters` is the
//                   reference's: the last round in which a row resolved,
//                   plus one (at least 1), or the bound if any row ran out.
//                   The claim scratch and the control words are the
//                   probe's (rw_claim.cuh): cached per device and stream,
//                   left at rest by every call, no host read.
//
// Bound: the work is a few dependent random 8-byte reads per row per
// round, so the kernels are latency-bound; by bytes, a chunk of 8192 rows
// moves well under 1 MB and the 2^22-slot rehash ~32 MB of tags read,
// written and scanned, tens of microseconds at HBM rate.
#include <cooperative_groups.h>

#include "rw_claim.cuh"
#include "rw_common.cuh"

namespace cg = cooperative_groups;

struct TagLookupArgs {
  const long long* keys;  // [cap] tags, or key hashes when ranks != null
  const int* ranks;       // [cap] or null
  const uint8_t* valid;   // [cap]
  const long long* tags;  // [size]
  int* slots;             // [cap] out (size = sentinel)
  uint8_t* found;         // [cap] out
  uint8_t* overflow;      // [cap] out: still pending after the bound
  long long* n_over;      // [1] out, zeroed by the caller: valid overflows
  int cap;
  int size;
  int max_iters;
};

__global__ void tag_lookup_kernel(TagLookupArgs a) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= a.cap) return;
  const int mask = a.size - 1;
  int slot = a.size;
  bool done = a.valid[r] == 0;
  bool hit = false;
  if (!done) {
    const uint64_t tag =
        a.ranks != nullptr
            ? rw_pair_tag(static_cast<uint64_t>(a.keys[r]), a.ranks[r])
            : static_cast<uint64_t>(a.keys[r]);
    int off = 0;
    const int home = static_cast<int>(tag & static_cast<uint64_t>(mask));
    for (int it = 0; it < a.max_iters; ++it) {
      const int c = (home + off) & mask;
      const uint64_t t = static_cast<uint64_t>(a.tags[c]);
      if (t == tag) {
        slot = c;
        hit = true;
        done = true;
        break;
      }
      if (t == RW_EMPTY_TAG) {  // true-empty slot: the entry is absent
        done = true;
        break;
      }
      ++off;  // another tag or a tombstone: keep probing
    }
    if (!done) atomicAdd(reinterpret_cast<unsigned long long*>(a.n_over), 1ull);
  }
  a.slots[r] = slot;
  a.found[r] = hit;
  a.overflow[r] = !done;
}

extern "C" int rw_tag_lookup(TagLookupArgs args, void* stream) {
  if (args.cap > 0) {
    const int threads = 256;
    const int blocks = (args.cap + threads - 1) / threads;
    tag_lookup_kernel<<<blocks, threads, 0,
                        static_cast<cudaStream_t>(stream)>>>(args);
  }
  return static_cast<int>(cudaGetLastError());
}

struct TagInsertArgs {
  const long long* keys;  // [cap] tags to find or claim
  const uint8_t* valid;   // [cap]
  long long* tags;        // [size], claims written in place
  int* slots;             // [cap] out
  uint8_t* inserted;      // [cap] out
  uint8_t* pending;       // [cap] out: 1 = overflow at the end
  int* off;               // [cap] scratch
  int* cand;              // [cap] scratch
  uint8_t* want;          // [cap] scratch
  int* claim;             // [min(4 * cap, size)] scratch
  int* counts;            // [2] pending counts, zeroed by the caller
  long long* n_over;      // [1] out, zeroed by the caller
  int cap;
  int size;
  int max_iters;
};

constexpr int INSERT_THREADS = 512;

__device__ __forceinline__ int block_sum(int v) {
  __shared__ int s_sum;
  if (threadIdx.x == 0) s_sum = 0;
  __syncthreads();
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  if ((threadIdx.x & 31) == 0 && v) atomicAdd(&s_sum, v);
  __syncthreads();
  const int out = s_sum;
  __syncthreads();
  return out;
}

__global__ void __launch_bounds__(INSERT_THREADS)
    tag_insert_kernel(TagInsertArgs a) {
  cg::grid_group grid = cg::this_grid();
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long t0 = static_cast<long long>(blockIdx.x) * blockDim.x +
                       threadIdx.x;
  const int mask = a.size - 1;
  // scratch index of slot c is c % (4 * cap); the scratch has
  // min(4 * cap, size) entries, enough for every index that occurs
  const long long m4 = 4ll * a.cap;
  const int n_claim = m4 < a.size ? static_cast<int>(m4) : a.size;
  for (long long j = t0; j < n_claim; j += stride) a.claim[j] = a.cap;
  int local = 0;
  for (long long r = t0; r < a.cap; r += stride) {
    const uint8_t p = a.valid[r] != 0;
    a.pending[r] = p;
    a.off[r] = 0;
    a.slots[r] = a.size;
    a.inserted[r] = 0;
    a.want[r] = 0;
    local += p;
  }
  local = block_sum(local);
  if (threadIdx.x == 0 && local) atomicAdd(&a.counts[0], local);
  grid.sync();
  int any = *reinterpret_cast<volatile int*>(&a.counts[0]);
  for (int it = 0; any && it < a.max_iters; ++it) {
    // phase 1: every pending row against the round-start table
    for (long long r = t0; r < a.cap; r += stride) {
      if (!a.pending[r]) continue;
      const uint64_t tag = static_cast<uint64_t>(a.keys[r]);
      const int c =
          (static_cast<int>(tag & static_cast<uint64_t>(mask)) + a.off[r]) &
          mask;
      const uint64_t t = static_cast<uint64_t>(a.tags[c]);
      if (t == tag) {
        a.slots[r] = c;
        a.pending[r] = 0;
      } else if (t == RW_EMPTY_TAG) {
        a.want[r] = 1;
        a.cand[r] = c;
        atomicMin(&a.claim[static_cast<long long>(c) % m4],
                  static_cast<int>(r));
      } else {
        a.off[r] += 1;
      }
    }
    grid.sync();
    // phase 2: the lowest claimant of each scratch entry wins its slot
    if (t0 == 0) a.counts[it & 1] = 0;  // read before this round's barrier
    for (long long r = t0; r < a.cap; r += stride) {
      if (!a.want[r]) continue;
      const int c = a.cand[r];
      if (a.claim[static_cast<long long>(c) % m4] == static_cast<int>(r)) {
        a.tags[c] = a.keys[r];
        a.slots[r] = c;
        a.inserted[r] = 1;
        a.pending[r] = 0;
      }
    }
    grid.sync();
    // phase 3: reset the touched scratch entries, count the pending rows
    local = 0;
    for (long long r = t0; r < a.cap; r += stride) {
      if (a.want[r]) {
        a.claim[static_cast<long long>(a.cand[r]) % m4] = a.cap;
        a.want[r] = 0;
      }
      local += a.pending[r];
    }
    local = block_sum(local);
    if (threadIdx.x == 0 && local) atomicAdd(&a.counts[(it + 1) & 1], local);
    grid.sync();
    any = *reinterpret_cast<volatile int*>(&a.counts[(it + 1) & 1]);
  }
  local = 0;
  for (long long r = t0; r < a.cap; r += stride) local += a.pending[r];
  local = block_sum(local);
  if (threadIdx.x == 0 && local) {
    atomicAdd(reinterpret_cast<unsigned long long*>(a.n_over),
              static_cast<unsigned long long>(local));
  }
}

extern "C" int rw_tag_insert(TagInsertArgs args, void* stream) {
  if (args.cap <= 0) return static_cast<int>(cudaGetLastError());
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, tag_insert_kernel,
                                                INSERT_THREADS, 0);
  if (per_sm < 1) return static_cast<int>(cudaErrorLaunchOutOfResources);
  long long want = (args.cap + INSERT_THREADS - 1) / INSERT_THREADS;
  const long long most = static_cast<long long>(sms) * per_sm;
  const int blocks = static_cast<int>(want < most ? want : most);
  void* params[] = {&args};
  const cudaError_t rc = cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(tag_insert_kernel), dim3(blocks),
      dim3(INSERT_THREADS), params, 0, static_cast<cudaStream_t>(stream));
  if (rc != cudaSuccess) return static_cast<int>(rc);
  return static_cast<int>(cudaGetLastError());
}


// ---------------------------------------------------------------------------
// rw_tag_insert_ranked: a grid walk, then the reference's rounds over the
// rows that reach a true-empty slot (see the header).

struct TagRankedArgs {
  const long long* hashes;   // [cap] key hashes
  const int* chunk_rank;     // [cap] rank among the chunk's rows of the key
  const int* degree;         // [size] key degree at its head slot (read)
  const uint8_t* valid;      // [cap]
  long long* tags;           // [size], claims written in place
  int* slots;                // [cap] out
  int* target;               // [cap] out: resolved rank
  int* head_slot;            // [cap] out
  uint8_t* inserted;         // [cap] out
  uint8_t* existed;          // [cap] out
  uint8_t* pending;          // [cap] out: 1 = overflow at the end
  int* iters;                // [1] out: rounds run
  int4* list;                // [2 * cap] scratch: (row, off, target, round)
  int* cand;                 // [cap] scratch: a list position's claim
  int* claim;                // [4 * cap] persistent, at RW_CLAIM_FREE
  int* ctl;                  // [16] persistent control words (rw_claim.cuh)
  int cap;
  int size;
  int max_iters;
  int grid_only;             // 1: every listed round on the grid (checks)
};

constexpr int RANK_THREADS = 1024;
// lists up to this long run their rounds on block 0 alone, one row a thread
constexpr int RANK_ONE_BLOCK_MAX = RANK_THREADS;
static_assert(RW_TAIL_MAP >= 2 * RANK_THREADS, "claim map size");

// Where a row's walk stands: the offset into its target's chain, the target
// (0 in phase 1, the head; the rank in phase 2) and the round in which it
// reads that slot; and what it met on the way.
struct RankWalk {
  int off;
  int target;
  int k;
  int head;  // the head slot it matched on this walk, -1 if none
  int slot;  // RK_DONE: the entry's slot; RK_WAIT: the empty slot
};

#define RK_DONE 0   // the target entry exists: resolved in round k
#define RK_OVER 1   // out of rounds (or a head match whose rank is < 0)
#define RK_WAIT 2   // at a slot that was empty when read, in round k
#define RK_CLAIM 3  // claims its slot in this round

// The row's rounds from round w.k over the table as it stands.  Claims only
// fill true-empty slots and never change a tag that is there, so every slot
// read non-empty now reads the same in every later round: the walk goes on
// through them (an advance a round; a head match reads the pre-chunk degree
// and, at rank > 0, costs a round to switch to the phase-2 target) and stops
// at the first empty one, whose round decides what it holds then.
__device__ __forceinline__ int rank_walk(const TagRankedArgs& a, RankWalk& w,
                                         uint64_t h, int crank) {
  const int mask = a.size - 1;
  uint64_t tt = rw_pair_tag(h, w.target);
  while (w.k < a.max_iters) {
    const int c =
        (static_cast<int>(tt & static_cast<uint64_t>(mask)) + w.off) & mask;
    const uint64_t t = static_cast<uint64_t>(__ldcg(&a.tags[c]));
    if (t == RW_EMPTY_TAG) {
      w.slot = c;
      return RK_WAIT;
    }
    if (t == tt) {
      if (w.target != 0) {  // phase 2: a stranded entry
        w.slot = c;
        return RK_DONE;
      }
      w.head = c;
      const int nr = static_cast<int>(static_cast<unsigned>(a.degree[c]) +
                                      static_cast<unsigned>(crank));
      if (nr == 0) {  // the target IS the head, already present
        w.slot = c;
        return RK_DONE;
      }
      if (nr < 0) return RK_OVER;  // matches the head every round
      w.target = nr;
      tt = rw_pair_tag(h, nr);
      w.off = 0;
    } else {
      ++w.off;  // another tag or a tombstone
    }
    ++w.k;
  }
  return RK_OVER;
}

// A listed row's round k (it waits at round k): its walk from there, and at
// a slot still empty in round k the reference's move: a phase-1 row of
// chunk rank > 0 learns that its key is absent (degree 0) and walks to
// (hash, chunk rank) from the next round; a rank-0 row or a phase-2 row
// claims the slot (w.slot).
__device__ __forceinline__ int rank_step(const TagRankedArgs& a, RankWalk& w,
                                         uint64_t h, int crank, int k) {
  const int res = rank_walk(a, w, h, crank);
  if (res != RK_WAIT || w.k != k) return res;
  if (w.target == 0 && crank > 0) {
    w.target = crank;
    w.off = 0;
    ++w.k;
    return rank_walk(a, w, h, crank);
  }
  if (w.target == 0 && crank < 0) {  // neither switches nor claims
    ++w.k;
    return RK_WAIT;
  }
  return RK_CLAIM;
}

// A listed row's outputs after a step that did not claim.
__device__ __forceinline__ void rank_settle(const TagRankedArgs& a, int r,
                                            const RankWalk& w, int res) {
  if (w.head >= 0) a.head_slot[r] = w.head;
  a.target[r] = w.target;
  if (res == RK_DONE) {
    a.slots[r] = w.slot;
    a.existed[r] = 1;
    a.pending[r] = 0;
  }
}

// A claimant wins slot c: its tag written, the row resolved.
__device__ __forceinline__ void rank_win(const TagRankedArgs& a, int c, int r,
                                         int target, uint64_t h) {
  a.tags[c] = static_cast<long long>(rw_pair_tag(h, target));
  a.slots[r] = c;
  if (target == 0) a.head_slot[r] = c;
  a.inserted[r] = 1;
  a.pending[r] = 0;
}

// The walk of every row over the call-start table, a thread a row (grid
// stride): rows that resolve are written, the others listed.
__device__ void ranked_walk(const TagRankedArgs& a) {
  const int lane = threadIdx.x & 31;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  int k0 = INT_MAX, last = 0, n_over = 0;
  // warp-uniform trip count: every lane runs every iteration
  for (long long wb = static_cast<long long>(blockIdx.x) * blockDim.x +
                      (threadIdx.x & ~31);
       wb < a.cap; wb += stride) {
    const long long r = wb + lane;
    bool listed = false;
    RankWalk w{0, 0, 0, -1, -1};
    if (r < a.cap) {
      int slot = a.size;
      uint8_t existed = 0, pend = 0;
      if (a.valid[r]) {
        const int res = rank_walk(a, w, static_cast<uint64_t>(a.hashes[r]),
                                  a.chunk_rank[r]);
        if (res == RK_DONE) {
          slot = w.slot;
          existed = 1;
          last = max(last, w.k + 1);
        } else {
          pend = 1;
          if (res == RK_OVER) {
            ++n_over;
          } else {
            listed = true;
            k0 = min(k0, w.k);
          }
        }
      }
      a.slots[r] = slot;
      a.target[r] = w.target;
      a.head_slot[r] = w.head >= 0 ? w.head : a.size;
      a.inserted[r] = 0;
      a.existed[r] = existed;
      a.pending[r] = pend;
    }
    rw_warp_append(listed, make_int4(static_cast<int>(r), w.off, w.target,
                                     w.k),
                   a.list, &a.ctl[RW_CTL_LEN0]);
  }
  rw_block_min_max_sum(k0, &a.ctl[RW_CTL_K0], last, &a.ctl[RW_CTL_RANK_LAST],
                       n_over, &a.ctl[RW_CTL_RANK_OVER]);
}

// Block 0's last rounds, over at most blockDim.x listed rows, one a thread
// in registers, the claims meeting in shared memory (rw_map_claim: the
// global scratch is not touched).  Returns the rounds run; *n_over gets the
// rows that ran out of rounds.
__device__ int ranked_tail(const TagRankedArgs& a, const int4* list, int L,
                           int k, int* n_over) {
  __shared__ int s_keys[2][RW_TAIL_MAP];
  __shared__ int s_rows[2][RW_TAIL_MAP];
  __shared__ int s_next[2];
  const int t = threadIdx.x;
  const int m = 4 * a.cap;
  for (int i = t; i < RW_TAIL_MAP; i += blockDim.x) {
    s_keys[0][i] = s_keys[1][i] = -1;
    s_rows[0][i] = s_rows[1][i] = INT_MAX;
  }
  if (t < 2) s_next[t] = INT_MAX;
  bool live = t < L, over = false;
  int r = 0, crank = 0, mine = -1, last = 0;
  uint64_t h = 0;
  RankWalk w{0, 0, 0, -1, -1};
  if (live) {
    const int4 e = __ldcg(&list[t]);
    r = e.x;
    w.off = e.y;
    w.target = e.z;
    w.k = e.w;
    h = static_cast<uint64_t>(a.hashes[r]);
    crank = a.chunk_rank[r];
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
    if (live && w.k == k) {
      w.head = -1;
      const int res = rank_step(a, w, h, crank, k);
      if (res == RK_CLAIM) {
        mine = rw_map_claim(s_keys[p], s_rows[p], w.slot % m, r);
      } else {
        rank_settle(a, r, w, res);
        if (res == RK_DONE) {
          live = false;
          last = max(last, w.k + 1);
        } else if (res == RK_OVER) {
          live = false;
          over = true;
        }
      }
    }
    // this round's word was last read two barriers ago
    if (t == 0) s_next[p] = INT_MAX;
    __syncthreads();
    // the least claimant of each scratch index wins its slot
    if (mine >= 0) {
      if (s_rows[p][mine] == r) {
        rank_win(a, w.slot, r, w.target, h);
        live = false;
        last = max(last, k + 1);
      } else {
        w.k = k + 1;  // a loser re-reads its slot next round
      }
    }
    int need = live ? w.k : INT_MAX;
    need = rw_warp_min(need);
    if ((t & 31) == 0 && need != INT_MAX) atomicMin(&s_next[p], need);
    __syncthreads();
    k = s_next[p];
    ++rounds;
  }
  rw_block_into<RW_RED_MAX>(last, &a.ctl[RW_CTL_RANK_LAST]);
  *n_over = __syncthreads_count(live || over);
  return rounds;
}

__global__ void __launch_bounds__(RANK_THREADS)
    ranked_insert(TagRankedArgs a) {
  cg::grid_group grid = cg::this_grid();
  ranked_walk(a);
  grid.sync();
  volatile int* ctl = a.ctl;
  int L = ctl[RW_CTL_LEN0];
  const int n_listed = L;
  int k = ctl[RW_CTL_K0];
  const int one_block_max = a.grid_only ? 0 : RANK_ONE_BLOCK_MAX;
  bool grid_mode = L > one_block_max;
  if (!grid_mode && blockIdx.x != 0) return;
  const int lane = threadIdx.x & 31;
  const int m = 4 * a.cap;
  const int base = blockIdx.x * blockDim.x + (threadIdx.x & ~31);
  const int stride = gridDim.x * blockDim.x;
  int j = 0;  // grid rounds run; list j & 1 is the current one
  // -- rounds over the listed rows on the whole grid ----------------------
  while (grid_mode) {
    const int cur = j & 1;
    int4* list = a.list + static_cast<long long>(cur) * a.cap;
    int4* next = a.list + static_cast<long long>(cur ^ 1) * a.cap;
    // the next list's length and this round's next-round word start over
    // (every block read them two barriers ago)
    if (blockIdx.x == 0 && threadIdx.x == 0) {
      ctl[RW_CTL_LEN0 + (cur ^ 1)] = 0;
      ctl[RW_CTL_NEXT0 + cur] = INT_MAX;
    }
    int last = 0, over = 0;
    // phase A: every row waiting at round k against the round-start table
    for (int w0 = base; w0 < L; w0 += stride) {
      const int i = w0 + lane;
      if (i >= L) continue;
      int4 e = __ldcg(&list[i]);
      int cd = -1;  // -1 stays listed, -2 resolved or over, >= 0 claims cd
      if (e.w == k) {
        const int r = e.x;
        RankWalk w{e.y, e.z, e.w, -1, -1};
        const int res = rank_step(a, w, static_cast<uint64_t>(a.hashes[r]),
                                  a.chunk_rank[r], k);
        if (res == RK_CLAIM) {
          cd = w.slot;
          atomicMin(&a.claim[w.slot % m], r);
        } else {
          rank_settle(a, r, w, res);
          if (res == RK_DONE) {
            cd = -2;
            last = max(last, w.k + 1);
          } else if (res == RK_OVER) {
            cd = -2;
            ++over;
          } else {
            e.y = w.off;
            e.z = w.target;
            e.w = w.k;
            list[i] = e;
          }
        }
      }
      a.cand[i] = cd;
    }
    grid.sync();
    // phase B: the lowest claimant of each scratch entry wins its slot and
    // frees the entry at once (a loser reads the winner's index or the free
    // mark, never its own); the rows still listed move to the next list
    int need = INT_MAX;
    for (int w0 = base; w0 < L; w0 += stride) {
      const int i = w0 + lane;
      bool keep = false;
      int4 e = make_int4(0, 0, 0, 0);
      if (i < L) {
        e = list[i];
        const int c = a.cand[i];
        if (c >= 0 && __ldcg(&a.claim[c % m]) == e.x) {
          rank_win(a, c, e.x, e.z, static_cast<uint64_t>(a.hashes[e.x]));
          a.claim[c % m] = RW_CLAIM_FREE;
          last = max(last, k + 1);
        } else if (c != -2) {
          keep = true;
          if (c >= 0) e.w = k + 1;  // a loser re-reads its slot next round
          need = min(need, e.w);
        }
      }
      rw_warp_append(keep, e, next, &a.ctl[RW_CTL_LEN0 + (cur ^ 1)]);
    }
    rw_block_min_max_sum(need, &a.ctl[RW_CTL_NEXT0 + cur], last,
                         &a.ctl[RW_CTL_RANK_LAST], over,
                         &a.ctl[RW_CTL_RANK_OVER]);
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
  int n_left = L;  // rows still listed when the rounds ran out
  int tail_rounds = 0;
  if (L > 0 && k < a.max_iters) {
    tail_rounds = ranked_tail(a, a.list + static_cast<long long>(j & 1) *
                                              a.cap, L, k, &n_left);
  }
  if (threadIdx.x != 0) return;
  const int n_over = ctl[RW_CTL_RANK_OVER] + n_left;
  const int last = ctl[RW_CTL_RANK_LAST];
  a.iters[0] = n_over > 0 ? a.max_iters : (last > 1 ? last : 1);
  ctl[RW_CTL_RANK_CLAIMANTS] = n_listed;
  ctl[RW_CTL_RANK_GRID_ROUNDS] = j;
  ctl[RW_CTL_RANK_BLOCK_ROUNDS] = tail_rounds;
  ctl[RW_CTL_LEN0] = 0;
  ctl[RW_CTL_LEN1] = 0;
  ctl[RW_CTL_NEXT0] = INT_MAX;
  ctl[RW_CTL_NEXT1] = INT_MAX;
  ctl[RW_CTL_K0] = INT_MAX;
  ctl[RW_CTL_RANK_LAST] = 0;
  ctl[RW_CTL_RANK_OVER] = 0;
}

extern "C" int rw_tag_insert_ranked(TagRankedArgs args, void* stream) {
  // one cooperative grid, every block co-resident (the most per card found
  // once): a thread a row for the walk while the card holds the chunk, and
  // at least two blocks
  static int most_of[64] = {0};
  int dev = 0;
  cudaGetDevice(&dev);
  int& most = most_of[dev & 63];
  if (most == 0) {
    int sms = 0, per_sm = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, ranked_insert,
                                                  RANK_THREADS, 0);
    if (per_sm < 1) return static_cast<int>(cudaErrorLaunchOutOfResources);
    most = sms * per_sm;
  }
  const long long need =
      (static_cast<long long>(args.cap) + RANK_THREADS - 1) / RANK_THREADS;
  int blocks = static_cast<int>(need < most ? need : most);
  if (blocks < 2) blocks = 2;
  void* params[] = {&args};
  const cudaError_t rc = cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(ranked_insert), dim3(blocks),
      dim3(RANK_THREADS), params, 0, static_cast<cudaStream_t>(stream));
  if (rc != cudaSuccess) return static_cast<int>(rc);
  return static_cast<int>(cudaGetLastError());
}
