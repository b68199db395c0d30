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
// wins after a barrier, and losers re-check the same slot next round.  The
// loop stops when no row is pending or after the reference's round bound
// (the unrolled first round counted); rows still pending are overflow.
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
//   rw_tag_insert_ranked  `lookup_or_insert_ranked` for a chunk of rows: one
//                         1024-thread block, round phases separated by
//                         __syncthreads, bound min(2 * size + 4, 1024).
//                         Phase 1 resolves the key's head (hash, 0) and reads
//                         the pre-chunk degree there; the row then switches
//                         its target to (hash, degree + chunk_rank) and
//                         finds or claims it (phase 2).
//
// Bound: the work is a few dependent random 8-byte reads per row per
// round, so the kernels are latency-bound; by bytes, a chunk of 8192 rows
// moves well under 1 MB and the 2^22-slot rehash ~32 MB of tags read,
// written and scanned, tens of microseconds at HBM rate.
#include <cooperative_groups.h>

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
  int* off;                  // [cap] scratch
  int* cand;                 // [cap] scratch
  uint8_t* phase2;           // [cap] scratch
  uint8_t* want;             // [cap] scratch
  long long* target_tag;     // [cap] scratch
  int* claim;                // [4 * cap] scratch
  int cap;
  int size;
  int max_iters;
};

__global__ void __launch_bounds__(1024) tag_ranked_kernel(TagRankedArgs a) {
  const int T = blockDim.x;
  const int t = threadIdx.x;
  const int m = 4 * a.cap;
  const int mask = a.size - 1;
  for (int j = t; j < m; j += T) a.claim[j] = a.cap;
  int any = 0;
  for (int r = t; r < a.cap; r += T) {
    const uint8_t p = a.valid[r] != 0;
    a.pending[r] = p;
    a.off[r] = 0;
    a.slots[r] = a.size;
    a.head_slot[r] = a.size;
    a.target[r] = 0;
    a.inserted[r] = 0;
    a.existed[r] = 0;
    a.phase2[r] = 0;
    a.want[r] = 0;
    a.target_tag[r] = static_cast<long long>(
        rw_pair_tag(static_cast<uint64_t>(a.hashes[r]), 0));
    any |= p;
  }
  any = __syncthreads_or(any);
  int it = 0;
  do {
    // phase A: every pending row against the round-start table
    for (int r = t; r < a.cap; r += T) {
      if (!a.pending[r]) continue;
      const uint64_t tt = static_cast<uint64_t>(a.target_tag[r]);
      const int c =
          (static_cast<int>(tt & static_cast<uint64_t>(mask)) + a.off[r]) &
          mask;
      const uint64_t tv = static_cast<uint64_t>(a.tags[c]);
      const bool tomb = tv == RW_TOMB_TAG;
      const bool empty = tv == RW_EMPTY_TAG;
      const bool match = tv == tt;
      const int crank = a.chunk_rank[r];
      if (!a.phase2[r]) {
        // phase 1: resolve the head (hash, 0)
        if (match) {
          const int nr = a.degree[c] + crank;
          a.head_slot[r] = c;
          if (nr == 0) {  // the target IS the head, already present
            a.slots[r] = c;
            a.existed[r] = 1;
            a.pending[r] = 0;
          } else {
            a.phase2[r] = 1;
            a.target[r] = nr;
            a.target_tag[r] = static_cast<long long>(
                rw_pair_tag(static_cast<uint64_t>(a.hashes[r]), nr));
            a.off[r] = 0;
          }
          continue;
        }
        if (empty && crank > 0) {  // key absent: degree 0
          a.phase2[r] = 1;
          a.target[r] = crank;
          a.target_tag[r] = static_cast<long long>(
              rw_pair_tag(static_cast<uint64_t>(a.hashes[r]), crank));
          a.off[r] = 0;
          continue;
        }
      } else if (match) {
        // phase 2: the target entry exists (stranded by an overflow)
        a.slots[r] = c;
        a.existed[r] = 1;
        a.pending[r] = 0;
        continue;
      }
      if (empty) {  // phase-2 rows and the rank-0 row claim
        a.want[r] = 1;
        a.cand[r] = c;
        atomicMin(&a.claim[c % m], r);
      } else {
        a.off[r] += 1;  // another tag or a tombstone
      }
      (void)tomb;
    }
    __syncthreads();
    // phase B: the lowest claimant of each scratch entry wins its slot
    for (int r = t; r < a.cap; r += T) {
      if (!a.want[r]) continue;
      const int c = a.cand[r];
      if (a.claim[c % m] == r) {
        a.tags[c] = a.target_tag[r];
        a.slots[r] = c;
        if (a.target[r] == 0) a.head_slot[r] = c;
        a.inserted[r] = 1;
        a.pending[r] = 0;
      }
    }
    __syncthreads();
    // phase C: reset the touched scratch entries
    int p = 0;
    for (int r = t; r < a.cap; r += T) {
      if (a.want[r]) {
        a.claim[a.cand[r] % m] = a.cap;
        a.want[r] = 0;
      }
      p |= a.pending[r];
    }
    any = __syncthreads_or(p);
    ++it;
  } while (any && it < a.max_iters);
  if (t == 0) a.iters[0] = it;
  for (int r = t; r < a.cap; r += T) {
    a.existed[r] = a.existed[r] && a.valid[r];
  }
}

extern "C" int rw_tag_insert_ranked(TagRankedArgs args, void* stream) {
  if (args.cap > 0) {
    tag_ranked_kernel<<<1, 1024, 0, static_cast<cudaStream_t>(stream)>>>(
        args);
  }
  return static_cast<int>(cudaGetLastError());
}
