// Kernel K6d: the DISTINCT dedup of the hash aggregation (sm_90a).
//
// Replaces the dedup pass of risingwave_tpu/stream/hash_agg.py
// `HashAggExecutor.apply` (hash_agg.py:501-580): per DISTINCT call the
// aggregation keeps a dedup table keyed (group keys..., argument) with an
// int64 row count per key, and only a key's 0 <-> nonzero transitions reach
// the aggregate, as a +1/-1 "transition sign" at one representative row per
// key.  Before it: K1 and K3 find or claim each eligible row's dedup slot
// (`lookup_or_insert` on key_cols + [arg]), and K13's rank launch (after a
// stable sort) ranks the eligible, non-overflowed rows among rows of equal
// slot: rank 0 is the key's representative.  After it the K4 sweep
// tombstones the dead keys.
//
// Four launches, one thread per row, in this order:
//   reset     a slot claimed by this chunk (`inserted`) may be a reclaimed
//             tombstone with a stale count: its count becomes 0;
//   read n0   every eligible row reads its key's count BEFORE any of the
//             chunk's contributions land (read only), and the rows that
//             overflowed the dedup table add to the overflow counter;
//   add       every eligible row adds its sign to its key's count (int64
//             atomics: exact, so the order does not matter);
//   finish    every eligible row reads n1, its key's count after the chunk
//             (= n0 + the key's net delta), counts n1 < 0 into the
//             inconsistency counter (deletes of values never inserted), and
//             the representative writes the transition sign (n1 > 0) -
//             (n0 > 0) and flags its key dead when the count retracted from
//             positive to <= 0.
// Splitting the reads of n0 and n1 from the writes into separate launches
// is what makes n0 the pre-chunk count for every row.
//
// Bound: bytes.  A row reads its slot, flags, rank and sign (~11 B) and
// its key's count twice, adds to it once, and writes its sign and dead
// flag (9 B): ~50 B a row, 0.4 MB for an 8192-row chunk.
#include <cstdint>
#include <cuda_runtime.h>

struct AggDistinctArgs {
  const int* slots;          // [cap] dedup slots (size: none)
  const uint8_t* inserted;   // [cap] K3 claimed the slot
  const uint8_t* eligible;   // [cap] valid, signed, not spilled, not NULL,
                             //       passing FILTER (before overflow)
  const uint8_t* over;       // [cap] K3 overflow
  const int* rank;           // [cap] rank among eligible rows of its slot
  const int* signs;          // [cap] +1 / -1 / 0
  long long* cnt;            // [size] per-key row counts, in place
  long long* n0;             // [cap] scratch
  long long* d_sign;         // [cap] out: transition sign (rep rows)
  uint8_t* dead;             // [cap] out: the rep row's key died
  long long* overflow;       // [1] the agg's overflow counter (+=)
  long long* inconsistency;  // [1] the agg's inconsistency counter (+=)
  int cap;
  int size;
};

__device__ __forceinline__ long long row_index() {
  return blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
}

__device__ __forceinline__ bool live(const AggDistinctArgs& a, long long r) {
  return a.eligible[r] && !a.over[r] && a.slots[r] >= 0 &&
         a.slots[r] < a.size;
}

__global__ void distinct_reset_kernel(AggDistinctArgs a) {
  const long long r = row_index();
  if (r >= a.cap) return;
  const int s = a.slots[r];
  if (a.inserted[r] && s >= 0 && s < a.size) a.cnt[s] = 0;
}

__global__ void distinct_read_kernel(AggDistinctArgs a) {
  const long long r = row_index();
  if (r >= a.cap) return;
  if (live(a, r)) a.n0[r] = a.cnt[a.slots[r]];
  if (a.eligible[r] && a.over[r]) {
    atomicAdd(reinterpret_cast<unsigned long long*>(a.overflow), 1ull);
  }
}

__global__ void distinct_add_kernel(AggDistinctArgs a) {
  const long long r = row_index();
  if (r >= a.cap || !live(a, r)) return;
  // two's complement: adding the sign's bit pattern adds the sign
  atomicAdd(reinterpret_cast<unsigned long long*>(a.cnt + a.slots[r]),
            static_cast<unsigned long long>(
                static_cast<long long>(a.signs[r])));
}

__global__ void distinct_finish_kernel(AggDistinctArgs a) {
  const long long r = row_index();
  if (r >= a.cap) return;
  long long sign = 0;
  uint8_t died = 0;
  if (live(a, r)) {
    const long long n0 = a.n0[r];
    const long long n1 = a.cnt[a.slots[r]];
    if (n1 < 0) {
      atomicAdd(reinterpret_cast<unsigned long long*>(a.inconsistency),
                1ull);
    }
    if (a.rank[r] == 0) {
      sign = static_cast<long long>(n1 > 0) - static_cast<long long>(n0 > 0);
      died = (n1 <= 0 && n0 > 0) ? 1 : 0;
    }
  }
  a.d_sign[r] = sign;
  a.dead[r] = died;
}

extern "C" int rw_agg_distinct(AggDistinctArgs args, void* stream) {
  if (args.cap > 0) {
    const int threads = 256;
    const unsigned blocks = static_cast<unsigned>(
        (static_cast<long long>(args.cap) + threads - 1) / threads);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    distinct_reset_kernel<<<blocks, threads, 0, s>>>(args);
    distinct_read_kernel<<<blocks, threads, 0, s>>>(args);
    distinct_add_kernel<<<blocks, threads, 0, s>>>(args);
    distinct_finish_kernel<<<blocks, threads, 0, s>>>(args);
  }
  return static_cast<int>(cudaGetLastError());
}
