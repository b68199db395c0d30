// Kernel B: open-addressing find-or-claim probe of a chunk (sm_90a).
//
// Replaces risingwave_tpu/state/hash_table.py `HashTable._probe`
// (hash_table.py:236), the XLA while_loop behind `lookup`,
// `lookup_counted` and `lookup_or_insert`.  Keys compare as `_keys_equal`
// (:104) does: a string key passes as its [size, w] bytes and its lens, and
// equality is every one of the w bytes, the padding past lens included,
// and equal lens (the hash masks that padding; a key's bytes are copied
// whole when it claims a slot).
//
// The slot layout must equal the reference's, so the kernel replays its
// rounds exactly.  Within a round every pending row reads `occupied`, the
// key store and `tombstone` as they were at the round's start:
//   - a key match resolves the row;
//   - an occupied non-match or a tombstone advances the row's offset;
//   - a true-empty slot is a claim (insert) or a miss (lookup).  Claimants
//     atomicMin their row index into scratch[cand % (4*cap)]; after a barrier
//     a row wins only if the scratch holds its own index.  Winners write
//     `occupied` and the key; losers do not advance and re-check next round,
//     so cross-slot scratch collisions delay rows exactly as in the reference
//     (the lowest row index wins, never the fastest thread).
// The scratch entries are reset before the next round, and the loop stops
// when no row is pending or after `max_iters` = min(size + 2, 1024) rounds
// (the reference's unrolled first round included).  Rows still pending are
// overflow; their count is summed on the device.
//
// Design: ONE block of 1024 threads, each owning rows t, t+1024, ...; the
// round phases are separated by __syncthreads() and the "any row pending"
// test is __syncthreads_or, so the host never synchronises.  Per-row state
// (offset, candidate, claim flag) lives in global scratch owned by one
// thread.
//
// Bound: bytes and latency.  The data the probe needs is the chunk's keys
// (8 B/row), its output (slot, inserted, overflow: 6 B/row) and, per row and
// round, one random read of the table (occupied, tombstone, key: ~10 B);
// at 8192 rows that is a few hundred KB, microseconds at HBM rate.  Each
// round costs three block barriers and a dependent random read, so the
// kernel runs at the latency of a few rounds on one SM; a grid-wide version
// is later work.
#include "rw_probe.cuh"

struct ProbeArgs {
  RwCols keys;                 // in = chunk key cols, st = table key store
  const int32_t* start;        // [cap] h & (size - 1)
  const uint8_t* valid;        // [cap]
  uint8_t* occupied;           // [size], updated in place on claims
  const uint8_t* tombstone;    // [size]
  int32_t* slots;              // [cap] out (size = sentinel)
  uint8_t* inserted;           // [cap] out
  uint8_t* pending;            // [cap] out: 1 = unresolved = overflow at end
  int32_t* off;                // [cap] scratch
  int32_t* cand;               // [cap] scratch
  uint8_t* want;               // [cap] scratch
  int32_t* claim;              // [4 * cap] scratch
  long long* n_over;           // [1] out: rows left pending
  int cap;
  int size;
  int insert;
  int max_iters;
};

__global__ void __launch_bounds__(1024) probe_kernel(ProbeArgs a) {
  const int T = blockDim.x;
  const int t = threadIdx.x;
  const int m = 4 * a.cap;
  const int mask = a.size - 1;
  __shared__ unsigned long long s_over;
  if (t == 0) s_over = 0;
  for (int j = t; j < m; j += T) a.claim[j] = a.cap;
  int any = 0;
  for (int r = t; r < a.cap; r += T) {
    const uint8_t p = a.valid[r] != 0;
    a.pending[r] = p;
    a.off[r] = 0;
    a.slots[r] = a.size;
    a.inserted[r] = 0;
    a.want[r] = 0;
    any |= p;
  }
  any = __syncthreads_or(any);
  for (int it = 0; any && it < a.max_iters; ++it) {
    // phase 1: evaluate every pending row against the round-start table
    for (int r = t; r < a.cap; r += T) {
      if (!a.pending[r]) continue;
      const int c = (a.start[r] + a.off[r]) & mask;
      const int s = rw_probe_step(a.keys, a.occupied, a.tombstone, c, r);
      if (s == RW_PROBE_HIT) {
        a.slots[r] = c;
        a.pending[r] = 0;
      } else if (s == RW_PROBE_EMPTY) {
        if (a.insert) {
          a.want[r] = 1;
          a.cand[r] = c;
          atomicMin(&a.claim[c % m], r);
        } else {
          a.pending[r] = 0;  // true-empty slot: the key is absent
        }
      } else {
        a.off[r] += 1;
      }
    }
    __syncthreads();
    if (a.insert) {
      // phase 2: the lowest claimant of each scratch entry wins its slot
      for (int r = t; r < a.cap; r += T) {
        if (!a.want[r]) continue;
        const int c = a.cand[r];
        if (a.claim[c % m] == r) {
          a.occupied[c] = 1;
          rw_store_row(a.keys, c, r);
          a.slots[r] = c;
          a.inserted[r] = 1;
          a.pending[r] = 0;
        }
      }
      __syncthreads();
      // phase 3: reset the scratch entries this round touched
      for (int r = t; r < a.cap; r += T) {
        if (!a.want[r]) continue;
        a.claim[a.cand[r] % m] = a.cap;
        a.want[r] = 0;
      }
    }
    int p = 0;
    for (int r = t; r < a.cap; r += T) p |= a.pending[r];
    any = __syncthreads_or(p);
  }
  unsigned long long cnt = 0;
  for (int r = t; r < a.cap; r += T) cnt += a.pending[r];
  if (cnt) atomicAdd(&s_over, cnt);
  __syncthreads();
  if (t == 0) a.n_over[0] = static_cast<long long>(s_over);
}

extern "C" int rw_probe(ProbeArgs args, void* stream) {
  probe_kernel<<<1, 1024, 0, static_cast<cudaStream_t>(stream)>>>(args);
  return static_cast<int>(cudaGetLastError());
}
